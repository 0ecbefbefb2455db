"""The port's time-sharded smoothers (``pyvbmp_tpu_torch.parallel.seq_parallel``)
on D = 1, 2, 3 and 4 gloo ranks on the CPU and on a 2 x 2 (seq x data)
mesh, in float64, against the JAX package's on a mesh of the same size
(``jax.devices()[:D]``: the conftest gives 8 virtual devices) and against the
port's single-process smoothers.

Each world size is one spawn (``test_torch_mesh_ranks.start``; the four
start together from one module fixture) running every check of that size,
while the JAX side and the port's single-process references are computed
here, in the test process.
Tolerances: max relative deviation 1e-8 against JAX, 1e-10 against the
single process, per output.

- the three functions (forward-backward, its driven form, the Kalman
  smoother in the lane (h = 2) and plane (h = 5) forms) at an uneven T = 37,
  with masked transitions, ptemp as a float and as a 0-d tensor; T = 3 on 4
  ranks (a rank with no rows); on the 2 x 2 mesh with the batch split too;
- HMM, dHMM, LDS, MixLDS and DMBD fitted with ``time_mesh`` at the JAX
  tests' sizes (``tests/test_seq_parallel.py``), against the JAX models
  with ``time_mesh`` on 4 devices (DMBD also on the 2 x 2 mesh), and at
  every world size against the port's single-process fit;
- their sweeps chunk-local (each rank runs the sweep on its rows of T), at
  those sizes, at T = 3 and on the 2 x 2 mesh: every parameter node's state
  against the JAX fit and the single process, each rank's per-time state
  its rows of the single process's, ``gather_posterior`` the whole
  posterior, nothing gathered in a sweep and a sweep's collectives the
  same at T = 20 and 40; ``ELBO()`` after the fit on every rank, the state
  exporters' refusal of a chunk, one more sweep from the exported whole
  state, and whole state after an E-step outside ``update``;
- an observation node that sums without ``batch_sum`` raising in a sweep
  that splits the samples, and the count nodes' sums going through it;
- ``batch_axis="auto"``'s warning where the batch does not divide the data
  axis, and a named axis's ``ValueError``;
- the elements that the ``"scan"``, ``"halo"`` and ``"reduce"`` collectives
  move, equal at T = 40 and T = 80."""
import copy
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import test_torch_mesh_ranks as ranks
from pyvbmp_tpu.dists import NormalInverseWishart as JNIW
from pyvbmp_tpu.models import HMM as JHMM
from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.models import LinearDynamicalSystems as JLDS
from pyvbmp_tpu.models import MixtureofLinearDynamicalSystems as JMixLDS
from pyvbmp_tpu.models import dHMM as JdHMM
from pyvbmp_tpu.parallel import seq_parallel as jsp
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.ops.parallel_hmm import (
    driven_forward_backward_parallel,
    forward_backward_parallel,
)
from pyvbmp_tpu_torch.ops.parallel_kalman import parallel_kalman_smoother
from pyvbmp_tpu_torch.utils import convert

TOL_JAX, TOL_SELF = 1e-8, 1e-10
T_LEN, B, K = 37, 4, 4
DMBD_CFG = dict(obs_shape=(4, 2), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1))


def leaves(x):
    if isinstance(x, (tuple, list)):
        return [y for v in x for y in leaves(v)]
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)]


def rel_dev(out, ref):
    out, ref = leaves(out), leaves(ref)
    assert [o.shape for o in out] == [r.shape for r in ref]
    return max(np.abs(o - r).max() / max(np.abs(r).max(), 1e-300) for o, r in zip(out, ref))


def jmesh(D, two_d=False):
    devs = np.asarray(jax.devices()[:D])
    return JMesh(devs.reshape(2, 2), ("seq", "data")) if two_d else JMesh(devs, ("seq",))


# -- inputs --------------------------------------------------------------------------
def hmm_inputs(T, driven=False, seed=0, b=B):
    """Log transitions (masked: 0 -> 2 impossible), initial and observation
    logits (T, b, K)."""
    rs = np.random.RandomState(seed)
    tr = rs.dirichlet(np.ones(K), (T, b, K) if driven else K)
    tr[..., 0, 2] = 0.0
    tr = tr / tr.sum(-1, keepdims=True)
    with np.errstate(divide="ignore"):  # log 0 = -inf: the masked transition
        trans = np.log(tr)
    return dict(trans=trans, init=np.log(rs.dirichlet(np.ones(K))), obs=rs.randn(T, b, K))


def lds_case(h, T, seed=0):
    """A JAX LDS (scan smoother, corrected cross-covariances) as a state,
    and data (T, 4, 3)."""
    with jax.enable_x64(True):
        rng.seed(seed)
        jl = JLDS((3,), h, 0, 0, parallel_scan=True, cross_cov_compat=False)
        state = convert.lds_state(jl)
    y = np.random.RandomState(seed + 1).randn(T, 4, 3)
    return jl, state, y


def jax_fb(inp, mesh, ptemp=1.0, driven=False):
    fn = jsp.time_sharded_driven_forward_backward if driven else jsp.time_sharded_forward_backward
    with jax.enable_x64(True):
        out = fn(*(jnp.asarray(inp[k]) for k in ("trans", "init", "obs")), mesh, ptemp=ptemp)
        return [np.asarray(x) for x in out]


def port_fb(inp, ptemp=1.0, driven=False):
    fn = driven_forward_backward_parallel if driven else forward_backward_parallel
    return fn(*(torch.tensor(inp[k]) for k in ("trans", "init", "obs")), ptemp=ptemp)


def jax_kalman(jl, y, mesh):
    with jax.enable_x64(True):
        yv, uv, rv = jl.reshape_inputs(jnp.asarray(y))
        parms = jl._latent_parms(jl.A)
        like = jl.log_likelihood_function(jl.obs_model, yv, rv)
        return jax.tree_util.tree_map(np.asarray, jsp.time_sharded_kalman_smoother(
            parms, jl.x0, like, uv, mesh))


def port_kalman(state, y):
    lds = convert.lds_from_state(state, device="cpu", dtype=torch.float64)
    yv, uv, rv = lds.reshape_inputs(torch.tensor(y))
    like = lds.log_likelihood_function(lds.obs_model, yv, rv)
    return parallel_kalman_smoother(lds._latent_parms(lds.A), lds.x0, like, uv)


# -- the models at the JAX tests' sizes (tests/test_seq_parallel.py) ------------------
def model_data(kind, T, b=None):
    """The data a model is fitted to, T time steps long (``b`` sequences)."""
    if kind == "hmm":
        return (np.random.RandomState(8).randn(T, b or 6, 3),)
    if kind == "dhmm":
        rs = np.random.RandomState(4)
        b, k, pdim, d = b or 5, 3, 2, 2
        U = rs.randn(T, b, pdim)
        Y = rs.randn(k, d)[rs.randint(0, k, (T, b))] * 3 + 0.2 * rs.randn(T, b, d)
        return U, Y
    seed, shape = {"lds": (6, (4, 3)), "mixlds": (9, (8, 3)), "dmbd": (10, (4, 4, 2))}[kind]
    return (np.random.RandomState(seed).randn(T, *shape),)


BUILD = {
    "hmm": lambda m: JHMM(JNIW.create((3,), batch_shape=(4,)), time_mesh=m),
    "dhmm": lambda m: JdHMM(JNIW.create((2,), batch_shape=(3,)), 2, time_mesh=m),
    "lds": lambda m: JLDS((3,), 2, 0, 0, cross_cov_compat=False, time_mesh=m),
    "mixlds": lambda m: JMixLDS(2, (3,), 2, 0, 0, time_mesh=m),
    "dmbd": lambda m: JDMBD(**DMBD_CFG, time_mesh=m),
}
SEEDS = {"hmm": 21, "dhmm": 31, "lds": 11, "mixlds": 23, "dmbd": 29}
SWEEPS = {"hmm": 3, "dhmm": 2, "lds": 3, "mixlds": 2, "dmbd": 2}
T_MODEL = {"hmm": 32, "dhmm": 16, "lds": 24, "mixlds": 24, "dmbd": 16}
T_SHORT = 3  # T < D on 4 ranks: the last rank holds no rows
WHOLE_ESTEP = ("hmm", "lds", "dhmm")  # the models with an E-step outside update


def model_cases():
    """name -> (kind, JAX model builder (mesh), data, sweeps, seed): each
    model at the JAX tests' sizes (``tests/test_seq_parallel.py``), at
    T = 3, and on the 2 x 2 mesh (its name ends with 2x2; the dHMM with 6
    sequences there, which the data axis divides)."""
    out = {}
    for kind in BUILD:
        case = (kind, BUILD[kind])
        out[kind] = case + (model_data(kind, T_MODEL[kind]), SWEEPS[kind], SEEDS[kind])
        out[f"{kind}_T3"] = case + (model_data(kind, T_SHORT), SWEEPS[kind], SEEDS[kind])
        T2 = 13 if kind == "dmbd" else T_MODEL[kind]
        b2 = 6 if kind == "dhmm" else None
        out[f"{kind}_2x2"] = case + (model_data(kind, T2, b2), SWEEPS[kind], SEEDS[kind])
    return out


MODELS = model_cases()
# the fits that test_models_with_time_mesh_match_jax_and_the_single_process
# holds: each model at its JAX test's size, and DMBD on the 2 x 2 mesh
FIT_MODELS = ("hmm", "dhmm", "lds", "mixlds", "dmbd", "dmbd_2x2")


def once(fn):
    """``fn`` cached by argument, each value computed once even when threads
    ask for it together (the references run in a thread pool)."""
    cache, locks, guard = {}, {}, threading.Lock()

    @functools.wraps(fn)
    def wrapper(name):
        with guard:
            lock = locks.setdefault(name, threading.Lock())
        with lock:
            if name not in cache:
                cache[name] = fn(name)
            return cache[name]
    return wrapper


@once
def jax_model(name):
    """(the JAX model with time_mesh on 4 devices (2 x 2 for a 2x2 case),
    its state before the fit), built once."""
    kind, build, _, _, seed = MODELS[name]
    with jax.enable_x64(True):
        rng.seed(seed)
        jm = build(jmesh(4, two_d=name.endswith("2x2")))
        return jm, getattr(convert, f"{kind}_state")(jm)


def jax_state(name):
    return jax_model(name)[1]


@once
def jax_result(name):
    """The JAX fit's ELBOs and parameter nodes' states (once per model)."""
    kind, _, data, sweeps, _ = MODELS[name]
    jm = jax_model(name)[0]
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in data]
        if kind == "dhmm":
            jm.raw_update(*args, iters=sweeps)
        else:
            jm.update(*args, iters=sweeps)
        return {"elbo": np.asarray(jm.ELBO_save), "params": ranks._params(kind, jm)}


def jax_fit(name):
    """The JAX fit's ELBOs."""
    return jax_result(name)["elbo"]


@once
def single_model(name):
    """The port's single-process fit with the scan smoothers, from the
    state the JAX fit starts from: (ELBOs, parameter nodes' states, the
    per-time state its ``CHUNK_STATE`` names)."""
    kind, _, data, sweeps, _ = MODELS[name]
    m = single_start(name)
    ranks._fit(m, kind, data, sweeps)
    # one more sweep from the exported state, as the ranks resume
    resumed = getattr(convert, f"{kind}_from_state")(
        getattr(convert, f"{kind}_state")(m), device="cpu", dtype=torch.float64)
    ranks._fit(resumed, kind, data, 1)
    return {"elbo": np.asarray(m.ELBO_save), "params": ranks._params(kind, m),
            "elbo_now": ranks._elbo_now(m),
            "state": ranks._np(ranks._chunk_state(m)),
            "kinds": {path.split(".")[-1]: k for path, k in m.CHUNK_STATE.items()},
            "resumed": {"elbo": resumed.ELBO_save[-1],
                        "params": ranks._params(kind, resumed)}}


def single_start(name):
    """The port's single-process model with the scan smoothers, from the
    state the JAX fit starts from."""
    kind = MODELS[name][0]
    state = copy.deepcopy(jax_state(name))
    state["config"]["parallel_scan"] = True
    return getattr(convert, f"{kind}_from_state")(state, device="cpu", dtype=torch.float64)


def single_whole_estep(name):
    """The single process's per-time state after its fit and
    ``whole_estep``."""
    kind, _, data, sweeps, _ = MODELS[name]
    m = single_start(name)
    ranks._fit(m, kind, data, sweeps)
    ranks.whole_estep(m, kind, data)
    return ranks._np(ranks._chunk_state(m))


def single_fit(name):
    return single_model(name)["elbo"]


# -- one spawn per world size, all four started at once --------------------------------
WORLDS = (1, 2, 3, 4)


def world_cases(D):
    """name -> (job, references): the jobs of a world of D ranks, and
    thunks giving what each is held to, [(reference, tolerance)...]."""
    cases = {}
    meshes = [("seq", lambda: jmesh(D))]
    if D == 4:
        meshes.append(("seq_data", lambda: jmesh(4, two_d=True)))
    for mname, jm in meshes:
        for driven in (False, True):
            inp = hmm_inputs(T_LEN, driven, seed=D)
            for ptemp, as_tensor in ((1.0, False), (3.0, True)):
                cases[f"fb {mname} driven={driven} ptemp={ptemp}"] = (
                    ("fb", dict(mesh=mname, **inp, ptemp=ptemp, driven=driven,
                                ptemp_tensor=as_tensor)),
                    lambda inp=inp, jm=jm, ptemp=ptemp, driven=driven: [
                        (jax_fb(inp, jm(), ptemp, driven), TOL_JAX),
                        (port_fb(inp, ptemp, driven), TOL_SELF)])
        # the lane form (h = 2) against JAX, whose sharded smoother is dense
        # at every h; the plane form (h = 5) against the single process
        for h in (2, 5):
            jl, state, y = lds_case(h, T_LEN, seed=D + h)
            cases[f"kalman {mname} h={h}"] = (
                ("kalman", dict(mesh=mname, state=state, y=y)),
                lambda jl=jl, state=state, y=y, h=h, jm=jm: (
                    [(jax_kalman(jl, y, jm()), TOL_JAX)] if h == 2 else [])
                + [(port_kalman(state, y), TOL_SELF)])
    if D == 4:  # T < D: the last rank holds no rows
        for driven in (False, True):
            inp = hmm_inputs(3, driven, seed=7)
            cases[f"fb T=3 driven={driven}"] = (
                ("fb", dict(mesh="seq", **inp, driven=driven)),
                lambda inp=inp, driven=driven: [
                    (jax_fb(inp, jmesh(4), driven=driven), TOL_JAX),
                    (port_fb(inp, driven=driven), TOL_SELF)])
        jl, state, y = lds_case(2, 3, seed=3)
        cases["kalman T=3"] = (
            ("kalman", dict(mesh="seq", state=state, y=y)),
            lambda jl=jl, state=state, y=y: [(jax_kalman(jl, y, jmesh(4)), TOL_JAX),
                                              (port_kalman(state, y), TOL_SELF)])
    # the public scan and shifts on a bare combine, T < D included
    for T in ((T_LEN, 3) if D == 4 else (T_LEN,)):
        cases[f"scan and shifts T={T}"] = (
            ("scan_and_shifts", dict(x=np.random.RandomState(T).randn(T, 2))), lambda: [])
    # the models: against JAX on 4 devices, against the single process
    # always; their chunk-local state and gathered posteriors too
    for name, (kind, _, data, sweeps, _) in MODELS.items():
        if name.endswith("2x2") and D != 4:
            continue
        job = ("chunk_fit", dict(kind=kind, state=jax_state(name), data=data, sweeps=sweeps,
                                 mesh="seq_data" if name.endswith("2x2") else "seq"))
        if name in FIT_MODELS:
            cases[f"fit {name}"] = (
                job, lambda name=name: ([(jax_fit(name), TOL_JAX)] if D == 4 else [])
                + [(single_fit(name), TOL_SELF)])
        cases[f"chunk {name}"] = (job, lambda name=name: [jax_result(name),
                                                          single_model(name)])
    # an E-step outside update after a time-sharded fit
    for kind in WHOLE_ESTEP:
        _, _, data, sweeps, _ = MODELS[kind]
        cases[f"whole estep {kind}"] = (
            ("whole_estep", dict(kind=kind, state=jax_state(kind), data=data, sweeps=sweeps)),
            lambda kind=kind: [single_whole_estep(kind)])
    # a sweep's collectives at T and at 2 T (uneven on 3 ranks)
    if D > 1:
        for kind in BUILD:
            for T in (20, 40):
                cases[f"count {kind} T={T}"] = (
                    ("chunk_fit", dict(kind=kind, state=jax_state(kind),
                                       data=model_data(kind, T), sweeps=1)), lambda: [])
    # the collectives' elements at T = 40 and 80
    if D > 1:
        for T in (40, 80):
            for driven in (False, True):
                cases[f"count fb T={T} driven={driven}"] = (
                    ("fb", dict(mesh="seq", **hmm_inputs(T, driven), driven=driven)),
                    lambda: [])
            _, state, y = lds_case(5, T)
            cases[f"count kalman T={T}"] = (
                ("kalman", dict(mesh="seq", state=state, y=y)), lambda: [])
    if D == 4:  # batch 3 on the 2 x 2 mesh
        inp = hmm_inputs(16, b=3)
        cases["auto falls back"] = (("fb", dict(mesh="seq_data", **inp)),
                                    lambda: [(port_fb(inp), TOL_SELF)])
        cases["named raises"] = (("fb", dict(mesh="seq_data", **inp, batch_axis="data")),
                                 lambda: [])
    return cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """D -> (D, references, each rank's results): the four worlds run
    while this process computes the references."""
    cases = {D: world_cases(D) for D in WORLDS}
    started = {D: ranks.start(D, tmp_path_factory.mktemp(f"world{D}"),
                              {k: job for k, (job, _) in cases[D].items()})
               for D in WORLDS}
    # the references compile JAX programs: several at once
    with ThreadPoolExecutor(4) as pool:
        refs = {D: {k: pool.submit(ref) for k, (_, ref) in cases[D].items()} for D in WORLDS}
        refs = {D: {k: f.result() for k, f in r.items()} for D, r in refs.items()}
    out = {}
    for D in WORLDS:
        results = ranks.join(started[D])
        for r in results:
            for key, res in r.items():
                assert "traceback" not in res, (key, res["traceback"])
        out[D] = D, refs[D], results
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda d: f"D={d}")
def world(request, worlds):
    return worlds[request.param]


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4]


def outputs(res):
    return res["out"] if "out" in res else res["elbo"]


def test_every_rank_gets_the_same_whole_outputs(world):
    D, _, results = world
    for key, res in results[0].items():
        for other in results[1:]:
            if "out" in res or "elbo" in res:
                assert rel_dev(outputs(other[key]), outputs(res)) == 0.0, key


@pytest.mark.parametrize("what", ["fb", "kalman"])
def test_time_sharded_functions_match_jax_and_the_single_process(world, what):
    D, refs, results = world
    keys = [k for k in refs if k.startswith(what)]
    assert keys
    for key in keys:
        for ref, tol in refs[key]:
            dev = rel_dev(outputs(results[0][key]), ref)
            assert dev <= tol, (key, dev, tol)


def test_models_with_time_mesh_match_jax_and_the_single_process(world):
    D, refs, results = world
    keys = [k for k in refs if k.startswith("fit")]
    assert len(keys) == len(FIT_MODELS) - (D != 4)
    for key in keys:
        assert len(refs[key]) == (2 if D == 4 else 1)
        for ref, tol in refs[key]:
            out = results[0][key]["elbo"]
            dev = np.abs(out - ref).max() / np.abs(ref).max()
            assert dev <= tol, (key, out, ref)


def test_public_scan_and_shifts_on_uneven_chunks(world):
    """``sharded_associative_scan`` with a bare combine and the two halo
    shifts, each rank's rows stacked in rank order, against numpy."""
    D, _, results = world
    for key in [k for k in results[0] if k.startswith("scan and shifts")]:
        x = np.random.RandomState(int(key.split("=")[1])).randn(int(key.split("=")[1]), 2)
        got = {k: np.concatenate([r[key][k] for r in results]) for k in
               ("prefix", "suffix", "up", "down")}
        np.testing.assert_allclose(got["prefix"], np.cumsum(x, 0), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got["suffix"], np.cumsum(x[::-1], 0)[::-1], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(got["up"], np.concatenate([x[1:], np.full((1, 2), 7.0)]))
        np.testing.assert_array_equal(got["down"],
                                      np.concatenate([np.full((1, 2), -1.0), x[:-1]]))


def test_collective_elements_do_not_grow_with_T(world):
    D, _, results = world
    if D == 1:  # one rank makes no collective
        assert all(v == 0 for res in results[0].values() for v in res["counts"].values())
        return
    r = results[0]
    for what in ("fb", "kalman"):
        for suffix in ((" driven=False", " driven=True") if what == "fb" else ("",)):
            c40 = r[f"count {what} T=40{suffix}"]["counts"]
            c80 = r[f"count {what} T=80{suffix}"]["counts"]
            for tag in ("scan", "halo", "reduce"):
                assert c40[tag] == c80[tag] > 0, (what, suffix, tag, c40, c80)
            assert c80["gather"] > c40["gather"] > 0


# -- the chunk-local sweeps (each model's update with time_mesh) ----------------------
def chunk_keys(refs):
    keys = [k for k in refs if k.startswith("chunk ")]
    assert keys
    return keys


def test_chunk_local_fits_match_jax_and_the_single_process_in_every_parameter(world):
    """(i): the ELBOs and every parameter node's state (natural
    parameters and all they carry) against the JAX package's time_mesh fit
    and the single process, on every rank: a chain-end statistic counted
    on every rank of the time axis shows here."""
    D, refs, results = world
    for key in chunk_keys(refs):
        jax_ref, single = refs[key]
        for r in results:
            res = r[key]
            for ref, tol in ((jax_ref, TOL_JAX), (single, TOL_SELF)):
                dev = np.abs(res["elbo"] - ref["elbo"]).max() / np.abs(ref["elbo"]).max()
                assert dev <= tol, (key, "elbo", res["elbo"], ref["elbo"])
                for path, got, want in ranks.state_pairs(res["params"], ref["params"]):
                    dev = ranks.leaf_dev(got, want)
                    assert dev <= tol, (key, path, dev, tol)


def rank_block(res, x, time):
    """The rows and batch block of a whole state ``x`` that ``res``'s rank
    holds (``time``: time-leading, the batch on axis 1; else one value a
    sequence, the batch on axis 0)."""
    if time:
        x = x[res["bounds"][0]: res["bounds"][1]]
    if res["batch_axis"] is not None:
        dim = 1 if time else 0
        blocks = np.array_split(x, res["batch_parts"], axis=dim)
        x = blocks[res["batch_coord"]]
    return x


def test_each_rank_keeps_its_rows_of_the_single_process_state(world):
    """(ii): each rank's per-time state (px, p, the dHMM's SEzz) is rows
    [start, end) of the single process's (and its block of the batch on the
    2 x 2 mesh); per-sequence state (LDS's and DMBD's logZ, MixLDS's p and
    logZ), whole over time, its block."""
    D, refs, results = world
    for key in chunk_keys(refs):
        single = refs[key][1]
        for r in results:
            res = r[key]
            for name, kind in single["kinds"].items():
                want = single["state"][name]
                got = res["local"][name]
                for path, g, w in ranks.state_pairs(got, want):
                    w = rank_block(res, w, kind == "time")
                    assert ranks.leaf_dev(g, w) <= TOL_SELF, (key, name, path)


def test_gather_posterior_rebuilds_the_whole_posterior(world):
    """(iii): ``gather_posterior`` gives every rank the whole per-time
    state: the single process's within 1e-10, and where only time is cut
    the ranks' chunks side by side, exactly."""
    D, refs, results = world
    for key in chunk_keys(refs):
        single = refs[key][1]
        for r in results:
            whole = r[key]["whole"]
            assert sorted(whole) == sorted(single["kinds"]), key
            for name, kind in single["kinds"].items():
                for path, g, w in ranks.state_pairs(whole[name], single["state"][name]):
                    assert ranks.leaf_dev(g, w) <= TOL_SELF, (key, name, path)
                if kind != "time" or r[key]["batch_axis"] is not None:
                    continue
                chunks = [dict((p, g) for p, g, _ in ranks.state_pairs(rr[key]["local"][name],
                                                               rr[key]["local"][name]))
                          for rr in results]
                for path, g, _ in ranks.state_pairs(whole[name], whole[name]):
                    np.testing.assert_array_equal(
                        g, np.concatenate([c[path] for c in chunks]), err_msg=f"{key} {path}")


def test_a_chunk_local_sweep_gathers_nothing_and_its_reductions_do_not_grow_with_T(world):
    """(iv): nothing tagged "gather" during a sweep (``gather_posterior``
    after it is what gathers), and the elements of the scans, halos and
    reductions of one sweep the same at T = 20 and T = 40."""
    D, refs, results = world
    for r in results:
        for key, res in r.items():
            if "sweep_counts" in res:
                assert res["sweep_counts"]["gather"] == 0, (key, res["sweep_counts"])
    if D == 1:
        return
    for kind in BUILD:
        for r in results:
            c20 = r[f"count {kind} T=20"]["sweep_counts"]
            c40 = r[f"count {kind} T=40"]["sweep_counts"]
            for tag in ("scan", "halo", "reduce"):
                assert c20[tag] == c40[tag] > 0, (kind, tag, c20, c40)


def test_elbo_method_holds_on_every_rank_after_a_chunk_local_fit(world):
    """``ELBO()`` after a time-sharded update (each sequence's logZ
    completed over time when it ends) is the single process's on every
    rank, where the batch is not split (on the 2 x 2 mesh an LDS's logZ is
    this rank's block of sequences, which (ii) holds)."""
    D, refs, results = world
    checked = 0
    for key in chunk_keys(refs):
        single = refs[key][1]
        for r in results:
            res = r[key]
            if res["elbo_now"] is None or res["batch_axis"] is not None:
                continue
            assert ranks.leaf_dev(np.asarray(res["elbo_now"]), np.asarray(single["elbo_now"])) \
                <= TOL_SELF, (key, res["elbo_now"], single["elbo_now"])
            checked += 1
    assert checked >= 4 * D


def test_exporters_refuse_a_chunk_and_a_resumed_model_matches_the_single_process(world):
    """The state exporter refuses a model holding its chunk; after
    ``gather_posterior`` it exports the whole state, and a model built from
    it with the mesh (its whole px cut to the rank's rows when the sweep
    starts) runs one more sweep as the single process does from its own
    exported state: the ELBO and every parameter node within 1e-10."""
    D, refs, results = world
    for key in chunk_keys(refs):
        single = refs[key][1]["resumed"]
        for r in results:
            res = r[key]
            assert "gather_posterior" in res["refused"], (key, res["refused"])
            got = res["resumed"]
            assert abs(got["elbo"] - single["elbo"]) <= TOL_SELF * abs(single["elbo"]), key
            for path, g, w in ranks.state_pairs(got["params"], single["params"]):
                assert ranks.leaf_dev(g, w) <= TOL_SELF, (key, path, ranks.leaf_dev(g, w))


def test_an_e_step_outside_update_leaves_the_state_whole(world):
    """After a time-sharded fit, HMM ``update_states``, LDS
    ``update_latents`` and dHMM ``raw_update_states`` (the whole-output
    smoothers) leave whole per-time state: the model holds no chunk, and
    ``gather_posterior`` returns the state as it is, with no collective,
    equal to the single process's after the same calls."""
    D, refs, results = world
    for kind in WHOLE_ESTEP:
        key = f"whole estep {kind}"
        single, = refs[key]
        for r in results:
            res = r[key]
            assert not res["held_chunk"] and res["gathered"] == 0, (key, res)
            assert sorted(res["whole"]) == sorted(single), key
            for name in single:
                for path, g, w in ranks.state_pairs(res["whole"][name], single[name]):
                    assert ranks.leaf_dev(g, w) <= TOL_SELF, (key, name, path)


def test_an_observation_node_without_batch_sum_raises_in_a_split_sweep(monkeypatch):
    """An HMM whose observation node forms its sums on its own (no
    ``batch_sum``) cannot be updated where the samples are split across
    processes: each would update from its own part.  Outside such a sweep
    the same update runs."""
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import HMM
    from pyvbmp_tpu_torch.utils import torchutils

    obs = NormalInverseWishart.create((3,), batch_shape=(4,), dtype=torch.float64,
                                      device="cpu")
    monkeypatch.setattr(type(obs), "raw_update",
                        lambda self, X, p=None, lr=1.0, beta=None: self)
    X = torch.tensor(model_data("hmm", 8)[0])
    HMM(obs, generator=torch.Generator().manual_seed(0), device="cpu").update(X)
    monkeypatch.setattr(torchutils, "BATCH_REDUCE", lambda xs: xs)
    with pytest.raises(NotImplementedError, match="without batch_sum"):
        HMM(obs, generator=torch.Generator().manual_seed(0), device="cpu").update(X)


@pytest.mark.parametrize("node", ["Hierarchical_Dirichlet", "HierarchicalTransition"])
def test_count_nodes_complete_their_sums_through_batch_sum(monkeypatch, node):
    """``raw_update`` of the count nodes that take an HMM's (X, p, lr, beta)
    forms its sum over the samples through ``batch_sum``: with the samples
    split in two equal halves (the reduction doubling each sum) it equals
    the update from the doubled counts."""
    from pyvbmp_tpu_torch import dists as PD
    from pyvbmp_tpu_torch import transforms as PT
    from pyvbmp_tpu_torch.utils import torchutils

    kw = dict(dtype=torch.float64, device="cpu")
    make = {"Hierarchical_Dirichlet": lambda: PD.Hierarchical_Dirichlet.create((3, 4, 2), (2,),
                                                                            **kw),
            "HierarchicalTransition": lambda: PT.HierarchicalTransition.create((2, 3), (2,),
                                                                            **kw)}
    n = make[node]()
    rs = np.random.RandomState(0)
    X = torch.tensor(rs.rand(5, *n.batch_shape, *n.event_shape))
    p = torch.tensor(rs.rand(5, *n.batch_shape))
    want = n.raw_update(2 * X, p)
    monkeypatch.setattr(torchutils, "BATCH_REDUCE", lambda xs: tuple(2 * x for x in xs))
    got = n.raw_update(X, p)
    np.testing.assert_allclose(got.NA.numpy(), want.NA.numpy(), rtol=1e-12)
    for a, b in zip(got.dists, want.dists):
        np.testing.assert_allclose(a.alpha.numpy(), b.alpha.numpy(), rtol=1e-12)


def test_auto_batch_axis_warns_and_a_named_axis_raises(world4):
    _, refs, results = world4
    auto = results[0]["auto falls back"]
    assert any("does not divide" in w for w in auto["warnings"]), auto["warnings"]
    assert rel_dev(auto["out"], refs["auto falls back"][0][0]) <= TOL_SELF
    named = results[0]["named raises"]
    assert "divisible" in named["error"]
