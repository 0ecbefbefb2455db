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
- ``batch_axis="auto"``'s warning where the batch does not divide the data
  axis, and a named axis's ``ValueError``;
- the elements that the ``"scan"``, ``"halo"`` and ``"reduce"`` collectives
  move, equal at T = 40 and T = 80."""
import copy
import functools
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
def model_cases():
    """name -> (kind, JAX model builder (mesh), data, sweeps)."""
    rs = np.random.RandomState(8)
    X = rs.randn(32, 6, 3)
    rs = np.random.RandomState(4)
    T, b, k, pdim, d = 16, 5, 3, 2, 2
    U = rs.randn(T, b, pdim)
    Y = rs.randn(k, d)[rs.randint(0, k, (T, b))] * 3 + 0.2 * rs.randn(T, b, d)
    lds_y = np.random.RandomState(6).randn(24, 4, 3)
    mix_y = np.random.RandomState(9).randn(24, 8, 3)
    dmbd_y = np.random.RandomState(10).randn(16, 4, 4, 2)
    dmbd_odd = np.random.RandomState(10).randn(13, 4, 4, 2)
    return {
        "hmm": ("hmm", lambda m: JHMM(JNIW.create((3,), batch_shape=(4,)), time_mesh=m),
                (X,), 3, 21),
        "dhmm": ("dhmm", lambda m: JdHMM(JNIW.create((d,), batch_shape=(k,)), pdim,
                                         time_mesh=m), (U, Y), 2, 31),
        "lds": ("lds", lambda m: JLDS((3,), 2, 0, 0, cross_cov_compat=False, time_mesh=m),
                (lds_y,), 3, 11),
        "mixlds": ("mixlds", lambda m: JMixLDS(2, (3,), 2, 0, 0, time_mesh=m),
                   (mix_y,), 2, 23),
        "dmbd": ("dmbd", lambda m: JDMBD(**DMBD_CFG, time_mesh=m), (dmbd_y,), 2, 29),
        "dmbd_2x2": ("dmbd", lambda m: JDMBD(**DMBD_CFG, time_mesh=m), (dmbd_odd,), 2, 29),
    }


MODELS = model_cases()


@functools.lru_cache(maxsize=None)
def jax_model(name):
    """(the JAX model with time_mesh on 4 devices (2 x 2 for dmbd_2x2),
    its state before the fit), built once."""
    kind, build, _, _, seed = MODELS[name]
    with jax.enable_x64(True):
        rng.seed(seed)
        jm = build(jmesh(4, two_d=name.endswith("2x2")))
        return jm, getattr(convert, f"{kind}_state")(jm)


def jax_state(name):
    return jax_model(name)[1]


def jax_fit(name):
    """The JAX fit's ELBOs (once per model)."""
    kind, _, data, sweeps, _ = MODELS[name]
    jm = jax_model(name)[0]
    with jax.enable_x64(True):
        args = [jnp.asarray(a) for a in data]
        if kind == "dhmm":
            jm.raw_update(*args, iters=sweeps)
        else:
            jm.update(*args, iters=sweeps)
        return np.asarray(jm.ELBO_save)


@functools.lru_cache(maxsize=None)
def single_fit(name):
    """The port's single-process fit with the scan smoothers, from the
    state the JAX fit starts from."""
    kind, _, data, sweeps, _ = MODELS[name]
    state = copy.deepcopy(jax_state(name))
    state["config"]["parallel_scan"] = True
    m = getattr(convert, f"{kind}_from_state")(state, device="cpu", dtype=torch.float64)
    ranks._fit(m, kind, data, sweeps)
    return np.asarray(m.ELBO_save)


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
    # the models: against JAX on 4 devices, against the single process always
    for name, (kind, _, data, sweeps, _) in MODELS.items():
        if name.endswith("2x2") and D != 4:
            continue
        cases[f"fit {name}"] = (
            ("fit", dict(kind=kind, state=jax_state(name), data=data, sweeps=sweeps,
                         mesh="seq_data" if name.endswith("2x2") else "seq")),
            lambda name=name: ([(jax_fit(name), TOL_JAX)] if D == 4 else [])
            + [(single_fit(name), TOL_SELF)])
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
    assert len(keys) == len(MODELS) - (D != 4)
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


def test_auto_batch_axis_warns_and_a_named_axis_raises(world4):
    _, refs, results = world4
    auto = results[0]["auto falls back"]
    assert any("does not divide" in w for w in auto["warnings"]), auto["warnings"]
    assert rel_dev(auto["out"], refs["auto falls back"][0][0]) <= TOL_SELF
    named = results[0]["named raises"]
    assert "divisible" in named["error"]
