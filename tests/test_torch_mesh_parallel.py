"""The port's data-parallel VB sweeps (``pyvbmp_tpu_torch.parallel.api``) on
4 gloo ranks on the CPU, in float64, against the JAX package's
``data_parallel_update`` on its 8-virtual-device mesh and against the port's
single-process fit, at the sizes of ``tests/test_mesh_parallel.py``.

One spawn (``test_torch_mesh_ranks.start``, a module fixture) runs every
check; the JAX side and the single-process fits are computed here while the
ranks run.  Tolerances: ELBO trajectories and the parameters compared,
max relative deviation 1e-8 against JAX, 1e-10 against the single process.

- LDS, DMBD, HMM, GMM (``batch_axis=0``; NormalInverseWishart components,
  and also NormalGamma and the Poisson mixture's Gamma against the single
  process; GMM_vector), MixLDS, Tensor_HMM, HHMM, Factorial_HMM, NLDS
  (from a q(s) of the whole batch; and with none, drawn at the whole
  batch's size, against the single process only: each rank's q(s) its
  block of the single's), BFA and the ChainedBayesianTransformer: the ELBOs
  and every parameter node bit-equal on every rank;
- the check that ends every call: one all_gather of the call's ELBOs
  (``"check"``), every other tag's elements as before it; a model that
  sums on its own (``LocalSums``) raises ``RuntimeError`` on every rank;
  every exported class with a one-tensor ``update(y, iters=, lr=)`` is a
  case here or refused with its reason (``REFUSED``: the ARHMMs' tuples),
  and a Mixture over ``MultivariateNormal`` raises;
- DMBD with ``time_mesh`` and ``data_parallel_update`` on one 2 x 2 (seq x
  data) mesh;
- the collectives (the counterpart of the JAX test of the compiled HLO):
  DMBD's ``"reduce"`` elements per sweep at batch 8 equal those at batch 64,
  nonzero and under 10 * 64 * 8, and no ``"gather"``;
- ``shard_batch``'s blocks, ``replicate``, ``make_mesh`` without a process
  group, and the parallel modules importing without JAX;
- a MixLDS's systems cut over a ``model`` axis (``SYSTEM_CASES``): on a
  2 x 2 ("data", "model") mesh and a (1, 4) mesh of the 4 ranks, and a
  (1, 2) mesh of a second world of 2, against ``_vb_multi`` jitted on a
  JAX ("data", "model") mesh with the systems placed as
  ``__graft_entry__.py``'s leg 2 places them (every parameter node, 1e-8)
  and against the single process (1e-10), an uneven K (3 on 2 ranks) and
  an uneven batch included; the "systems" elements a sweep at two T,
  "gather" once a call; lds.px this rank's systems until
  ``gather_posterior``, the exporters refusing it; and the refusals (a
  ``model`` axis on an LDS, beside a ``time_mesh``, longer than K)."""
import copy
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_ranks as ranks
from pyvbmp_tpu.dists import NormalInverseWishart as JNIW
from pyvbmp_tpu.models import HMM as JHMM
from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.models import GaussianMixtureModel as JGMM
from pyvbmp_tpu.models import LinearDynamicalSystems as JLDS
from pyvbmp_tpu.models import MixtureofLinearDynamicalSystems as JMixLDS
from pyvbmp_tpu.models import PoissonMixtureModel as JPMM
from pyvbmp_tpu import dists as JD
from pyvbmp_tpu import models as JM
from pyvbmp_tpu import transforms as JT
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from pyvbmp_tpu.parallel import api as japi
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.utils import convert, torchutils

TOL_JAX, TOL_SELF = 1e-8, 1e-10
WORLD = 4
REPO = Path(__file__).resolve().parent.parent
DMBD_CFG = dict(obs_shape=(4, 2), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1))


def gmm_points():
    rs = np.random.RandomState(5)
    return np.concatenate([rs.randn(80, 2) + c for c in ([-3, 0], [3, 0], [0, 3])], 0)


def hmm_data(T=30, B=16, D=3, K=4, seed=9):
    """Sticky K-state chains seen through Gaussian means (the HMM-core
    recipe, ``benchmarks/core_models_bench.py:hmm_data``, at T=30, batch 16,
    d=3)."""
    rs = np.random.RandomState(seed)
    mus = rs.randn(K, D) * 3
    z = np.zeros((T, B), np.int64)
    for t in range(1, T):
        z[t] = np.where(rs.rand(B) < 0.9, z[t - 1], rs.randint(0, K, B))
    return mus[z] + rs.randn(T, B, D)


def with_q_s(jm, T=30, B=16, seed=1):
    """The JAX NLDS with a q(s) of the whole batch set."""
    jm.p = jnp.asarray(np.random.RandomState(seed).dirichlet(np.ones(jm.mixture_dim), (T, B)))
    return jm


# name -> (kind, JAX model builder, data, sweeps, seed, batch_axis, compared with JAX)
CASES = {
    "lds": ("lds", lambda: JLDS(obs_shape=(4,), hidden_dim=2),
            np.random.RandomState(0).randn(20, 16, 4), 2, 7, None, True),
    "dmbd": ("dmbd", lambda: JDMBD(**DMBD_CFG), np.random.RandomState(1).randn(10, 8, 4, 2),
             2, 3, None, True),
    "hmm": ("hmm", lambda: JHMM(JNIW.create((3,), batch_shape=(4,))),
            np.random.RandomState(4).randn(30, 16, 3), 3, 11, None, True),
    "gmm": ("gmm", lambda: JGMM(3, 2), gmm_points(), 4, 13, 0, True),
    "mixlds": ("mixlds", lambda: JMixLDS(2, (3,), 2, 0, 0),
               np.random.RandomState(2).randn(20, 16, 3), 2, 5, None, True),
    "gmm isotropic": ("gmm", lambda: JGMM(3, 2, isotropic=True), gmm_points(), 4, 13, 0,
                      False),
    "poisson": ("gmm", lambda: JPMM(3, 2),
                np.random.RandomState(6).poisson([[2.0, 5.0]], (240, 2)).astype(float), 4,
                13, 0, False),
    "gmm vector": ("gmm", lambda: JD.GMM_vector(3, 2), gmm_points()[..., None], 3, 13, 0,
                   True),
    "tensor_hmm": ("tensor_hmm",
                   lambda: JM.Tensor_HMM(JNIW.create((3,), batch_shape=(2, 2)), (2, 2)),
                   hmm_data(), 3, 19, None, True),
    "hhmm": ("tensor_hmm", lambda: JM.HHMM(JNIW.create((3,), batch_shape=(2, 2)), event_dim=2),
             hmm_data(), 3, 19, None, True),
    "factorial_hmm": ("tensor_hmm", lambda: JM.Factorial_HMM(2, (2,), (3,)), hmm_data(), 3,
                      19, None, True),
    "nlds": ("nlds", lambda: with_q_s(JM.NLDS((3,), hidden_dim=2, mixture_dim=3)),
             hmm_data(seed=10), 3, 21, None, True),
    # q(s) unset: the ranks draw the single process's q(s) from torch's
    # generator, which is not JAX's key
    "nlds fresh": ("nlds", lambda: JM.NLDS((3,), hidden_dim=2, mixture_dim=3),
                   hmm_data(seed=10), 3, 21, None, False),
    "bfa": ("bfa", lambda: JM.BayesianFactorAnalysis(5, 2),
            np.random.RandomState(12).randn(64, 5), 3, 23, 0, True),
    "cbt": ("cbt", lambda: JT.ChainedBayesianTransformer(1, 1, 2, 2),
            np.random.RandomState(14).randn(64, 3, 2), 3, 25, 0, True),
}
COMPARED = ("elbo", "A_mu", "alpha", "mu", "pi", "params")
# The exported classes with update(y, iters=, lr=) that data_parallel_update
# refuses, with the reason (each raises on the ranks, ``job_refused``); every
# other is a class of a model in CASES
REFUSED = {
    "ARHMM": "observations are a tuple (X, Y), which data_parallel_update cannot split "
             "(the JAX package's shard_batch places one array)",
    "ARHMM_prXY": "observations are a tuple of messages (pX, pY), as above",
    "ARHMM_prXRY": "observations are a tuple (pX, R, Y), as above",
}


@pytest.fixture(scope="module")
def built():
    """name -> (JAX model, its state before any fit), built once."""
    out = {}
    with jax.enable_x64(True):
        for name, (kind, build, *_, seed, _, _) in CASES.items():
            rng.seed(seed)
            jm = build()
            out[name] = jm, getattr(convert, f"{kind}_state")(jm)
    return out


def jax_fit(jm, name):
    """The JAX package's data_parallel_update on its 8-device mesh."""
    kind, _, data, sweeps, _, batch_axis, _ = CASES[name]
    with jax.enable_x64(True):
        japi.data_parallel_update(jm, jnp.asarray(data), mesh=japi.make_mesh(),
                                  iters=sweeps, batch_axis=batch_axis)
        return summary(kind, jm)


def summary(kind, m):
    out = {"elbo": np.asarray(m.ELBO_save, np.float64)} if hasattr(m, "ELBO_save") else {}
    for key, val in ranks._summary(kind, m).items():
        if key == "params":
            out[key] = val
        elif key in COMPARED:
            out[key] = np.asarray(val.detach().numpy() if isinstance(val, torch.Tensor) else val)
    return out


def single_fit(state, name, parallel_scan=None):
    """The port's single-process fit: its summary, and NLDS's q(s)."""
    kind, _, data, sweeps, *_ = CASES[name]
    state = copy.deepcopy(state)
    if parallel_scan is not None:
        state["config"]["parallel_scan"] = parallel_scan
    m = getattr(convert, f"{kind}_from_state")(state, device="cpu", dtype=torch.float64)
    ranks._fit(m, kind, (data,), sweeps)
    return summary(kind, m), m.p.numpy() if kind == "nlds" else None


def dmbd_batch(B):
    with jax.enable_x64(True):
        rng.seed(3)
        state = convert.dmbd_state(JDMBD(**DMBD_CFG))
    return state, (np.random.RandomState(1).randn(10, B, 4, 2),)


# name -> (K, T, batch, sweeps, port mesh, world, JAX mesh shape or None): the
# MixLDS(K, (3,), 2, 0, 0, parallel_scan=True) fits with the systems cut over
# the "model" axis; the JAX fit is one a K, at T=12, batch 8, 3 sweeps
SYSTEM_CASES = {
    "K=2 (1, 2)": (2, 12, 8, 3, "model", 2, (2, 2)),
    "K=3 (1, 2)": (3, 12, 8, 3, "model", 2, None),
    "K=2 2x2": (2, 12, 8, 3, "data_model", 4, (2, 2)),
    "K=4 2x2": (4, 12, 8, 3, "data_model", 4, (2, 4)),
    "K=4 (1, 4)": (4, 12, 8, 3, "model", 4, (2, 4)),
    "K=3 2x2, batch 7": (3, 12, 7, 3, "data_model", 4, None),
    "K=4 2x2 T=24": (4, 24, 8, 1, "data_model", 4, None),
}
SYSTEM_SEED = 17


def system_data(T, b):
    return np.random.RandomState(8).randn(T, b, 3)


def system_model(K):
    """(the JAX MixLDS with K systems, its state), float64."""
    with jax.enable_x64(True):
        rng.seed(SYSTEM_SEED)
        jm = JMixLDS(K, (3,), 2, 0, 0, parallel_scan=True)
        return jm, convert.mixlds_state(jm)


def jax_systems(jm, data, sweeps, shape):
    """``__graft_entry__.py``'s leg 2 on ``data``: ``_vb_multi`` jitted on a
    ("data", "model") mesh of ``shape``, the batch on "data" and every leaf
    whose leading axis is the system axis on "model"; the ELBOs and the
    parameter nodes' states."""
    with jax.enable_x64(True):
        K = jm.num_systems
        mesh = JMesh(np.asarray(jax.devices()[:np.prod(shape)]).reshape(shape),
                     ("data", "model"))
        batch = NamedSharding(mesh, P(None, "data"))
        y, u, r = (jax.device_put(t, batch) for t in jm.lds.reshape_inputs(jnp.asarray(data)))

        def shard_K(leaf):
            if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == K:
                return jax.device_put(leaf, NamedSharding(mesh, P("model")))
            return jax.device_put(leaf, NamedSharding(mesh, P()))

        nodes = jax.tree.map(shard_K, (jm.lds.x0, jm.lds.A, jm.lds.obs_model, jm.pi))
        step = jax.jit(jm._vb_multi, static_argnames=("iters",))
        x0, A, obs_model, pi, _, _, elbos = step(*nodes, y, u, r, 1.0, sweeps)
        fit = copy.copy(jm)
        fit.lds = copy.copy(jm.lds)
        fit.lds.x0, fit.lds.A, fit.lds.obs_model, fit.pi = x0, A, obs_model, pi
        return {"elbo": np.asarray(elbos, np.float64), "params": ranks._params("mixlds", fit)}


def single_systems(state, data, sweeps):
    """The port's single-process fit: ELBOs, parameter nodes, p and px."""
    m = convert.mixlds_from_state(state, device="cpu", dtype=torch.float64)
    m.update(torch.tensor(data), iters=sweeps)
    return {"elbo": np.asarray(m.ELBO_save), "params": ranks._params("mixlds", m),
            "p": m.p.numpy(), "px": ranks._np(ranks._px(m.lds.px))}


def system_jobs(world_size, states):
    return {name: ("systems", dict(state=states[K], data=(system_data(T, b),), sweeps=n,
                                   mesh=mesh))
            for name, (K, T, b, n, mesh, w, _) in SYSTEM_CASES.items() if w == world_size}


@pytest.fixture(scope="module")
def world(built, tmp_path_factory):
    """(references, each rank's results; the system split's references and
    each rank's results of the worlds of 4 and 2)."""
    systems = {K: system_model(K) for K in sorted({c[0] for c in SYSTEM_CASES.values()})}
    states = {K: state for K, (_, state) in systems.items()}
    started2 = ranks.start(2, tmp_path_factory.mktemp("dp2"), system_jobs(2, states))
    jobs = system_jobs(4, states)
    jobs["refusals"] = ("refusals", dict(lds_state=built["lds"][1], mix_state=states[2],
                                         data=system_data(12, 8)))
    for name, (kind, _, data, sweeps, _, batch_axis, _) in CASES.items():
        jobs[name] = ("data_parallel", dict(kind=kind, state=built[name][1], data=(data,),
                                            sweeps=sweeps, batch_axis=batch_axis))
    dstate = built["dmbd"][1]
    both = copy.deepcopy(dstate)
    both["config"]["parallel_scan"] = True
    jobs["dmbd both"] = ("data_parallel", dict(
        kind="dmbd", state=dstate, data=(CASES["dmbd"][2],), sweeps=2, mesh="seq_data",
        time_mesh="seq_data"))
    for B in (8, 64):
        state, data = dmbd_batch(B)
        jobs[f"dmbd batch {B}"] = ("data_parallel", dict(kind="dmbd", state=state, data=data,
                                                         sweeps=1))
    jobs["check"] = ("check", dict(data=np.random.RandomState(3).randn(5, 16, 3), sweeps=2))
    jobs["refused"] = ("refused", dict(data=np.random.RandomState(3).randn(5, 16, 2)))
    jobs["shard shapes"] = ("shard_shapes", dict(shapes=[((4, 16, 3), 1), ((4, 10, 3), 1),
                                                         ((240, 2), 0)]))
    jobs["replicate"] = ("replicate", dict(state=dstate))
    started = ranks.start(WORLD, tmp_path_factory.mktemp("dp"), jobs)
    refs, system_refs = {}, {}
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(jax_fit, built[name][0], name)
                for name, case in CASES.items() if case[-1]}
        jax_futs = {K: pool.submit(jax_systems, jm, system_data(12, 8), 3, shape)
                    for (K, _, _, _, _, _, shape) in SYSTEM_CASES.values() if shape
                    for jm in (systems[K][0],)}
        for name in CASES:
            refs[name] = dict(zip(("self", "self_p"), single_fit(built[name][1], name)))
        refs["dmbd both"] = {"self": single_fit(dstate, "dmbd", parallel_scan=True)[0]}
        for name, (K, T, b, n, _, _, shape) in SYSTEM_CASES.items():
            system_refs[name] = {"self": single_systems(states[K], system_data(T, b), n)}
        for name, f in futs.items():
            refs[name]["jax"] = f.result()
        for name, (K, *_, shape) in SYSTEM_CASES.items():
            if shape:
                system_refs[name]["jax"] = jax_futs[K].result()
    results = ranks.join(started)
    system_results = {4: results, 2: ranks.join(started2)}
    for r in results + system_results[2]:
        for key, res in r.items():
            assert "traceback" not in res, (key, res["traceback"])
    return refs, results, system_refs, system_results


def rel(out, ref):
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


def leaves(summ):
    """(key, array) of every numeric value of a summary, the parameter
    nodes' leaves included."""
    for k, v in summ.items():
        if k in ("counts", "p_block"):
            continue
        if k == "params":
            for path, leaf, _ in ranks.state_pairs(v, v):
                if leaf.dtype.kind in "fiub" and leaf.size:
                    yield f"params{path}", leaf
        else:
            yield k, v


@pytest.mark.parametrize("name", list(CASES) + ["dmbd both"])
def test_data_parallel_update_matches_jax_and_the_single_process(world, name):
    refs, results, *_ = world
    out = dict(leaves(results[0][name]))
    assert set(out) == set(dict(leaves(refs[name]["self"]))), name
    for other in results[1:]:  # the sums are completed: every rank agrees
        for k, v in leaves(other[name]):
            if k in out:
                assert np.array_equal(v, out[k]), k
    for which, tol in (("jax", TOL_JAX), ("self", TOL_SELF)):
        if which not in refs[name]:
            continue
        for k, v in leaves(refs[name][which]):
            assert rel(out[k], v) <= tol, (name, which, k, out[k], v)
    assert results[0][name]["counts"]["reduce"] > 0


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] == "nlds"])
def test_nlds_starts_each_rank_from_its_block_of_the_single_process_q_s(world, name):
    """q(s) of the whole batch, set or drawn at the whole batch's size,
    is cut to each rank's block: after the fit each rank holds its block of
    the single process's q(s)."""
    refs, results, *_ = world
    whole = refs[name]["self_p"]
    for rank, r in enumerate(results):
        want = np.array_split(whole, WORLD, axis=1)[rank]
        assert r[name]["p_block"].shape == want.shape
        assert ranks.leaf_dev(r[name]["p_block"], want) <= TOL_SELF, rank


# The elements each case's collectives moved by tag before the check was
# added (the parent's, nonzero tags only): the check adds its own tag alone
BEFORE_THE_CHECK = {
    "lds": {"reduce": 130}, "dmbd": {"reduce": 746}, "hmm": {"reduce": 231},
    "gmm": {"reduce": 100}, "mixlds": {"reduce": 222}, "gmm isotropic": {"reduce": 76},
    "poisson": {"reduce": 64}, "dmbd both": {"scan": 2992, "halo": 1044, "reduce": 750},
}


@pytest.mark.parametrize("name", list(CASES) + ["dmbd both"])
def test_the_check_adds_one_gather_and_moves_no_other_count(world, name):
    """The call's check: one all_gather of the call's ELBOs over the whole
    mesh, ``sweeps`` elements from each of its 4 ranks (none for a model
    without ``ELBO_save``); every other tag's elements are those of the
    same call before the check was added."""
    _, results, *_ = world
    sweeps = 2 if name == "dmbd both" else CASES[name][3]
    for r in results:
        counts = r[name]["counts"]
        assert counts["check"] == (sweeps * WORLD if "elbo" in r[name] else 0), counts
        if name in BEFORE_THE_CHECK:
            assert {k: v for k, v in counts.items() if v and k != "check"} == \
                BEFORE_THE_CHECK[name], counts


def test_a_model_that_sums_on_its_own_raises_on_every_rank(world):
    """``LocalSums``, whose ELBO is the sum of its block, leaves each rank
    with its own ELBOs: the check raises ``RuntimeError`` on every rank,
    naming the class and the first sweep."""
    _, results, *_ = world
    for r in results:
        kind, msg = r["check"]["error"]
        assert kind == "RuntimeError", msg
        assert "LocalSums" in msg and "sweep 1 of 2" in msg, msg
        assert r["check"]["counts"]["check"] == 2 * WORLD


def data_parallel_classes():
    """Every exported model class of the port that ``data_parallel_update``
    can hand its data: ``update(y, iters=..., lr=...)`` with y its one
    required argument."""
    import inspect

    from pyvbmp_tpu_torch import dists, models, transforms

    out = set()
    for mod in (models, dists, transforms):
        for name in dir(mod):
            cls = getattr(mod, name)
            if not inspect.isclass(cls) or not callable(getattr(cls, "update", None)):
                continue
            params = list(inspect.signature(cls.update).parameters.values())[1:]
            required = [p for p in params if p.default is inspect.Parameter.empty]
            names = {p.name for p in params}
            if len(required) == 1 and {"iters", "lr"} <= names:
                out.add(cls.__name__)
    return out


def test_every_model_with_a_one_tensor_update_is_a_case_or_refused(world, built):
    """Each such class is the class of a model in CASES (or one it
    derives from), or in REFUSED, whose classes raise on every rank with
    their reason; a Mixture over a node that sums on its own
    (MultivariateNormal: the JAX package's fails in its KL) raises too."""
    _, results, *_ = world
    covered = {c.__name__ for jm, _ in built.values() for c in type(jm).__mro__}
    classes = data_parallel_classes()
    assert {"Tensor_HMM", "HHMM", "Factorial_HMM", "NonLinearDynamicalSystems",
            "Mixture", "ARHMM"} <= classes
    missing = classes - covered - set(REFUSED)
    assert not missing, f"neither a case nor refused: {sorted(missing)}"
    assert not set(REFUSED) & covered
    for r in results:
        got = r["refused"]
        for name in REFUSED:
            assert got[name][0] == "NotImplementedError", (name, got[name])
            assert "tuple" in got[name][1], (name, got[name])
        kind, msg = got["Mixture over MultivariateNormal"]
        assert kind == "NotImplementedError" and "batch_sum" in msg, msg


def test_dmbd_reductions_do_not_grow_with_the_batch(world):
    """The port's counterpart of the JAX test of the compiled sweep's
    collectives: only all_reduces of the statistics, the same at 8 times
    the batch, and nothing the size of the data."""
    _, results, *_ = world
    small = results[0]["dmbd batch 8"]["counts"]
    big = results[0]["dmbd batch 64"]["counts"]
    assert small["reduce"] == big["reduce"] > 0, (small, big)
    assert big["reduce"] < 10 * 64 * 8
    for c in (small, big):
        assert c["gather"] == c["scan"] == c["halo"] == c["replicate"] == 0, c
    assert results[0]["dmbd"]["counts"]["gather"] == 0


def test_shard_batch_takes_this_ranks_block(world):
    _, results, *_ = world
    got = [r["shard shapes"]["shapes"] for r in results]
    assert [g[0] for g in got] == [(4, 4, 3)] * 4
    assert [g[1] for g in got] == [(4, 3, 3), (4, 3, 3), (4, 2, 3), (4, 2, 3)]
    assert [g[2] for g in got] == [(60, 2)] * 4


def test_replicate_gives_every_rank_the_first_ranks_state(world):
    _, results, *_ = world
    first = results[0]["replicate"]
    for r in results[1:]:
        assert np.array_equal(r["replicate"]["A_mu"], first["A_mu"])
        assert np.array_equal(r["replicate"]["x0_mu"], first["x0_mu"])
    assert results[0]["replicate"]["counts"]["replicate"] > 0


def test_make_mesh_without_a_process_group_raises():
    from pyvbmp_tpu_torch.parallel import Mesh, make_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh()
    with pytest.raises(RuntimeError, match="init_process_group"):
        Mesh(np.arange(2), ("data",))


def test_parallel_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pyvbmp_tpu_torch.parallel, pyvbmp_tpu_torch.parallel.api, "
        "pyvbmp_tpu_torch.parallel.seq_parallel, test_torch_mesh_ranks\n"
        "assert not any(m == 'pyvbmp_tpu' or m.startswith('pyvbmp_tpu.') for m in sys.modules)\n"
    )
    env = {"PYTHONPATH": f"{REPO}:{REPO / 'tests'}", "PATH": "/usr/bin:/bin"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env)


def system_results(world, name):
    """Each rank's results of a system-split case, and its references."""
    *_, system_refs, system_results = world
    return [r[name] for r in system_results[SYSTEM_CASES[name][5]]], system_refs[name]


def data_block(x, res, axis):
    """The block of the batch (``axis``) of a whole ``x`` that the rank of
    ``res`` holds on its mesh's "data" axis."""
    return np.array_split(x, res["data_parts"], axis=axis)[res["data_coord"]]


@pytest.mark.parametrize("name", list(SYSTEM_CASES))
def test_system_split_matches_jax_and_the_single_process(world, name):
    """The fit with the systems cut over "model": every rank ends with the
    same whole parameter nodes (K systems), equal to the JAX package's leg
    2 at 1e-8 and to the single process at 1e-10 in every leaf."""
    results, refs = system_results(world, name)
    K = SYSTEM_CASES[name][0]
    for res in results:
        assert res["batch_shape"] == (K,)
        assert np.array_equal(res["elbo"], results[0]["elbo"])
        for path, g, w in ranks.state_pairs(res["params"], results[0]["params"]):
            assert np.array_equal(g, w), (name, path)
    for which, tol in (("jax", TOL_JAX), ("self", TOL_SELF)):
        if which not in refs:
            continue
        ref = refs[which]
        assert rel(results[0]["elbo"], ref["elbo"]) <= tol, (name, which)
        for path, g, w in ranks.state_pairs(results[0]["params"], ref["params"]):
            dev = ranks.leaf_dev(g, w)
            assert dev <= tol, (name, which, path, dev)


@pytest.mark.parametrize("name", ["K=2 (1, 2)", "K=4 2x2", "K=4 (1, 4)", "K=3 2x2, batch 7"])
def test_system_split_keeps_each_ranks_systems_until_gather_posterior(world, name):
    """lds.px holds this rank's systems of its batch block; the exporter
    refuses the model until ``gather_posterior``, which makes px whole over
    the systems (the batch stays the rank's block, as after any
    data-parallel fit) at 1e-10 of the single process's; p is the rank's
    block over all K."""
    results, refs = system_results(world, name)
    K, T = SYSTEM_CASES[name][:2]
    single = refs["self"]
    blocks = np.array_split(np.arange(K), results[0]["model_parts"])
    for res in results:
        b = data_block(single["p"], res, 0).shape[0]
        assert res["local_shape"] == (T, b, len(blocks[res["model_coord"]]), 2, 1)
        assert "gather_posterior" in res["refused"], res["refused"]
        assert res["gathered"] > 0
        assert ranks.leaf_dev(res["p"], data_block(single["p"], res, 0)) <= TOL_SELF
        for f, want in single["px"].items():
            assert ranks.leaf_dev(res["px"][f], data_block(want, res, 1)) <= TOL_SELF, f


def test_system_split_exchanges_a_sweep_do_not_grow_with_T(world):
    """One all_gather over "model" a sweep of each sequence's logZ and each
    system's KL ("systems": the line's 2 ranks x 2 systems x (4 sequences +
    1)), the same at T=12 and 24; "gather" is the nodes' one all_gather when
    the call ends, the same after 3 sweeps at T=12 and 1 sweep at T=24, so
    no sweep gathers; the sums over the batch complete over "data" alone
    (the same "reduce" elements a sweep at both T); no scan or halo."""
    short, _ = system_results(world, "K=4 2x2")
    long, _ = system_results(world, "K=4 2x2 T=24")
    for a, b in zip(short, long):
        ca, cb = a["sweep_counts"], b["sweep_counts"]
        assert ca["systems"] // 3 == cb["systems"] == 2 * 2 * (4 + 1), (ca, cb)
        assert ca["reduce"] // 3 == cb["reduce"] > 0, (ca, cb)
        assert ca["gather"] == cb["gather"] > 0, (ca, cb)
        assert ca["scan"] == ca["halo"] == ca["replicate"] == 0, ca


def test_a_model_axis_that_cannot_cut_the_systems_raises(world):
    """A "model" axis on another model (the JAX package shards only a
    MixLDS's systems), beside a ``time_mesh``, or with more ranks than
    systems."""
    _, results, *_ = world
    for r in results:
        got = r["refusals"]
        assert got["lds"][0] == "NotImplementedError" and "MixLDS" in got["lds"][1], got
        assert got["time_mesh"][0] == "NotImplementedError", got
        assert "time_mesh" in got["time_mesh"][1], got
        assert got["too many ranks"][0] == "ValueError", got
        assert "4 ranks cannot cut 2 systems" in got["too many ranks"][1], got


def test_batch_paths_cut_by_each_nodes_batch_shape():
    """The LDS nodes of a MixLDS are cut by their own ``batch_shape``: every
    field that carries it is cut, a prior field broadcast over the systems
    (1s, or no batch axes in front) is kept whole, and putting the blocks
    back gives the node."""
    from pyvbmp_tpu_torch.models import MixtureofLinearDynamicalSystems

    m = MixtureofLinearDynamicalSystems(3, (3,), 2, 0, 0, generator=torch.Generator(),
                                        dtype=torch.float64, device="cpu")
    for node in (m.lds.x0, m.lds.A, m.lds.obs_model):
        paths = torchutils.batch_paths(node)
        assert paths and all(torchutils.at_path(node, p).shape[0] == 3 for p in paths)
        cut = [torchutils.with_batch(node, {p: torchutils.at_path(node, p)[i: j] for p in paths},
                                     j - i) for i, j in ((0, 2), (2, 3))]
        assert [c.batch_shape[0] for c in cut] == [2, 1]
        back = torchutils.with_batch(node, {p: torch.cat([torchutils.at_path(c, p) for c in cut])
                                            for p in paths}, 3)
        for p in paths:
            assert torch.equal(torchutils.at_path(back, p), torchutils.at_path(node, p)), p
    x0 = m.lds.x0
    shared = torchutils.replace(x0, mu_0=x0.mu_0[:1], lambda_mu_0=x0.lambda_mu_0[0])
    assert ("mu_0",) not in torchutils.batch_paths(shared)
    assert ("lambda_mu_0",) not in torchutils.batch_paths(shared)
    assert ("mu",) in torchutils.batch_paths(shared)
