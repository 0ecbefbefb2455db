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
  process) and MixLDS;
- DMBD with ``time_mesh`` and ``data_parallel_update`` on one 2 x 2 (seq x
  data) mesh;
- the collectives (the counterpart of the JAX test of the compiled HLO):
  DMBD's ``"reduce"`` elements per sweep at batch 8 equal those at batch 64,
  nonzero and under 10 * 64 * 8, and no ``"gather"``;
- ``shard_batch``'s blocks, ``replicate``, ``make_mesh`` without a process
  group, and the parallel modules importing without JAX."""
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
from pyvbmp_tpu.parallel import api as japi
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.utils import convert

TOL_JAX, TOL_SELF = 1e-8, 1e-10
WORLD = 4
REPO = Path(__file__).resolve().parent.parent
DMBD_CFG = dict(obs_shape=(4, 2), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1))


def gmm_points():
    rs = np.random.RandomState(5)
    return np.concatenate([rs.randn(80, 2) + c for c in ([-3, 0], [3, 0], [0, 3])], 0)


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
}
COMPARED = ("elbo", "A_mu", "alpha", "mu", "pi")


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
    out = {"elbo": np.asarray(m.ELBO_save, np.float64)}
    for key, val in ranks._summary(kind, m).items():
        if key in COMPARED:
            out[key] = np.asarray(val.detach().numpy() if isinstance(val, torch.Tensor) else val)
    return out


def single_fit(state, name, parallel_scan=None):
    kind, _, data, sweeps, *_ = CASES[name]
    state = copy.deepcopy(state)
    if parallel_scan is not None:
        state["config"]["parallel_scan"] = parallel_scan
    m = getattr(convert, f"{kind}_from_state")(state, device="cpu", dtype=torch.float64)
    ranks._fit(m, kind, (data,), sweeps)
    return summary(kind, m)


def dmbd_batch(B):
    with jax.enable_x64(True):
        rng.seed(3)
        state = convert.dmbd_state(JDMBD(**DMBD_CFG))
    return state, (np.random.RandomState(1).randn(10, B, 4, 2),)


@pytest.fixture(scope="module")
def world(built, tmp_path_factory):
    """(references, each rank's results)."""
    jobs = {}
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
    jobs["shard shapes"] = ("shard_shapes", dict(shapes=[((4, 16, 3), 1), ((4, 10, 3), 1),
                                                         ((240, 2), 0)]))
    jobs["replicate"] = ("replicate", dict(state=dstate))
    started = ranks.start(WORLD, tmp_path_factory.mktemp("dp"), jobs)
    refs = {}
    with ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(jax_fit, built[name][0], name)
                for name, case in CASES.items() if case[-1]}
        for name in CASES:
            refs[name] = {"self": single_fit(built[name][1], name)}
        refs["dmbd both"] = {"self": single_fit(dstate, "dmbd", parallel_scan=True)}
        for name, f in futs.items():
            refs[name]["jax"] = f.result()
    results = ranks.join(started)
    for r in results:
        for key, res in r.items():
            assert "traceback" not in res, (key, res["traceback"])
    return refs, results


def rel(out, ref):
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", list(CASES) + ["dmbd both"])
def test_data_parallel_update_matches_jax_and_the_single_process(world, name):
    refs, results = world
    out = results[0][name]
    for other in results[1:]:  # the sums are completed: every rank agrees
        for k in refs[name]["self"]:
            assert np.array_equal(other[name][k], out[k]), k
    for which, tol in (("jax", TOL_JAX), ("self", TOL_SELF)):
        if which not in refs[name]:
            continue
        ref = refs[name][which]
        for k, v in ref.items():
            assert rel(out[k], v) <= tol, (name, which, k, out[k], v)
    assert out["counts"]["reduce"] > 0


def test_dmbd_reductions_do_not_grow_with_the_batch(world):
    """The port's counterpart of the JAX test of the compiled sweep's
    collectives: only all_reduces of the statistics, the same at 8 times
    the batch, and nothing the size of the data."""
    _, results = world
    small = results[0]["dmbd batch 8"]["counts"]
    big = results[0]["dmbd batch 64"]["counts"]
    assert small["reduce"] == big["reduce"] > 0, (small, big)
    assert big["reduce"] < 10 * 64 * 8
    for c in (small, big):
        assert c["gather"] == c["scan"] == c["halo"] == c["replicate"] == 0, c
    assert results[0]["dmbd"]["counts"]["gather"] == 0


def test_shard_batch_takes_this_ranks_block(world):
    _, results = world
    got = [r["shard shapes"]["shapes"] for r in results]
    assert [g[0] for g in got] == [(4, 4, 3)] * 4
    assert [g[1] for g in got] == [(4, 3, 3), (4, 3, 3), (4, 2, 3), (4, 2, 3)]
    assert [g[2] for g in got] == [(60, 2)] * 4


def test_replicate_gives_every_rank_the_first_ranks_state(world):
    _, results = world
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
