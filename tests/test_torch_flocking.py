"""The DMBD-Flocking slice: the port's Flocking simulator and its 3-object
DMBD (K = 14 roles, h = 14) against the JAX package's, in float64 on the CPU.

- The simulator: the JAX draws (the key splits of
  pyvbmp_tpu/simulations/flocking.py) fed to the port's ``integrate`` give
  ``Flocking(...).simulate(key)``'s trajectories within 1e-8 relative.
- The model: Flocking data at narrow widths (4 birds x 4 channels, T = 24,
  batch 3), role_dims (2,2,2), hidden_dims (2,2,2), number_of_objects=3,
  from one initial state.  The JAX model runs under the scoped
  ``jax.enable_x64`` with its default (unfolded) scans; the port runs with
  the time fold forced on (``TIME_FOLD="auto"`` at a test-sized
  ``TIME_FOLD_MIN_T``), so every scan of the sweep goes through the folded
  route.  ELBO trajectory, final role posteriors p and latent means px.mu
  within 1e-8 relative; ``particular_assignment()`` and ``assignment()``
  equal.  Two runs: 3 sweeps of ``update(y, iters=3)``, and the positional
  ``update(y, None, None, 2, 2, 0.5)`` (two sweeps, each after one warm-up
  pass, lr 0.5) against JAX's keyword call."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.simulations import Flocking as JFlocking
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery as TDMBD
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.simulations import Flocking
from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

TOL = 1e-8
BIRDS, T_LEN, BATCH = 4, 24, 3
CFG = dict(obs_shape=(BIRDS, 4), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2),
           number_of_objects=3)
# name -> (positional update arguments after y, JAX keyword arguments)
RUNS = {"sweeps": ((None, None, 3), dict(iters=3)),
        "warm_up": ((None, None, 2, 2, 0.5), dict(iters=2, latent_iters=2, lr=0.5))}
REPO = Path(__file__).resolve().parent.parent


def jax_draws(key, sim):
    """The random draws of pyvbmp_tpu/simulations/flocking.py:simulate."""
    k1, k2, k3 = jax.random.split(key, 3)
    B, N = sim.batch_size, sim.n_birds
    pos0 = jax.random.normal(k1, (B, N, 2)) * 2.0
    vel0 = jax.random.normal(k2, (B, N, 2)) * 0.5
    keys = jax.random.split(k3, sim.Tmax)
    noise = jnp.stack([jax.random.normal(k, (B, N, 2)) for k in keys])
    return [torch.tensor(np.asarray(a)) for a in (pos0, vel0, noise)]


def test_simulator_matches_jax_on_the_same_draws():
    kw = dict(n_birds=5, Tmax=20, batch_size=3)
    with jax.enable_x64(True):
        key = jax.random.key(3)
        ref = np.asarray(JFlocking(**kw).simulate(key))
        draws = jax_draws(key, JFlocking(**kw))
    out = Flocking(**kw).integrate(*draws).numpy()
    assert out.shape == (20, 3, 5, 4) and out.dtype == np.float64
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def test_simulate_draws_from_the_generator():
    sim = Flocking(n_birds=6, Tmax=30, batch_size=2)
    a = sim.simulate(torch.Generator().manual_seed(0), device="cpu")
    b = sim.simulate(torch.Generator().manual_seed(0), device="cpu")
    c = sim.simulate(torch.Generator().manual_seed(1), dtype=torch.float32, device="cpu")
    assert a.shape == (30, 2, 6, 4) and torch.equal(a, b)
    assert c.dtype == torch.float32 and not torch.allclose(a.float(), c)
    assert torch.allclose(a.std(dim=(0, 1, 2), correction=0), torch.ones(4, dtype=a.dtype))


@pytest.fixture(scope="module")
def data():
    with jax.enable_x64(True):
        sim = JFlocking(n_birds=BIRDS, Tmax=T_LEN, batch_size=BATCH)
        return np.asarray(sim.simulate(jax.random.key(0)))


@pytest.fixture(scope="module", params=sorted(RUNS))
def fitted(request, data):
    """(JAX results, port model, the port's folded-scan counts) after the
    run named by the parameter."""
    args, kwargs = RUNS[request.param]
    with jax.enable_x64(True):
        rng.seed(0)
        jm = JDMBD(**CFG, parallel_scan=True)
        state = dmbd_state(jm)
        jm.update(jnp.asarray(data), **kwargs)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.obs_model.p),
                   mu=np.asarray(jm.px.mu), pa=np.asarray(jm.particular_assignment()),
                   a=np.asarray(jm.assignment()))
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scan, "TIME_FOLD", "auto")
        mp.setattr(scan, "TIME_FOLD_MIN_T", 8)
        before = [(s.folded.plain_calls, s.plain_calls) for s in scan.SCANS]
        tm.update(torch.tensor(data), *args)
        counts = [(s.folded.plain_calls - f, s.plain_calls - p)
                  for s, (f, p) in zip(scan.SCANS, before)]
    return request.param, ref, tm, counts


def rel_dev(port, ref):
    return np.abs(port.numpy() - ref).max() / np.abs(ref).max()


def test_every_scan_took_the_folded_route(fitted):
    name, _, tm, counts = fitted
    assert tm.role_dim == 14 and tm.hidden_dim == 14
    # two scans per smoother pass: one pass a sweep, two with a warm-up pass
    passes = 3 if name == "sweeps" else 2 * 2
    assert counts == [(2 * passes, 0), (2 * passes, 0), (0, 0)]


def test_elbo_trajectory_matches_jax(fitted):
    _, ref, tm, _ = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == ref["elbo"].shape
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL


def test_final_posteriors_and_assignments_match_jax(fitted):
    _, ref, tm, _ = fitted
    assert rel_dev(tm.obs_model.p, ref["p"]) <= TOL
    assert rel_dev(tm.px.mu, ref["mu"]) <= TOL
    pa = tm.particular_assignment()
    assert pa.shape == (T_LEN, BATCH, BIRDS)
    assert np.array_equal(pa.numpy(), ref["pa"])
    assert np.array_equal(tm.assignment().numpy(), ref["a"])
    pr = tm.particular_assignment_pr()
    assert pr.shape == (T_LEN, BATCH, BIRDS, 4)
    assert torch.allclose(pr.sum(-1), torch.ones_like(pr[..., 0]))


def test_three_object_state_round_trips_through_numpy(fitted):
    _, _, tm, _ = fitted
    again = dmbd_from_state(dmbd_state(tm), device="cpu", dtype=torch.float64)
    assert again.number_of_objects == 3 and again.role_dim == 14
    assert torch.equal(again.A.mu, tm.A.mu)
    assert torch.equal(again.obs_model.transition.alpha, tm.obs_model.transition.alpha)
    assert torch.equal(again.px.mu, tm.px.mu)
    assert torch.equal(again.obs_model.p, tm.obs_model.p)


def test_update_binds_positional_arguments_as_jax_does(monkeypatch):
    """update(y, u, r, iters, latent_iters, lr, verbose): a positional
    (y, None, None, 2, 1, 0.5) is two sweeps at latent_iters 1, lr 0.5."""
    m = TDMBD((3, 2), (1, 2, 1), (2, 2, 2), generator=torch.Generator().manual_seed(0),
              device="cpu")
    seen = []
    step = m._dmbd_step

    def spy(*args):
        seen.append(args[-2:])  # (lr, latent_iters)
        return step(*args)

    monkeypatch.setattr(m, "_dmbd_step", spy)
    m.update(torch.randn(10, 2, 3, 2, generator=torch.Generator().manual_seed(1)),
             None, None, 2, 1, 0.5)
    assert seen == [(0.5, 1), (0.5, 1)]
    assert m.iters == 2 and len(m.ELBO_save) == 2


def test_flocking_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from pyvbmp_tpu_torch.simulations import Flocking\n"
        "import torch\n"
        "print(Flocking(n_birds=3, Tmax=4, batch_size=2)"
        ".simulate(torch.Generator().manual_seed(0), device='cpu').shape)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "torch.Size([4, 2, 3, 4])"
