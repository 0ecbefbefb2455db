"""The whole slice: the port's DMBD against the JAX package's from the same
initial state, in float64 on the CPU.

The JAX model is built and run under the scoped ``jax.enable_x64``; its
state goes to the port through ``pyvbmp_tpu_torch.utils.convert``.  Both run
3 VB sweeps on the same numpy data.  Tolerances: ELBO trajectory, final role
posteriors p and latent means px.mu, ``KLqprior()`` and ``ELBO()`` within
max relative deviation 1e-8.  Configurations, each with the scan smoothers
(parallel_scan=True) unless it says otherwise:
- bench: the DMBD-Lorenz widths (obs (3,2), role_dims (1,2,1), hidden_dims
  (2,2,2): K=4, h=6);
- two_objects: number_of_objects=2 (K=7, h=10) driven by a control input u
  and a regressor r;
- sequential: the bench widths with parallel_scan=False, the JAX default
  (the sequential smoothers with the reference's cross-covariance line);
- cradle: the Newton's-cradle widths (benchmarks/cradle_bench.py: obs (5,2),
  role_dims and hidden_dims (2,2,2): K=6, h=6);
- flame: the Flame widths (examples/flame_example.py: obs (12,1),
  role_dims (1,1,1), hidden_dims (2,1,1): K=3, h=4)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery as TDMBD
from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

TOL = 1e-8
SWEEPS = 3
T_LEN, BATCH = 24, 4
LORENZ = dict(obs_shape=(3, 2), role_dims=(1, 2, 1), hidden_dims=(2, 2, 2))
# constructor arguments, control and regression widths of the data
CONFIGS = {
    "bench": (dict(LORENZ, parallel_scan=True), 0, 0),
    "two_objects": (dict(LORENZ, number_of_objects=2, control_dim=1, regression_dim=1,
                         parallel_scan=True), 1, 1),
    "sequential": (dict(LORENZ), 0, 0),
    "cradle": (dict(obs_shape=(5, 2), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2),
                    parallel_scan=True), 0, 0),
    "flame": (dict(obs_shape=(12, 1), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1),
                   parallel_scan=True), 0, 0),
}
REPO = Path(__file__).resolve().parent.parent


def trajectories(rs, obs_shape):
    """Smooth, standardized random-walk observations (T, batch) + obs_shape."""
    y = np.cumsum(rs.randn(T_LEN, BATCH, *obs_shape) * 0.3, 0)
    return (y - y.mean()) / y.std()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fitted(request):
    """(JAX model after SWEEPS sweeps with its p, px.mu, KLqprior() and
    ELBO(), port model after SWEEPS sweeps)."""
    cfg, n_u, n_r = CONFIGS[request.param]
    seed = sorted(CONFIGS).index(request.param) + 1
    rs = np.random.RandomState(seed)
    obs_shape = cfg["obs_shape"]
    y = trajectories(rs, obs_shape)
    u = rs.randn(T_LEN, BATCH, n_u) if n_u else None
    r = rs.randn(T_LEN, BATCH, obs_shape[0], n_r) if n_r else None
    with jax.enable_x64(True):
        rng.seed(seed)
        jm = JDMBD(**cfg)
        state = dmbd_state(jm)
        jm.update(*(None if a is None else jnp.asarray(a) for a in (y, u, r)),
                  iters=SWEEPS)
        ref = dict(p=np.asarray(jm.obs_model.p), mu=np.asarray(jm.px.mu),
                   KL=np.asarray(jm.KLqprior()), ELBO=float(jm.ELBO()))
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    assert tm.parallel_scan == cfg.get("parallel_scan", False)
    assert tm.cross_cov_compat == (not tm.parallel_scan)
    tm.update(*(None if a is None else torch.tensor(a) for a in (y, u, r)),
              iters=SWEEPS)
    return (jm, ref), tm


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return np.abs(port - ref).max() / np.abs(ref).max()


def test_elbo_trajectory_matches_jax(fitted):
    (jm, _), tm = fitted
    ref = np.asarray(jm.ELBO_save)
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    dev = np.abs(out - ref) / np.abs(ref)
    assert dev.max() <= TOL, (out, ref)
    assert (np.diff(out) > 0).all()


def test_final_posteriors_match_jax(fitted):
    (_, ref), tm = fitted
    assert rel_dev(tm.obs_model.p, ref["p"]) <= TOL
    assert rel_dev(tm.px.mu, ref["mu"]) <= TOL


def test_klqprior_and_elbo_match_jax(fitted):
    (_, ref), tm = fitted
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert abs(tm.ELBO() - ref["ELBO"]) / abs(ref["ELBO"]) <= TOL
    assert tm.ELBO() == tm.ELBO_last == tm.ELBO_save[-1]


def test_to_moves_logz(fitted):
    _, tm = fitted
    moved = dmbd_from_state(dmbd_state(tm), device="cpu", dtype=torch.float64)
    moved.logZ = tm.logZ.clone()
    moved.to("cpu", torch.float32)
    assert moved.logZ.dtype == torch.float32
    assert torch.allclose(moved.logZ.double(), tm.logZ, rtol=1e-6)


def test_state_round_trips_through_numpy(fitted):
    """The state dict of a fitted port model rebuilds the same model."""
    _, tm = fitted
    again = dmbd_from_state(dmbd_state(tm), device="cpu", dtype=torch.float64)
    assert torch.equal(again.A.mu, tm.A.mu)
    assert torch.equal(again.obs_model.obs_dist.invU.invU, tm.obs_model.obs_dist.invU.invU)
    assert torch.equal(again.px.mu, tm.px.mu)
    assert torch.equal(again.obs_model.p, tm.obs_model.p)
    assert again.parallel_scan == tm.parallel_scan


def test_unported_options_raise():
    # unique_obs is ported (tests/test_torch_dmbd_options.py); a non-empty
    # batch_shape fails in the JAX package itself, and the message says so
    with pytest.raises(NotImplementedError, match="JAX package's own update fails"):
        TDMBD((3, 2), (1, 2, 1), (2, 2, 2), batch_shape=(2,), device="cpu")
    # time_mesh is ported (tests/test_torch_seq_parallel.py): a mesh that is
    # not the port's is refused
    with pytest.raises(TypeError, match="time_mesh"):
        TDMBD((3, 2), (1, 2, 1), (2, 2, 2), time_mesh="a mesh", device="cpu")


def test_constructor_takes_the_jax_positional_slots():
    """(obs_shape, role_dims, hidden_dims, control_dim, regression_dim,
    batch_shape, number_of_objects, unique_obs, parallel_scan, time_mesh);
    the JAX default is the sequential path."""
    m = TDMBD((3, 2), (1, 2, 1), (2, 2, 2), 0, 0, (), 2, False, True, None, device="cpu")
    assert (m.batch_shape, m.number_of_objects, m.parallel_scan) == ((), 2, True)
    assert not m.cross_cov_compat
    d = TDMBD((3, 2), (1, 2, 1), (2, 2, 2), device="cpu")
    assert (d.number_of_objects, d.parallel_scan, d.cross_cov_compat) == (1, False, True)
    with pytest.raises(TypeError):
        TDMBD((3, 2), (1, 2, 1), (2, 2, 2), 0, 0, (), 1, False, False, None,
              torch.Generator())


def test_port_imports_without_jax():
    """The port never imports jax: it imports with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pyvbmp_tpu_torch\n"
        "from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery, HMM\n"
        "from pyvbmp_tpu_torch.utils import convert\n"
        "from pyvbmp_tpu_torch.simulations import Lorenz\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
