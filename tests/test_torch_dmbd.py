"""The whole slice: the port's DMBD against the JAX package's
(parallel_scan=True) from the same initial state, in float64 on the CPU.

The JAX model is built and run under the scoped ``jax.enable_x64``; its
state goes to the port through ``pyvbmp_tpu_torch.utils.convert``.  Both run
3 VB sweeps on the same numpy data.  Tolerances: ELBO trajectory, final role
posteriors p and latent means px.mu within max relative deviation 1e-8.
Configurations: the DMBD-Lorenz widths (obs (3,2), role_dims (1,2,1),
hidden_dims (2,2,2): K=4, h=6), and number_of_objects=2 (K=7, h=10) driven
by a control input u and a regressor r."""
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
# number_of_objects, control_dim, regression_dim
CONFIGS = {"bench": (1, 0, 0), "two_objects": (2, 1, 1)}
REPO = Path(__file__).resolve().parent.parent


def trajectories(rs):
    """Smooth, standardized random-walk observations (T, batch, 3, 2)."""
    y = np.cumsum(rs.randn(T_LEN, BATCH, 3, 2) * 0.3, 0)
    return (y - y.mean()) / y.std()


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fitted(request):
    """(JAX model after SWEEPS sweeps, port model after SWEEPS sweeps)."""
    n_obj, n_u, n_r = CONFIGS[request.param]
    rs = np.random.RandomState(n_obj)
    y = trajectories(rs)
    u = rs.randn(T_LEN, BATCH, n_u) if n_u else None
    r = rs.randn(T_LEN, BATCH, 3, n_r) if n_r else None
    with jax.enable_x64(True):
        rng.seed(n_obj)
        jm = JDMBD(obs_shape=(3, 2), role_dims=(1, 2, 1), hidden_dims=(2, 2, 2),
                   control_dim=n_u, regression_dim=n_r, number_of_objects=n_obj,
                   parallel_scan=True)
        state = dmbd_state(jm)
        jm.update(*(None if a is None else jnp.asarray(a) for a in (y, u, r)),
                  iters=SWEEPS)
        jm_p = np.asarray(jm.obs_model.p)
        jm_mu = np.asarray(jm.px.mu)
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(*(None if a is None else torch.tensor(a) for a in (y, u, r)),
              iters=SWEEPS)
    return (jm, jm_p, jm_mu), tm


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    return np.abs(port - ref).max() / np.abs(ref).max()


def test_elbo_trajectory_matches_jax(fitted):
    (jm, _, _), tm = fitted
    ref = np.asarray(jm.ELBO_save)
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    dev = np.abs(out - ref) / np.abs(ref)
    assert dev.max() <= TOL, (out, ref)
    assert (np.diff(out) > 0).all()


def test_final_posteriors_match_jax(fitted):
    (_, jm_p, jm_mu), tm = fitted
    assert rel_dev(tm.obs_model.p, jm_p) <= TOL
    assert rel_dev(tm.px.mu, jm_mu) <= TOL


def test_state_round_trips_through_numpy(fitted):
    """The state dict of a fitted port model rebuilds the same model."""
    _, tm = fitted
    again = dmbd_from_state(dmbd_state(tm), device="cpu", dtype=torch.float64)
    assert torch.equal(again.A.mu, tm.A.mu)
    assert torch.equal(again.obs_model.obs_dist.invU.invU, tm.obs_model.obs_dist.invU.invU)
    assert torch.equal(again.px.mu, tm.px.mu)
    assert torch.equal(again.obs_model.p, tm.obs_model.p)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        TDMBD((3, 2), (1, 2, 1), (2, 2, 2), parallel_scan=False)
    with pytest.raises(NotImplementedError):
        TDMBD((3, 2), (1, 2, 1), (2, 2, 2), unique_obs=True)


def test_port_imports_without_jax():
    """The port never imports jax: it imports with jax blocked."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import pyvbmp_tpu_torch\n"
        "from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery\n"
        "from pyvbmp_tpu_torch.utils import convert\n"
        "from pyvbmp_tpu_torch.simulations import Lorenz\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
