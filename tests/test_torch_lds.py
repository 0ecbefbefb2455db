"""The port's linear dynamical systems against the JAX package's, in float64
on the CPU.

The JAX side runs under the scoped ``jax.enable_x64``; its state goes to the
port through ``pyvbmp_tpu_torch.utils.convert`` and both run on the same
numpy data.  Tolerance: max relative deviation 1e-8 for every compared
output.

- ``parallel_kalman_smoother`` in lane form at h = 1, 2, 3 with batch shape
  (b, K), control and regression inputs (all returns), and the port's lane
  form against its own plane form at h = 2;
- ``MixtureofLinearDynamicalSystems(3, (3,), 2, 0, 0, parallel_scan=True)``
  at T=20, batch=6, 3 sweeps: ELBO trajectory, p, logZ and, after
  ``update_latents``, ``lds.px.mu``;
- ``LinearDynamicalSystems`` at its defaults (the sequential smoother with
  ``cross_cov_compat=True``) at h=3 with controls and regressors, with
  ``latent_noise="shared"`` at h=1, and with ``parallel_scan=True`` at h=2
  with A and B masks: ELBO trajectory (an ``iters=1`` update, then an
  ``iters=2`` one) and the smoothed means."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import LinearDynamicalSystems as JLDS
from pyvbmp_tpu.models import MixtureofLinearDynamicalSystems as JMixLDS
from pyvbmp_tpu.ops.parallel_kalman import parallel_kalman_smoother as jax_kalman
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.models import LinearDynamicalSystems as TLDS
from pyvbmp_tpu_torch.models import MixtureofLinearDynamicalSystems as TMixLDS
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.ops.parallel_kalman import parallel_kalman_smoother as port_kalman
from pyvbmp_tpu_torch.utils.convert import (
    lds_from_state, lds_state, mixlds_from_state, mixlds_state,
)

TOL = 1e-8
T_LEN, BATCH, SWEEPS = 20, 6, 3
REPO = Path(__file__).resolve().parent.parent
SMOOTHER_NAMES = ["Sigma", "mu", "Js", "hs", "Sigma_cross", "Sigma_x0_cross",
                  "Sigma_x0_x0", "mu_x0", "logZ"]


def rel_dev(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    return np.abs(port - ref).max() / np.abs(ref).max()


def trajectories(rs, T=T_LEN, B=BATCH, o=3):
    """Smooth standardized random-walk observations (T, B, o)."""
    y = np.cumsum(rs.randn(T, B, o) * 0.3, 0)
    return (y - y.mean()) / y.std()


def T64(x):
    return torch.tensor(np.asarray(x, np.float64))


def opt(x, f):
    return None if x is None else f(x)


# ------------------------------------------------------------------ smoother
@pytest.fixture(scope="module", params=[1, 2, 3])
def smoother_case(request):
    """(JAX lane-form outputs, port inputs) at hidden dim h: the inputs are a
    JAX LDS's own latent parameters and likelihood messages for a (b, K)
    batch with control and regression inputs."""
    h = request.param
    rs = np.random.RandomState(h)
    y = trajectories(rs)
    u, r = rs.randn(T_LEN, BATCH, 1), rs.randn(T_LEN, BATCH, 2)
    with jax.enable_x64(True):
        rng.seed(h)
        m = JLDS((3,), h, control_dim=1, regression_dim=2, batch_shape=(4,),
                 parallel_scan=True, cross_cov_compat=False)
        m.expand_to_batch = True
        state = lds_state(m)
        yv, uv, rv = m.reshape_inputs(*(jnp.asarray(a) for a in (y, u, r)))
        parms = m._latent_parms(m.A)
        like = m.log_likelihood_function(m.obs_model, yv, rv)
        out = jax_kalman(parms, m.x0, like, uv, lane_form=True)
        out = jax.tree_util.tree_map(np.asarray, out)
    port_in = (
        {k: T64(v) for k, v in parms.items()},
        lds_from_state(state, "cpu").x0,
        tuple(T64(v) for v in like),
        T64(uv),
    )
    return h, out, port_in


def test_lane_smoother_matches_jax(smoother_case):
    h, ref, port_in = smoother_case
    calls = scan.KALMAN_LANE.plain_calls
    out = port_kalman(*port_in)
    assert scan.KALMAN_LANE.plain_calls == calls + 2  # the lane form ran
    assert out[0][0].shape == (T_LEN, BATCH, 4, h, h)
    for name, o, r in zip(SMOOTHER_NAMES, list(out[0]) + list(out[1:]),
                          list(ref[0]) + list(ref[1:])):
        assert rel_dev(o, r, name) <= TOL, name


@pytest.mark.parametrize("smoother_case", [2], indirect=True)
def test_lane_form_matches_plane_form(smoother_case):
    _, _, port_in = smoother_case
    lane = port_kalman(*port_in, lane_form=True)
    plane = port_kalman(*port_in, plane_form=True)
    for name, o, r in zip(SMOOTHER_NAMES, list(lane[0]) + list(lane[1:]),
                          list(plane[0]) + list(plane[1:])):
        assert rel_dev(o, r.numpy(), name) <= TOL, name


def test_smoother_form_gates(smoother_case):
    """Both layouts off takes the dense form (no lane or plane scan), which
    matches the JAX lane-form outputs."""
    h, ref, port_in = smoother_case
    calls = (scan.KALMAN_LANE.plain_calls, scan.KALMAN_PLANE.plain_calls)
    out = port_kalman(*port_in, lane_form=False, plane_form=False)
    assert (scan.KALMAN_LANE.plain_calls, scan.KALMAN_PLANE.plain_calls) == calls
    for name, o, r in zip(SMOOTHER_NAMES, list(out[0]) + list(out[1:]),
                          list(ref[0]) + list(ref[1:])):
        assert rel_dev(o, r, name) <= TOL, name


# -------------------------------------------------------------------- MixLDS
@pytest.fixture(scope="module")
def mixlds_fitted():
    rs = np.random.RandomState(0)
    y = trajectories(rs)
    with jax.enable_x64(True):
        rng.seed(0)
        jm = JMixLDS(3, (3,), 2, 0, 0, parallel_scan=True)
        state = mixlds_state(jm)
        jy = jnp.asarray(y)
        jm.update(jy, iters=SWEEPS)
        jm.lds.update_latents(*jm.lds.reshape_inputs(jy))
        ref = dict(ELBO=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   logZ=np.asarray(jm.logZ), mu=np.asarray(jm.lds.px.mu))
    tm = mixlds_from_state(state, device="cpu", dtype=torch.float64)
    ty = torch.tensor(y)
    calls = scan.KALMAN_LANE.plain_calls
    tm.update(ty, iters=SWEEPS)
    sweep_calls = scan.KALMAN_LANE.plain_calls - calls
    tm.lds.update_latents(*tm.lds.reshape_inputs(ty))
    return ref, tm, sweep_calls


def test_mixlds_matches_jax(mixlds_fitted):
    ref, tm, sweep_calls = mixlds_fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref["ELBO"]) / np.abs(ref["ELBO"])).max() <= TOL
    assert (np.diff(out) > 0).all()
    assert rel_dev(tm.p, ref["p"], "p") <= TOL
    assert rel_dev(tm.logZ, ref["logZ"], "logZ") <= TOL
    assert rel_dev(tm.lds.px.mu, ref["mu"], "px.mu") <= TOL
    # one smoother pass per sweep: a prefix and a suffix lane scan each
    assert sweep_calls == 2 * SWEEPS


def test_mixlds_assignments(mixlds_fitted):
    _, tm, _ = mixlds_fitted
    p = tm.assignment_pr()
    assert p.shape == (BATCH, 3)
    assert torch.allclose(p.sum(-1), torch.ones(BATCH, dtype=p.dtype))
    assert torch.equal(tm.assignment(), p.argmax(-1))
    assert torch.allclose(tm.NA, p.sum(0))
    assert tm.KLqprior().shape == ()


def test_mixlds_state_round_trips(mixlds_fitted):
    _, tm, _ = mixlds_fitted
    again = mixlds_from_state(mixlds_state(tm), device="cpu", dtype=torch.float64)
    assert torch.equal(again.lds.A.mu, tm.lds.A.mu)
    assert torch.equal(again.lds.obs_model.invU.invU, tm.lds.obs_model.invU.invU)
    assert torch.equal(again.pi.alpha, tm.pi.alpha)
    assert torch.equal(again.p, tm.p)


# ----------------------------------------------------------------------- LDS
# name: (hidden_dim, control_dim, regression_dim, constructor keywords);
# the first two run at the defaults (the sequential smoother)
LDS_CONFIGS = {
    "seq_h3_u_r": (3, 2, 1, {}),
    "shared_h1": (1, 0, 0, dict(latent_noise="shared")),
    "parallel_h2_masks": (2, 0, 0, dict(
        parallel_scan=True, cross_cov_compat=False,
        A_mask=[[1, 1], [0, 1]], B_mask=[[1, 0], [1, 1], [0, 1]])),
}


@pytest.fixture(scope="module", params=sorted(LDS_CONFIGS))
def lds_fitted(request):
    h, n_u, n_r, kw = LDS_CONFIGS[request.param]
    rs = np.random.RandomState(h)
    y = trajectories(rs, B=4)
    u = rs.randn(T_LEN, 4, n_u) if n_u else None
    r = rs.randn(T_LEN, 4, n_r) if n_r else None
    with jax.enable_x64(True):
        rng.seed(h + 10)
        jm = JLDS((3,), h, control_dim=n_u, regression_dim=n_r, **kw)
        state = lds_state(jm)
        args = [opt(a, jnp.asarray) for a in (y, u, r)]
        jm.update(*args, iters=1)
        jm.update(*args, iters=SWEEPS - 1)
        ref = dict(ELBO=np.asarray(jm.ELBO_save), mu=np.asarray(jm.px.mu),
                   ELBO_now=np.asarray(jm.ELBO()))
    tm = lds_from_state(state, device="cpu", dtype=torch.float64)
    parallel = kw.get("parallel_scan", False)
    assert tm.parallel_scan == parallel and tm.cross_cov_compat == (not parallel)
    args = [opt(a, torch.tensor) for a in (y, u, r)]
    plain = scan.KALMAN_LANE.plain_calls
    tm.update(*args, iters=1)
    tm.update(*args, iters=SWEEPS - 1)
    # iters=n runs n + 1 smoother passes when n > 1 (the final posterior is
    # recomputed), two lane scans each; the sequential smoother runs none
    passes = 1 + SWEEPS if parallel else 0
    assert scan.KALMAN_LANE.plain_calls - plain == 2 * passes
    return ref, tm


def test_lds_matches_jax(lds_fitted):
    ref, tm = lds_fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref["ELBO"]) / np.abs(ref["ELBO"])).max() <= TOL
    assert rel_dev(tm.px.mu, ref["mu"], "px.mu") <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO_now"], "ELBO()") <= TOL


def test_lds_state_round_trips(lds_fitted):
    _, tm = lds_fitted
    again = lds_from_state(lds_state(tm), device="cpu", dtype=torch.float64)
    assert type(again.A) is type(tm.A)
    assert torch.equal(again.A.mu, tm.A.mu)
    assert torch.equal(again.x0.mu, tm.x0.mu)
    assert torch.equal(again.px.mu, tm.px.mu)


def test_lds_split_estep_mstep_matches_update():
    """update_latents + ss_update is the latent half of one update sweep."""
    rs = np.random.RandomState(5)
    y = torch.tensor(trajectories(rs, B=3))
    a = TLDS((3,), 2, generator=torch.Generator().manual_seed(1), dtype=torch.float64,
             device="cpu")
    b = TLDS((3,), 2, generator=torch.Generator().manual_seed(1), dtype=torch.float64,
             device="cpu")
    a.update(y)
    b.update_latents(*b.reshape_inputs(y))
    b.ss_update()
    assert torch.allclose(a.A.mu, b.A.mu, rtol=1e-12, atol=1e-12)
    assert torch.allclose(a.x0.mu, b.x0.mu, rtol=1e-12, atol=1e-12)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="time_mesh"):
        TLDS((3,), 2, time_mesh=object())
    with pytest.raises(NotImplementedError, match="time_mesh"):
        TMixLDS(3, (3,), 2, 0, 0, time_mesh=object())


def test_lds_modules_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from pyvbmp_tpu_torch.models import LinearDynamicalSystems, "
        "MixtureofLinearDynamicalSystems\n"
        "from pyvbmp_tpu_torch.ops import smallmat, parallel_kalman\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
