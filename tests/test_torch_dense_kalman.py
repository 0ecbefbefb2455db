"""The port's dense Kalman smoother form (h > 32, or ``plane_form=False``)
against the JAX package's ``_dense_smoother``, in float64 on the CPU.

The Kalman inputs are a JAX DMBD's own latent parameters and role-averaged
likelihood messages (T=8, batch (2,)), so every potential is a proper one;
the JAX side runs under the scoped ``jax.enable_x64`` with its dense form
forced (``lane_form=False, plane_form=False``).  Tolerance: max |port - jax|
/ max |jax| <= 1e-8 per output.  Also: the default dispatch takes the dense
form at h = 33 on the CPU (no plane scan runs, plain or kernel), and one
DMBD fit at H = 33 (the smallest H above the plane form's 32) matches the
JAX package from a shared state over 2 sweeps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.ops.parallel_kalman import parallel_kalman_smoother as jax_kalman
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists import NormalInverseWishart as TNIW
from pyvbmp_tpu_torch.ops import parallel_kalman as pk
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state, load_state, node_state

TOL = 1e-8
T_LEN, BATCH = 8, 2
# hidden_dims giving h = 4 and h = 33 (role_dims (1, 1, 1), obs (3, 2))
HIDDEN = {4: (2, 1, 1), 33: (11, 11, 11)}
NAMES = ["Sigma", "mu", "Js", "hs", "Sigma_cross", "Sigma_x0_cross", "Sigma_x0_x0",
         "mu_x0", "logZ"]


def assert_rel(port, ref, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    dev = np.abs(port - ref).max() / np.abs(ref).max()
    assert dev <= TOL, f"{what}: rel dev {dev:.3e}"


def T(x):
    return torch.tensor(np.asarray(x, np.float64))


@pytest.fixture(scope="module", params=sorted(HIDDEN))
def dense_case(request):
    """(h, JAX dense outputs, port inputs) for one Kalman smoother call."""
    h = request.param
    rs = np.random.RandomState(h)
    with jax.enable_x64(True):
        rng.seed(2)
        m = JDMBD(obs_shape=(3, 2), role_dims=(1, 1, 1), hidden_dims=HIDDEN[h],
                  parallel_scan=True)
        y, u, r = m.reshape_inputs(jnp.asarray(rs.randn(T_LEN, BATCH, 3, 2)))
        p = jnp.asarray(rs.dirichlet(np.ones(m.role_dim), (T_LEN, BATCH, 3)))
        parms = m._latent_parms(m.A)
        like = m.log_likelihood_function_role(m.obs_model.obs_dist, p, y, r)
        out = jax_kalman(parms, m.x0, like, u, lane_form=False, plane_form=False)
        out = jax.tree_util.tree_map(np.asarray, out)
    x0 = load_state(TNIW.create((1, m.hidden_dim), (), dtype=torch.float64),
                    node_state(m.x0))
    port_in = ({k: T(v) for k, v in parms.items()}, x0, tuple(T(v) for v in like), T(u))
    return h, out, port_in


def test_dense_form_matches_jax(dense_case):
    h, ref, port_in = dense_case
    out = pk.parallel_kalman_smoother(*port_in, plane_form=False)
    assert out[0][0].shape[-1] == h
    for name, o, r in zip(NAMES, list(out[0]) + list(out[1:]), list(ref[0]) + list(ref[1:])):
        assert_rel(o, r, name)


def test_default_dispatch_takes_the_dense_form_above_32(dense_case, monkeypatch):
    """At h = 33 the default call runs the dense form (no plane scan, plain
    or kernel); at h = 4 it runs the plane scans.  Both agree with JAX."""
    h, ref, port_in = dense_case
    calls = []
    real = pk._dense_smoother
    monkeypatch.setattr(pk, "_dense_smoother", lambda *a: calls.append(1) or real(*a))
    plain, launches = scan.KALMAN_PLANE.plain_calls, scan.KALMAN_PLANE.launches
    out = pk.parallel_kalman_smoother(*port_in)
    assert scan.KALMAN_PLANE.launches == launches
    if h > pk.PLANE_KALMAN_MAX_H:
        assert calls == [1]
        assert scan.KALMAN_PLANE.plain_calls == plain
    else:
        assert calls == []
        assert scan.KALMAN_PLANE.plain_calls == plain + 2
    assert_rel(out[-1], ref[-1], "logZ")


@pytest.mark.parametrize("T_len", [1, 2, 3, 5, 8, 13])
def test_associative_scan_is_the_sequential_fold(T_len):
    """The odd-even scan gives the left fold (forward) and the right fold
    (reverse) of a non-commutative combine at every T, in 2 ceil(log2 T)
    combine calls at most."""
    rs = np.random.RandomState(T_len)
    mats = torch.tensor(rs.randn(T_len, 3, 2, 2))
    calls = []

    def combine(a, b):
        calls.append(1)
        return (a[0] @ b[0],)

    for reverse in (False, True):
        calls.clear()
        (out,) = pk.associative_scan(combine, (mats,), reverse=reverse)
        assert len(calls) <= 2 * int(np.ceil(np.log2(T_len))) if T_len > 1 else not calls
        for t in range(T_len):
            idx = range(t, T_len) if reverse else range(t + 1)
            want = mats[idx[0]]
            for i in list(idx)[1:]:
                want = want @ mats[i]
            assert torch.allclose(out[t], want, rtol=1e-12, atol=1e-12)


def test_dmbd_fit_above_32_matches_jax():
    """DMBD at H = 33 (hidden_dims (11, 11, 11), T=8, batch 2) with the scan
    smoothers: the port's dense form against the JAX package's (its test
    settings send every h to the dense form), 2 sweeps from one state."""
    rs = np.random.RandomState(5)
    y = rs.randn(T_LEN, BATCH, 3, 2)
    with jax.enable_x64(True):
        rng.seed(5)
        jm = JDMBD(obs_shape=(3, 2), role_dims=(1, 1, 1), hidden_dims=HIDDEN[33],
                   parallel_scan=True)
        state = dmbd_state(jm)
        jm.update(jnp.asarray(y), iters=2)
        ref_elbo = np.asarray(jm.ELBO_save)
        ref_mu = np.asarray(jm.px.mu)
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    plain = scan.KALMAN_PLANE.plain_calls
    tm.update(torch.tensor(y), iters=2)
    assert scan.KALMAN_PLANE.plain_calls == plain
    dev = np.abs(np.asarray(tm.ELBO_save) - ref_elbo) / np.abs(ref_elbo)
    assert dev.max() <= TOL, (tm.ELBO_save, ref_elbo)
    assert_rel(tm.px.mu, ref_mu, "px.mu")
