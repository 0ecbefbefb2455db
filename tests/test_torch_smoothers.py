"""The port's smoothers against the JAX package's plane-form smoothers, in
float64 on the CPU, at the widths of the DMBD-Lorenz main path (K=4 roles,
h=6) and of the two-object configuration (K=7, h=10).

The Kalman inputs are a JAX DMBD's own latent parameters and role-averaged
likelihood messages, so every potential is a proper one.  The JAX side runs
under the scoped ``jax.enable_x64``.  Tolerance: max |port - jax| / max |jax|
<= 1e-9 per output; the two differ only in association order (sequential
fold vs associative scan) and in Cholesky vs Schur inverses."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.dists import NormalInverseWishart as JNIW
from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.ops.parallel_hmm import forward_backward_parallel as jax_fb
from pyvbmp_tpu.ops.parallel_kalman import parallel_kalman_smoother as jax_kalman
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists import NormalInverseWishart as TNIW
from pyvbmp_tpu_torch.ops.parallel_hmm import forward_backward_parallel as port_fb
from pyvbmp_tpu_torch.ops.parallel_kalman import parallel_kalman_smoother as port_kalman
from pyvbmp_tpu_torch.utils.convert import load_state, node_state

TOL = 1e-9
T_LEN, BATCH = 24, 5
CONFIGS = {"bench": 1, "two_objects": 2}  # number_of_objects


def assert_rel(port, ref, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    dev = np.abs(port - ref).max() / np.abs(ref).max()
    assert dev <= TOL, f"{what}: rel dev {dev:.3e}"


def T(x):
    return torch.tensor(np.asarray(x, np.float64))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def kalman_case(request):
    """(JAX outputs, port inputs) for one Kalman smoother call."""
    rs = np.random.RandomState(CONFIGS[request.param])
    with jax.enable_x64(True):
        rng.seed(1)
        m = JDMBD(obs_shape=(3, 2), role_dims=(1, 2, 1), hidden_dims=(2, 2, 2),
                  number_of_objects=CONFIGS[request.param], parallel_scan=True)
        y, u, r = m.reshape_inputs(jnp.asarray(rs.randn(T_LEN, BATCH, 3, 2)))
        p = jnp.asarray(rs.dirichlet(np.ones(m.role_dim), (T_LEN, BATCH, 3)))
        parms = m._latent_parms(m.A)
        like = m.log_likelihood_function_role(m.obs_model.obs_dist, p, y, r)
        out = jax_kalman(parms, m.x0, like, u, plane_form=True)
        out = jax.tree_util.tree_map(np.asarray, out)
    x0 = load_state(TNIW.create((1, m.hidden_dim), (), dtype=torch.float64),
                    node_state(m.x0))
    port_in = (
        {k: T(v) for k, v in parms.items()},
        x0,
        tuple(T(v) for v in like),
        T(u),
    )
    return out, port_in


def test_kalman_smoother_matches_jax(kalman_case):
    ref, port_in = kalman_case
    out = port_kalman(*port_in)
    names = ["Sigma", "mu", "Js", "hs", "Sigma_cross", "Sigma_x0_cross",
             "Sigma_x0_x0", "mu_x0", "logZ"]
    ref_leaves = list(ref[0]) + list(ref[1:])
    out_leaves = list(out[0]) + list(out[1:])
    for name, o, r in zip(names, out_leaves, ref_leaves):
        assert_rel(o, r, name)


@pytest.mark.parametrize("K", [4, 7])
def test_hmm_smoother_matches_jax_with_masked_transitions(K):
    rs = np.random.RandomState(K)
    trans = np.log(rs.dirichlet(np.ones(K), K))
    trans[0, K - 1] = trans[K - 1, 0] = -np.inf  # masked role transitions
    init = np.log(rs.dirichlet(np.ones(K)))
    obs = rs.randn(T_LEN, BATCH, 3, K) * 3.0
    with jax.enable_x64(True):
        ref = jax_fb(jnp.asarray(trans), jnp.asarray(init), jnp.asarray(obs),
                     plane_form=True)
        ref = [np.asarray(x) for x in ref]
    out = port_fb(T(trans), T(init), T(obs))
    for name, o, r in zip(["p", "SEzz", "SEz0", "logZ"], out, ref):
        assert_rel(o, r, name)
    # the masked transitions carry exactly no pairwise mass
    assert out[1][..., 0, K - 1].abs().max() == 0.0


def test_hmm_smoother_float32_keeps_the_posteriors_at_large_logits():
    """Observation logits of order -1e4 a step (a sharp emission): the
    scanned products would grow to ~-1e6, where float32 keeps no O(1)
    differences; each step's element is shifted by its largest entry, so
    the float32 posteriors follow float64 and xi stays normalized."""
    K = 6
    rs = np.random.RandomState(0)
    trans = np.log(rs.dirichlet(np.ones(K) * 5, K))
    init = np.log(rs.dirichlet(np.ones(K)))
    obs = rs.randn(T_LEN * 8, BATCH, 3, K) * 3.0 - 1e4
    # the same float32 inputs on both sides, float64 arithmetic for ref
    ins = [T(x).float() for x in (trans, init, obs)]
    ref = port_fb(*(x.double() for x in ins))
    out = port_fb(*ins)
    assert (out[0].double() - ref[0]).abs().max() <= 1e-5
    assert (out[2].double() - ref[2]).abs().max() <= 1e-5
    assert abs(out[1].sum().item() - ref[1].sum().item()) <= 1e-6 * ref[1].sum().item()
    assert abs(out[2].sum().item() - BATCH * 3) <= 1e-5
    assert ((out[3].double() - ref[3]).abs().max() / ref[3].abs().max()).item() <= 1e-6
