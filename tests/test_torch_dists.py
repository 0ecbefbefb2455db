"""The port's distributions, transforms and numerics helpers against the JAX
package, in float64 on the CPU.

Each JAX node is built under ``jax.enable_x64`` (scoped: it does not leak
into other test files) and its state copied into the port's node with
``pyvbmp_tpu_torch.utils.convert``; the same numpy inputs then go through
both.  Updates run with lr < 1 so the damping is exercised.  Tolerance:
max |port - jax| / max |jax| <= 1e-10 per output (the two sides differ in
association order and in Cholesky vs Schur inverses only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import dists as jd
from pyvbmp_tpu import transforms as jt
from pyvbmp_tpu.dists.mvn_vector_format import MultivariateNormal_vector_format as JMVN
from pyvbmp_tpu.models.dmbd import one_object_mask
from pyvbmp_tpu.utils import jaxutils as jju
from pyvbmp_tpu.utils import linalg as jla
from pyvbmp_tpu.utils import math as jum
from pyvbmp_tpu_torch import dists as td
from pyvbmp_tpu_torch import transforms as tt
from pyvbmp_tpu_torch.dists.mvn_vector_format import MultivariateNormal_vector_format as TMVN
from pyvbmp_tpu_torch.utils import linalg as tla
from pyvbmp_tpu_torch.utils import math as tum
from pyvbmp_tpu_torch.utils import torchutils as ttu
from pyvbmp_tpu_torch.utils.convert import load_state, node_state

TOL = 1e-10
LR = 0.7


def np64(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x, np.float64)


def assert_rel(port, ref, tol=TOL, what=""):
    port, ref = np64(port), np64(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    inf = np.isinf(ref)
    assert np.array_equal(np.isinf(port), inf), what
    assert np.array_equal(port[inf], ref[inf]), what
    fin = ~inf
    if not fin.any():
        return
    scale = max(np.abs(ref[fin]).max(), 1e-300)
    dev = np.abs(port[fin] - ref[fin]).max() / scale
    assert dev <= tol, f"{what}: rel dev {dev:.3e}"


def assert_tree(port_node, jax_node):
    """Every array field of the two nodes agrees."""

    def walk(p, j, path):
        for k, v in j.items():
            if k not in p or v is None or k == "mask":
                continue
            if isinstance(v, dict):
                walk(p[k], v, f"{path}.{k}")
            elif v.dtype != bool:
                assert_rel(p[k], v, what=f"{path}.{k}")

    walk(node_state(port_node), node_state(jax_node), type(port_node).__name__)


def spd(rs, shape, d):
    W = rs.randn(*shape, d, d)
    return np.einsum("...ij,...kj->...ik", W, W) / d + np.eye(d)


def pair(jax_create, port_create):
    """The JAX node (built in x64) and the port node holding its state."""
    with jax.enable_x64(True):
        j = jax_create()
    return j, load_state(port_create(), node_state(j))


def x64(fn, *args):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(np.asarray, fn(*args))


def T(x):
    return torch.as_tensor(np.ascontiguousarray(x, np.float64))


# ------------------------------------------------------------------- helpers
def _cases_utils():
    rs = np.random.RandomState(0)
    x = rs.randn(5, 4, 3)
    x[0, 1] = -np.inf  # an all -inf slice
    A = spd(rs, (3,), 4)
    B = rs.randn(3, 4, 2)
    nu = 3.0 + rs.rand(4)
    M = rs.randn(4, 3, 3)
    p = rs.dirichlet(np.ones(4), (6, 2))
    X = rs.randn(6, 2, 1, 3)
    W = spd(rs, (4,), 3)
    g = np.array([0.0, 0.5, 2.0, 7.5])
    Xb = rs.randn(6, 1, 3, 3)
    return {
        "stable_logsumexp": (lambda: jum.stable_logsumexp(jnp.asarray(x), (-1,)),
                             lambda: tum.stable_logsumexp(T(x), (-1,))),
        "stable_logsumexp_multi": (lambda: jum.stable_logsumexp(jnp.asarray(x), (-1, -2), keepdims=True),
                                   lambda: tum.stable_logsumexp(T(x), (-1, -2), keepdim=True)),
        "mvgammaln": (lambda: jum.mvgammaln(jnp.asarray(nu), 3),
                      lambda: tum.mvgammaln(T(nu), 3)),
        "mvdigamma": (lambda: jum.mvdigamma(jnp.asarray(nu), 3),
                      lambda: tum.mvdigamma(T(nu), 3)),
        "lgamma_masked": (lambda: jum.lgamma_masked(jnp.asarray(g)),
                          lambda: tum.lgamma_masked(T(g))),
        "digamma_masked": (lambda: jum.digamma_masked(jnp.asarray(g)),
                           lambda: tum.digamma_masked(T(g))),
        "psd_inv_and_logdet": (lambda: jla.psd_inv_and_logdet(jnp.asarray(A)),
                               lambda: tla.psd_inv_and_logdet(T(A))),
        "psd_solve": (lambda: jla.psd_solve(jnp.asarray(A), jnp.asarray(B)),
                      lambda: tla.psd_solve(T(A), T(B))),
        "psd_logdet": (lambda: jla.psd_logdet(jnp.asarray(A)),
                       lambda: tla.psd_logdet(T(A))),
        "block_diag_matrix_builder": (
            lambda: jla.block_diag_matrix_builder(jnp.asarray(A), jnp.asarray(A[:, :2, :2])),
            lambda: tla.block_diag_matrix_builder(T(A), T(A[:, :2, :2]))),
        "block_precision_marginalizer": (
            lambda: jla.block_precision_marginalizer(
                jnp.asarray(A), jnp.asarray(B[..., :2] * 0.1),
                jnp.asarray(np.swapaxes(B[..., :2], -1, -2) * 0.1), jnp.asarray(A[:, :2, :2])),
            lambda: tla.block_precision_marginalizer(
                T(A), T(B[..., :2] * 0.1), T(np.swapaxes(B[..., :2], -1, -2) * 0.1),
                T(A[:, :2, :2]))),
        "brole_avg": (lambda: jju.brole_avg(jnp.asarray(M), jnp.asarray(p)),
                      lambda: ttu.brole_avg(T(M), T(p))),
        "bquad": (lambda: jju.bquad(jnp.asarray(X[..., 0, :][:, :, None, :]), jnp.asarray(W)),
                  lambda: ttu.bquad(T(X[..., 0, :][:, :, None, :]), T(W))),
        "bcontract_pp": (lambda: jju.bcontract_pp(jnp.asarray(Xb), jnp.asarray(W)),
                         lambda: ttu.bcontract_pp(T(Xb), T(W))),
        "centered_scatter": (lambda: jju.centered_scatter(jnp.asarray(X[:, :, 0] + 30.0), None, (0,)),
                             lambda: ttu.centered_scatter(T(X[:, :, 0] + 30.0), None, (0,))[:2]),
        "centered_scatter_weighted": (
            lambda: jju.centered_scatter(jnp.asarray(X[:, :, 0]), jnp.asarray(p[..., :1]), (0,)),
            lambda: ttu.centered_scatter(T(X[:, :, 0]), T(p[..., :1]), (0,))),
        "sum_leading": (lambda: jju.sum_leading(jnp.asarray(M), 2),
                        lambda: ttu.sum_leading(T(M), 2)),
        "damp": (lambda: jju.damp(jnp.asarray(M), jnp.asarray(M[::-1]), LR),
                 lambda: ttu.damp(T(M), T(M[::-1]), LR)),
    }


UTILS = _cases_utils()


@pytest.mark.parametrize("name", sorted(UTILS))
def test_helpers_match_jax(name):
    jax_fn, port_fn = UTILS[name]
    ref = x64(jax_fn)
    out = port_fn()
    for o, r in zip(*(x if isinstance(x, tuple) else (x,) for x in (out, ref))):
        assert_rel(o, r, what=name)


# --------------------------------------------------------------------- dists
def test_gamma():
    rs = np.random.RandomState(2)
    j, t = pair(lambda: jd.Gamma.create((3,), (2,), key=jax.random.key(0)),
                lambda: td.Gamma.create((3,), (2,), dtype=torch.float64))
    a, b = rs.rand(2, 3) * 4, rs.rand(2, 3) * 5
    with jax.enable_x64(True):
        j2 = j.ss_update(jnp.asarray(a), jnp.asarray(b), lr=LR)
        ref = [np.asarray(f()) for f in (j2.KLqprior, j2.mean, j2.meaninv, j2.loggeomean)]
    t2 = t.ss_update(T(a), T(b), lr=LR)
    assert_tree(t2, j2)
    for o, r in zip((t2.KLqprior(), t2.mean(), t2.meaninv(), t2.loggeomean()), ref):
        assert_rel(o, r)


def test_diagonal_wishart():
    rs = np.random.RandomState(3)
    j, t = pair(lambda: jd.DiagonalWishart.create((1, 4), (), key=jax.random.key(1)),
                lambda: td.DiagonalWishart.create((1, 4), (), dtype=torch.float64))
    S, N = rs.rand(1, 4) * 10, np.full((1, 1), 7.0)
    with jax.enable_x64(True):
        j2 = j.ss_update(jnp.asarray(S), jnp.asarray(N), lr=LR)
        ref = [np.asarray(f()) for f in (j2.KLqprior, j2.EinvSigma, j2.ESigma,
                                         j2.ElogdetinvSigma, j2.mean)]
    t2 = t.ss_update(T(S), T(N), lr=LR)
    assert_tree(t2, j2)
    for o, r in zip((t2.KLqprior(), t2.EinvSigma(), t2.ESigma(),
                     t2.ElogdetinvSigma(), t2.mean()), ref):
        assert_rel(o, r)


def test_dirichlet_with_masked_transitions():
    """Zero prior mass (a role mask) gives -inf log-means and a finite KL."""
    rs = np.random.RandomState(4)
    _, _, role_mask = one_object_mask((2, 2, 2), (1, 2, 1), 1, 2, 1)
    alpha = (np.eye(4) + 0.5) * role_mask
    j, t = pair(
        lambda: jd.Dirichlet.create((4,), (4,), prior_parms={"alpha": jnp.asarray(alpha)},
                                    key=jax.random.key(2)),
        lambda: td.Dirichlet.create((4,), (4,), prior_parms={"alpha": T(alpha)},
                                    dtype=torch.float64),
    )
    NA = rs.rand(4, 4) * 20 * role_mask
    with jax.enable_x64(True):
        j2 = j.ss_update(jnp.asarray(NA), lr=LR)
        ref = [np.asarray(f()) for f in (j2.KLqprior, j2.loggeomean, j2.mean)]
    t2 = t.ss_update(T(NA), lr=LR)
    assert_tree(t2, j2)
    out = (t2.KLqprior(), t2.loggeomean(), t2.mean())
    assert np.isneginf(np64(out[1])).sum() == (role_mask == 0).sum()
    assert np.isfinite(np64(out[0])).all()
    for o, r in zip(out, ref):
        assert_rel(o, r)


def test_wishart():
    rs = np.random.RandomState(5)
    j, t = pair(lambda: jd.Wishart.create((3, 3), (2,)),
                lambda: td.Wishart.create((3, 3), (2,), dtype=torch.float64))
    S, N = spd(rs, (2,), 3) * 5, np.array([4.0, 9.0])
    with jax.enable_x64(True):
        j2 = j.ss_update(jnp.asarray(S), jnp.asarray(N), lr=LR)
        ref = [np.asarray(f()) for f in (j2.KLqprior, j2.EinvSigma, j2.ESigma,
                                         j2.ElogdetinvSigma)]
    t2 = t.ss_update(T(S), T(N), lr=LR)
    assert_tree(t2, j2)
    for o, r in zip((t2.KLqprior(), t2.EinvSigma(), t2.ESigma(),
                     t2.ElogdetinvSigma()), ref):
        assert_rel(o, r)


def test_normal_inverse_wishart():
    rs = np.random.RandomState(6)
    j, t = pair(lambda: jd.NormalInverseWishart.create((1, 4), (), key=jax.random.key(3)),
                lambda: td.NormalInverseWishart.create((1, 4), (), dtype=torch.float64))
    SExx, SEx, N = spd(rs, (1,), 4) * 3, rs.randn(1, 4), np.array([3.0])
    X = rs.randn(7, 1, 4) + 5.0
    p = rs.rand(7)
    with jax.enable_x64(True):
        j2 = j.ss_update(jnp.asarray(SExx), jnp.asarray(SEx), jnp.asarray(N), lr=LR)
        j3 = j2.raw_update(jnp.asarray(X), lr=LR)
        j4 = j2.raw_update(jnp.asarray(X), p=jnp.asarray(p), lr=LR)
        ref = [np.asarray(f()) for f in (j2.KLqprior, j2.EinvSigmamu, j2.EXTinvUX,
                                         j2.ElogdetinvSigma, j2.EinvSigma)]
        ref_ll = np.asarray(j2.Elog_like(jnp.asarray(X)))
    t2 = t.ss_update(T(SExx), T(SEx), T(N), lr=LR)
    assert_tree(t2, j2)
    assert_tree(t2.raw_update(T(X), lr=LR), j3)
    assert_tree(t2.raw_update(T(X), p=T(p), lr=LR), j4)
    for o, r in zip((t2.KLqprior(), t2.EinvSigmamu(), t2.EXTinvUX(),
                     t2.ElogdetinvSigma(), t2.EinvSigma()), ref):
        assert_rel(o, r)
    assert_rel(t2.Elog_like(T(X)), ref_ll)


def test_mvn_vector_format_and_delta():
    rs = np.random.RandomState(7)
    J, h = spd(rs, (5,), 3), rs.randn(5, 3, 1)
    Y = rs.randn(5, 2, 1)
    names = ("mean", "ESigma", "EXXT", "Res", "ElogdetinvSigma", "EinvSigmamu")
    with jax.enable_x64(True):
        m = JMVN(invSigma=jnp.asarray(J), invSigmamu=jnp.asarray(h))
        ref = [np.asarray(getattr(m, k)()) for k in names]
        mS = JMVN(mu=jnp.asarray(h), Sigma=jnp.asarray(J))
        ref += [np.asarray(mS.EinvSigma()), np.asarray(mS.EinvSigmamu())]
        ref_d = np.asarray(jd.Delta(jnp.asarray(Y)).EXXT())
    t = TMVN(invSigma=T(J), invSigmamu=T(h))
    out = [getattr(t, k)() for k in names]
    tS = TMVN(mu=T(h), Sigma=T(J))
    out += [tS.EinvSigma(), tS.EinvSigmamu()]
    for o, r in zip(out, ref):
        assert_rel(o, r)
    assert_rel(td.Delta(T(Y)).EXXT(), ref_d)
    assert TMVN(mu=T(h)).unsqueeze(-3).shape == (5, 1, 3, 1)


# ---------------------------------------------------------------- transforms
def _messages(rs, S, roles, p1, p2, n):
    """pX (a spliced Gaussian message as ARHMM_prXRY builds it), Y, and role
    weights p over S samples."""
    J = spd(rs, (S, 1), p1)
    mu = np.concatenate([rs.randn(S, 1, p1, 1), np.ones((S, 1, p2, 1))], -2)
    Sigma = np.zeros((S, 1, p1 + p2, p1 + p2))
    Sigma[..., :p1, :p1] = np.linalg.inv(J)
    Y = rs.randn(S, 1, n, 1)
    p = rs.dirichlet(np.ones(roles), S)
    return mu, Sigma, Y, p


def test_matrix_normal_wishart_emission():
    """DMBD's emission: X_mask, message-valued update with p and lr, the
    likelihood messages and the KL."""
    rs = np.random.RandomState(8)
    _, B_mask, _ = one_object_mask((2, 2, 2), (1, 2, 1), 1, 2, 1)
    X_mask = B_mask.sum(-2, keepdims=True) > 0  # (4, 1, 7)
    j, t = pair(
        lambda: jt.MatrixNormalWishart.create((2, 7), (4,), X_mask=jnp.asarray(X_mask),
                                              key=jax.random.key(4)),
        lambda: tt.MatrixNormalWishart.create((2, 7), (4,), X_mask=X_mask,
                                              dtype=torch.float64),
    )
    assert_tree(t, j)
    mu, Sigma, Y, p = _messages(rs, 9, 4, 6, 1, 2)
    with jax.enable_x64(True):
        pX, pY = JMVN(mu=jnp.asarray(mu), Sigma=jnp.asarray(Sigma)), jd.Delta(jnp.asarray(Y))
        j2 = j.update(pX, pY, p=jnp.asarray(p), lr=LR)
        ref = [np.asarray(x) for x in (
            j2.KLqprior(), j2.Elog_like_given_pX_pY(pX, pY), *j2.Elog_like_X(jnp.asarray(Y)),
            j2.EinvUX(), j2.EXTinvUX(), j2.EXTinvU(), j2.ElogdetinvSigma())]
    pXt, pYt = TMVN(mu=T(mu), Sigma=T(Sigma)), td.Delta(T(Y))
    t2 = t.update(pXt, pYt, p=T(p), lr=LR)
    assert_tree(t2, j2)
    out = (t2.KLqprior(), t2.Elog_like_given_pX_pY(pXt, pYt), *t2.Elog_like_X(T(Y)),
           t2.EinvUX(), t2.EXTinvUX(), t2.EXTinvU(), t2.ElogdetinvSigma())
    for o, r in zip(out, ref):
        assert_rel(o, r)


def test_matrix_normal_gamma_dynamics():
    """The LDS dynamics A: mask-constrained ss_update with lr, KL and the
    expectations _latent_parms reads."""
    rs = np.random.RandomState(9)
    A_mask, _, _ = one_object_mask((2, 2, 2), (1, 2, 1), 1, 2, 1)  # (6, 7)
    j, t = pair(
        lambda: jt.MatrixNormalGamma.create((1, 6, 7), (), mask=A_mask, pad_X=False,
                                            key=jax.random.key(5)),
        lambda: tt.MatrixNormalGamma.create((1, 6, 7), (), mask=A_mask, dtype=torch.float64),
    )
    assert_tree(t, j)
    SExx = spd(rs, (1,), 7) * 20
    SEyx = rs.randn(1, 6, 7) * 5
    SEyy = spd(rs, (1,), 6) * 20
    N = np.array([19.0])
    with jax.enable_x64(True):
        j2 = j.ss_update(*(jnp.asarray(a) for a in (SExx, SEyx, SEyy, N)), lr=LR)
        ref = [np.asarray(x) for x in (
            j2.KLqprior(), j2.EinvSigma(), j2.EXTinvUX(), j2.EinvUX(), j2.ElogdetinvSigma())]
    t2 = t.ss_update(*(T(a) for a in (SExx, SEyx, SEyy, N)), lr=LR)
    assert_tree(t2, j2)
    assert (np64(t2.mu)[0][~A_mask] == 0).all()
    out = (t2.KLqprior(), t2.EinvSigma(), t2.EXTinvUX(), t2.EinvUX(), t2.ElogdetinvSigma())
    for o, r in zip(out, ref):
        assert_rel(o, r)


def test_node_to_moves_every_tensor():
    t = tt.MatrixNormalGamma.create((1, 3, 4), (), mask=np.ones((3, 4), bool),
                                    dtype=torch.float64)
    t32 = t.to(dtype=torch.float32)
    assert t32.mu.dtype == torch.float32
    assert t32.invU.gamma.alpha.dtype == torch.float32
    assert t32.mask is t.mask
