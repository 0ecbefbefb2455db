"""The transform shells of this slice against the JAX package's, in float64
on the CPU: each JAX object is built under the scoped ``jax.enable_x64``,
its state reaches the port through ``pyvbmp_tpu_torch.utils.convert``, and
both run the same updates on the same numpy data (made from a seed).
Tolerance: max |port - jax| / max |jax| <= 1e-8 for every compared output.

- TensorNormalWishart (3, 4): 3 updates, the modes' precisions, the scale,
  the KL and the likelihood; the Kronecker recovery of
  ``tests/test_transforms_misc.py``;
- MultiLinearNormalWishart(3, [2, 4]) with Wishart and Gamma noise:
  3 updates, ``Elog_like``, ``predict``, ``forward``, ``postdict``, the KL;
  the JAX test's recovery;
- ReducedRankRegression(6, 5, 2): 3 sweeps, q(u), ``predict``, ``EW``; the
  JAX test's recovery;
- MixtureofLinearTransforms (Wishart and Gamma experts): 3 sweeps,
  ``predict``, the message-valued ``update`` and the expert averages; the
  JAX test's recovery;
- dMixture (NormalInverseWishart components, MNLR gate): 3 sweeps; the JAX
  test's recovery (``tests/test_untested_components.py``);
- NLRegression_full_rank, _low_rank and _orig: 3 sweeps and ``predict``;
  the JAX test's fit on the piecewise-linear task;
- dMixtureofLinearTransforms with ``type="Gamma"`` experts: 3 sweeps and
  ``predict``.

The recovery checks run the port (float64) from the initial state of the
JAX model built as the JAX tests build it (float32, the same seed) and
assert what the JAX tests assert.
The same shells on the card against the CPU: ``chip_smoke.py`` phases
31-34; dMixture's scatter launches: ``tests/test_torch_kernels.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import dists as JD
from pyvbmp_tpu import transforms as JT
from pyvbmp_tpu.dists.mvn_vector_format import MultivariateNormal_vector_format as JMVN_vf
from pyvbmp_tpu.transforms.dmixture import dMixture as JdMixture
from pyvbmp_tpu.transforms.nl_regression import NLRegression_orig as JNLRorig
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu.utils.jaxutils import replace as jreplace
from pyvbmp_tpu_torch import dists as PD
from pyvbmp_tpu_torch.dists.mvn_vector_format import MultivariateNormal_vector_format as TMVN_vf
from pyvbmp_tpu_torch.ops import weighted_scatter as ws
from pyvbmp_tpu_torch.utils import convert

TOL = 1e-8


def rel_dev(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    scale = np.abs(ref).max()
    return np.abs(port - ref).max() / scale if scale > 0 else np.abs(port).max()


def T64(x):
    return torch.tensor(np.asarray(x, np.float64))


def compare(out, ref):
    assert out.keys() == ref.keys()
    for k in ref:
        assert rel_dev(out[k], ref[k], k) <= TOL, k


def numpy(d):
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in d.items()}


def parity(make_jax, to_state, from_state, run, data):
    """``run(model, A, data)`` -> dict of outputs, on the JAX model (under
    x64) and on the port's copy of its initial state."""
    with jax.enable_x64(True):
        rng.seed(3)
        jm = make_jax()
        state = to_state(jm)
        ref = numpy(run(jm, jnp.asarray, [jnp.asarray(d) for d in data]))
    tm = from_state(state, "cpu")
    compare(numpy(run(tm, T64, [T64(d) for d in data])), ref)
    return state


def _piecewise_linear(key=0, ns=400):
    rs = np.random.RandomState(key)
    X = rs.rand(ns, 1) * 4 - 2
    Y = np.where(X < 0, 2 * X + 1, -X + 1) + 0.05 * rs.randn(ns, 1)
    return X, Y


# --------------------------------------------------------- TensorNormalWishart
def _kron_data(ns):
    rs = np.random.RandomState(6)
    d1, d2 = 3, 4
    L1 = rs.randn(d1, d1) * 0.3 + np.eye(d1)
    L2 = rs.randn(d2, d2) * 0.3 + np.eye(d2)
    X = np.einsum("ab,nbc,dc->nad", L1, rs.randn(ns, d1, d2), L2)
    return X, np.kron(L1 @ L1.T, L2 @ L2.T)


def test_tensor_normal_wishart_matches_jax():
    X, _ = _kron_data(300)

    def run(m, A, data):
        m = m.raw_update(data[0], iters=2).raw_update(data[0], lr=0.7)
        out = dict(mu=m.mu, lambda_mu=m.lambda_mu, ESigma=m.ESigma(),
                   EinvSigma=m.EinvSigma(), EinvSigma_0=m.EinvSigma([0]),
                   ElogdetinvSigmas=m.ElogdetinvSigmas(), ElogdetinvSigma=m.ElogdetinvSigma(),
                   KL=m.KLqprior(), like=m.Elog_like(data[0][:20]),
                   alpha=m.alpha.alpha, beta=m.alpha.beta)
        out.update({f"nu{i}": w.nu for i, w in enumerate(m.invU)})
        return out

    parity(lambda: JD.TensorNormalWishart.create((3, 4)), convert.tnw_state,
           convert.tnw_from_state, run, [X])


def test_tensor_normal_wishart_kron_recovery():
    """tests/test_transforms_misc.py's Kronecker covariance recovery, and
    the node protocol's finite KL at creation, on the port's own draw."""
    X, true = _kron_data(2000)
    m = PD.TensorNormalWishart.create((3, 4), generator=torch.Generator().manual_seed(0),
                                      dtype=torch.float64, device="cpu")
    assert torch.isfinite(m.KLqprior()).all()
    m = m.raw_update(T64(X), iters=4)
    Sig = m.ESigma().reshape(12, 12).numpy()
    assert np.abs(Sig / np.trace(Sig) - true / np.trace(true)).max() < 0.02


# ---------------------------------------------------- MultiLinearNormalWishart
def _multilinear_data(ns=500):
    rs = np.random.RandomState(7)
    A1, A2 = rs.randn(3, 2), rs.randn(3, 4)
    X1, X2 = rs.randn(ns, 2, 1), rs.randn(ns, 4, 1)
    b = np.asarray([1.0, -1.0, 0.5])[:, None]
    Y = A1 @ X1 + A2 @ X2 + b + 0.05 * rs.randn(ns, 3, 1)
    return X1, X2, Y, (A1, A2, b)


@pytest.mark.parametrize("noise", ["Wishart", "Gamma"])
def test_multilinear_matches_jax(noise):
    X1, X2, Y, _ = _multilinear_data(120)
    w = np.random.RandomState(1).rand(120)

    def run(m, A, data):
        X1, X2, Y, w = data
        m.raw_update([X1, X2], Y, iters=2)
        m.raw_update([X1, X2], Y, p=w, lr=0.8)
        pY, Res = m.predict([X1[:7], X2[:7]])
        post = m.postdict(Y[:7], iters=3)
        out = dict(A0=m.A[0].mu, A1=m.A[1].mu, bias=m.bias.mean(), EinvSigma=m.EinvSigma(),
                   ESigma=m.ESigma(), KL=m.KLqprior(), like=m.Elog_like([X1, X2], Y),
                   pY=pY.mean(), Res=Res, post0=post[0].mean(), post1=post[1].mean())
        if noise == "Wishart":  # a Gamma factor's forward has no residual to sum
            lib = TMVN_vf if A is T64 else JMVN_vf
            pX = [lib(mu=X[:7], Sigma=A(np.broadcast_to(0.1 * np.eye(X.shape[-2]),
                                                        (7,) + 2 * X.shape[-2:-1]).copy()))
                  for X in (X1, X2)]
            fY, fRes = m.forward(pX)
            out.update(fY=fY.mean(), fSigma=fY.ESigma(), fRes=fRes)
        return out

    parity(lambda: JT.MultiLinearNormalWishart(3, [2, 4], noise_type=noise),
           convert.multilinear_state, convert.multilinear_from_state, run, [X1, X2, Y, w])


def test_multilinear_recovery():
    """tests/test_transforms_misc.py's recovery of the two maps and the
    bias, from the JAX model's initial state."""
    X1, X2, Y, (A1, A2, b) = _multilinear_data()
    rng.seed(0)
    state = convert.multilinear_state(JT.MultiLinearNormalWishart(3, [2, 4]))
    m = convert.multilinear_from_state(state, "cpu")
    for _ in range(5):
        m.raw_update([T64(X1), T64(X2)], T64(Y), iters=1)
    assert np.abs(m.A[0].mean().numpy() - A1).max() < 0.1
    assert np.abs(m.A[1].mean().numpy() - A2).max() < 0.1
    assert np.abs(m.bias.mean().numpy() - b).max() < 0.15
    assert m.A[0].invU is m.invSigma and m.bias.invSigma is m.invSigma


# -------------------------------------------------------- ReducedRankRegression
def _rrr_data(ns=400):
    rs = np.random.RandomState(3)
    U = rs.randn(ns, 2)
    A, B = rs.randn(6, 2), rs.randn(5, 2)
    return U @ B.T + 0.05 * rs.randn(ns, 5), U @ A.T + 0.05 * rs.randn(ns, 6)


@pytest.mark.parametrize("independent", [False, True])
def test_reduced_rank_regression_matches_jax(independent):
    X, Y = _rrr_data(150)

    def run(m, A, data):
        X, Y = data
        m.raw_update(X, Y, iters=3)
        logZ = m.logZ
        pY, Res = m.predict(X[:9])
        out = dict(A=m.A.mu, B=m.B.mu, U=m.U.mu, KL=m.KLqprior(), logZ=logZ, pu=m.pu.mean(),
                   pY=pY.mean(), pSigma=pY.ESigma(), EW=m.EW(), like=m.Elog_like(X[:9], Y[:9]))
        if not independent:  # MatrixNormalGamma's forward gives no residual
            out["Res"] = Res
        return out

    parity(lambda: JT.ReducedRankRegression(6, 5, 2, independent=independent),
           convert.rrr_state, convert.rrr_from_state, run, [X, Y])


def test_reduced_rank_regression_recovery():
    X, Y = _rrr_data()
    rng.seed(0)
    state = convert.rrr_state(JT.ReducedRankRegression(6, 5, 2))
    m = convert.rrr_from_state(state, "cpu")
    m.raw_update(T64(X), T64(Y), iters=10)
    pY, _ = m.predict(T64(X)[..., None])
    assert np.abs(pY.mean()[..., 0].numpy() - Y).mean() < 0.5
    s = np.linalg.svd(m.EW().numpy(), compute_uv=False)
    assert s[1] / s[0] > 0.01 and s[2] / s[0] < 0.2


# ---------------------------------------------------- MixtureofLinearTransforms
def _two_regimes(ns=400):
    rs = np.random.RandomState(0)
    X = rs.rand(ns, 1) * 4 - 2
    z = rs.rand(ns, 1) < 0.5
    Y = np.where(z, 2 * X + 5, -2 * X - 5) + 0.05 * rs.randn(ns, 1)
    return X[..., None], Y[..., None], z[:, 0]


@pytest.mark.parametrize("kind", ["Wishart", "Gamma"])
def test_mixlt_matches_jax(kind):
    X, Y, _ = _two_regimes(120)

    def run(m, A, data):
        X, Y = data
        m.raw_update(X, Y, iters=3)
        out = dict(ELBO=np.asarray(m.ELBO_save), p=m.p, W=m.W.mu, pi=m.pi.alpha,
                   ELBO_now=m.ELBO())
        pY, p = m.predict(X[:9])
        out.update(pY=pY.mean(), pSigma=pY.ESigma(), pp=p)
        for k in ("EinvUX", "EXTinvUX", "EXinvVXT", "EXTX", "EXXT", "EinvSigma", "ESigma",
                  "ElogdetinvU", "ElogdetinvSigma", "weights", "bias"):
            out[k] = getattr(m, k)()
        M = A(np.eye(1) * 2.0)
        out.update(EXTAX=m.EXTAX(M), EXAXT=m.EXAXT(A(np.eye(2) * 0.5)))
        lib = TMVN_vf if A is T64 else JMVN_vf
        eye = A(np.broadcast_to(1e-3 * np.eye(1), (120, 1, 1)).copy())
        pX, pY = lib(mu=X, Sigma=eye), lib(mu=Y, Sigma=eye)
        m.update(pX, pY, iters=2)
        out.update(msg_ELBO=np.asarray(m.ELBO_save), msg_W=m.W.mu,
                   msg_like=m.Elog_like_given_pX_pY(pX, pY))
        return out

    parity(lambda: JT.MixtureofLinearTransforms(1, 1, 2, pad_X=True, type=kind),
           convert.mixlt_state, convert.mixlt_from_state, run, [X, Y])


def test_mixlt_recovery():
    """tests/test_transforms_misc.py's two regimes: both experts carry mass,
    recover the two (slope, intercept) pairs and separate the samples."""
    X, Y, z = _two_regimes()
    rng.seed(0)
    state = convert.mixlt_state(JT.MixtureofLinearTransforms(1, 1, 2, pad_X=True))
    m = convert.mixlt_from_state(state, "cpu")
    m.raw_update(T64(X), T64(Y), iters=20)
    assert m.pi.mean().min() > 0.2
    wb = np.concatenate([m.W.weights()[..., 0].numpy(), m.W.bias()[..., 0].numpy()], -1)
    true = np.asarray([[2.0, 5.0], [-2.0, -5.0]])
    assert min(np.abs(wb - true).max(), np.abs(wb - true[::-1]).max()) < 0.2, wb
    acc = (m.p.argmax(-1).numpy() == z).mean()
    assert max(acc, 1 - acc) > 0.95


# ------------------------------------------------------------------- dMixture
def _regions(n=600, K=3):
    rs = np.random.RandomState(0)
    z = rs.randint(0, K, n)
    centers_x = np.asarray([[-4.0, 0.0], [4.0, 0.0], [0.0, 4.0]])
    mus_y = np.asarray([[-3.0, -3.0], [3.0, 3.0], [3.0, -3.0]])
    X = centers_x[z] + 0.5 * rs.randn(n, 2)
    Y = mus_y[z] + 0.3 * rs.randn(n, 2)
    return X, Y, z, centers_x


def _jax_dmixture(Y):
    dist = JD.NormalInverseWishart.create(event_shape=(2,), batch_shape=(3,))
    # the means seeded with data points, as the JAX test seeds them
    return JdMixture(jreplace(dist, mu=jnp.asarray(Y[:3])), p=2)


def test_dmixture_matches_jax():
    X, Y, _, centers = _regions(200)

    def run(m, A, data):
        X, Y = data
        m.raw_update(X, Y, iters=3)
        return dict(ELBO=np.asarray(m.ELBO_save), p=m.p, NA=m.NA, logZ=m.logZ,
                    mu=m.dist.mu, invU=m.dist.invU.invU, beta=m.pi.beta.mu, KL=m.KLqprior(),
                    like=m.Elog_like(X, Y), means=m.means(),
                    avg=m.event_average(m.dist.mean()), gate=m.pi.predict(A(centers)))

    parity(lambda: _jax_dmixture(Y), convert.dmixture_state, convert.dmixture_from_state,
           run, [X, Y])


def test_dmixture_recovery():
    """tests/test_untested_components.py's directed mixture: a
    non-decreasing ELBO, the assignments up to permutation and an
    input-dependent gate; the gate's scatter is the plain version here."""
    X, Y, z, centers = _regions()
    rng.seed(0)
    state = convert.dmixture_state(_jax_dmixture(Y.astype(np.float32)))
    m = convert.dmixture_from_state(state, "cpu")
    before = ws.WEIGHTED_OUTER.plain_calls
    m.raw_update(T64(X), T64(Y), iters=15)
    assert ws.WEIGHTED_OUTER.plain_calls - before == 2 * 15
    e = np.asarray(m.ELBO_save)
    assert (np.diff(e)[2:] / np.abs(e[:-1])[2:] > -1e-5).all(), e
    pred = m.assignment().numpy()
    acc = sum((pred[z == k] == np.bincount(pred[z == k], minlength=3).argmax()).sum()
              for k in range(3))
    assert acc / len(z) > 0.9
    gate = m.pi.predict(T64(centers)).numpy()
    assert len(set(gate.argmax(-1))) == 3
    assert torch.isfinite(m.Elog_like(T64(X), T64(Y))).all()


# ------------------------------------------------------------ NL regressions
NLR = {
    "full_rank": (lambda: JT.NLRegression_full_rank(1, 1, 2), convert.nlr_full_state,
                  convert.nlr_full_from_state),
    "low_rank": (lambda: JT.NLRegression_low_rank(1, 1, 1, 2), convert.nlr_low_state,
                 convert.nlr_low_from_state),
    "orig": (lambda: JNLRorig(1, 1, 1, 2), convert.nlr_orig_state,
             convert.nlr_orig_from_state),
}


@pytest.mark.parametrize("name", list(NLR))
def test_nl_regression_matches_jax(name):
    X, Y = _piecewise_linear(4, 150)

    def run(m, A, data):
        X, Y = data
        m.raw_update(X, Y, iters=3)
        out = m.predict(X[:11])
        return dict(ELBO=np.asarray(m.ELBO_save), p=m.p, NA=m.NA, KL=m.KLqprior(),
                    ELBO_now=m.ELBO(), pY=out[0].mean(), pSigma=out[0].ESigma(), pp=out[1])

    parity(*NLR[name], run, [X, Y])


@pytest.mark.parametrize("name", ["full_rank", "low_rank"])
def test_nl_regression_fit(name):
    """tests/test_transforms_misc.py's fit of the piecewise-linear task."""
    X, Y = _piecewise_linear(4)
    make, to_state, from_state = NLR[name]
    rng.seed(0)
    state = to_state(make())
    m = from_state(state, "cpu")
    m.raw_update(T64(X), T64(Y), iters=15)
    err = np.abs(m.predict(T64(X))[0].mean()[..., 0].numpy() - Y).mean()
    assert err < 0.35


def test_nl_regression_orig_shares_its_noise():
    """U's precision is W's after every sweep, and the KL counts it once."""
    X, Y = _piecewise_linear(4, 100)
    with jax.enable_x64(True):
        rng.seed(0)
        state = convert.nlr_orig_state(JNLRorig(1, 1, 1, 2))
    m = convert.nlr_orig_from_state(state, "cpu")
    m.raw_update(T64(X), T64(Y), iters=3)
    assert m.U.invU is m.W.invU
    assert np.isfinite(m.ELBO_save).all()


# ------------------------------------------------------ dMixLT, Gamma experts
def test_dmixlt_gamma_experts_match_jax():
    X, Y = _piecewise_linear(1, 150)

    def run(m, A, data):
        X, Y = data
        m.raw_update(X, Y, iters=3)
        pY, p = m.predict(X[:9])
        return dict(ELBO=np.asarray(m.ELBO_save), p=m.p, A=m.A.mu,
                    gamma=m.A.invU.gamma.alpha, pY=pY.mean(), pSigma=pY.ESigma(), pp=p)

    state = parity(lambda: JT.dMixtureofLinearTransforms(1, 1, 2, type="Gamma"),
                   convert.dmixlt_state, convert.dmixlt_from_state, run, [X, Y])
    assert state["config"]["type"] == "Gamma"
    m = convert.dmixlt_from_state(state, "cpu")
    assert type(m.A).__name__ == "MatrixNormalGamma"
