"""The Bayesian transformers of the port against the JAX package's, in
float64 on the CPU (the JAX side under the scoped ``jax.enable_x64``; a
model's initial state reaches the port through
``pyvbmp_tpu_torch.utils.convert``).  Tolerance: max |port - jax| /
max |jax| <= 1e-8 for every compared output.

- GenerativeBayesianTransformer and FocusedBayesianTransformer at the
  widths of ``tests/test_transformers.py`` (mixture 4, role 3, obs 2,
  hidden 2, ``pad_X``) on its mixture data: the ELBO trajectory, the
  assignments and the posteriors after 3 sweeps (GBT also with
  ``latent_iters=2``), and the JAX tests' finite, rising ELBO;
- GBT with ``latent_iters=0`` raises ``ValueError`` in the port (the JAX
  package's sweep fails on unset assignments there);
- ChainedBayesianTransformer: 3 sweeps against the JAX package, and the
  JAX test's chain discovery (y0 independent, y1 <- y0, y2 <- y1);
- DiscreteBayesianTransformer is the Focused one, as in the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import transforms as JT
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch import transforms as PT
from pyvbmp_tpu_torch.utils import convert

TOL = 1e-8
WIDTHS = dict(mixture_dim=4, role_dim=3, obs_dim=2, hidden_dim=2, pad_X=True)


def rel_dev(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    scale = np.abs(ref).max()
    return np.abs(port - ref).max() / scale if scale > 0 else np.abs(port).max()


def _mixture_data(num_samples=64, num_obs=6, mixture_dim=4, hidden_dim=2, obs_dim=2):
    """tests/test_transformers.py's data."""
    rs = np.random.RandomState(0)
    X = rs.randn(num_samples, mixture_dim, hidden_dim)
    z = rs.rand(num_samples, mixture_dim).argmax(-1)
    A = rs.randn(mixture_dim, obs_dim, hidden_dim) / hidden_dim**0.5
    Y = (A[z][:, None] @ X[..., None]).squeeze(-1)
    return Y[:, :num_obs]


def _chain_data(S=500, n=2):
    rs = np.random.RandomState(1)
    W = np.array([[0.9, -0.4], [0.4, 0.9]])
    y0 = rs.randn(S, n) * 2.0
    y1 = y0 @ W.T + 0.01 * rs.randn(S, n)
    y2 = y1 @ W.T + 0.01 * rs.randn(S, n)
    return np.stack([y0, y1, y2], 1)


def _fit(m, Y, sweeps, **kw):
    m.raw_update(Y, iters=sweeps, **kw)
    out = dict(ELBO=np.asarray(m.ELBO_save), p=m.p, NA=m.NA, KL=m.KLqprior(),
               pX_invSigma=m.pX.EinvSigma(), pX_invSigmamu=m.pX.EinvSigmamu())
    if hasattr(m, "A"):
        out.update(A=m.A.mu, role=m.pi_role.alpha, mix=m.pi_mix.alpha)
    else:
        out.update(W=m.W.A.mu, beta=m.W.pi.beta.mu, pi=m.pi.alpha)
    return out


CASES = {
    "GBT": (JT.GenerativeBayesianTransformer, convert.gbt_state, convert.gbt_from_state, {}),
    "GBT latent_iters=2": (JT.GenerativeBayesianTransformer, convert.gbt_state,
                           convert.gbt_from_state, dict(latent_iters=2)),
    "FBT": (JT.FocusedBayesianTransformer, convert.fbt_state, convert.fbt_from_state, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_transformer_matches_jax(name):
    jcls, to_state, from_state, kw = CASES[name]
    Y = _mixture_data()
    with jax.enable_x64(True):
        rng.seed(0)
        jm = jcls(**WIDTHS)
        state = to_state(jm)
        ref = {k: np.asarray(v) for k, v in _fit(jm, jnp.asarray(Y), 3, **kw).items()}
    out = _fit(from_state(state, "cpu"), torch.tensor(Y), 3, **kw)
    for k in ref:
        assert rel_dev(out[k], ref[k], k) <= TOL, k
    # the JAX tests' assertions
    assert np.isfinite(out["ELBO"]).all()
    if name.startswith("GBT"):
        assert out["ELBO"][-1] > out["ELBO"][0]


def test_gbt_without_latent_iterations_raises():
    m = PT.GenerativeBayesianTransformer(**WIDTHS, generator=torch.Generator().manual_seed(0),
                                         dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="latent_iters"):
        m.raw_update(torch.tensor(_mixture_data()), iters=1, latent_iters=0)


def test_gbt_stepwise_api_matches_jax():
    """update_assignments / update_latents / update_parms / postdict."""
    Y = _mixture_data(16)

    def run(m, Y):
        logZ = m.update_assignments(Y)
        res = m.update_latents(Y)
        m.update_parms(Y, lr=0.8)
        pX = m.postdict(Y, iters=1)
        return dict(logZ=logZ, res=res, p=m.p, A=m.A.mu, pX=pX.EinvSigmamu(),
                    like=m.Elog_like(Y))

    with jax.enable_x64(True):
        rng.seed(0)
        jm = JT.GenerativeBayesianTransformer(**WIDTHS)
        state = convert.gbt_state(jm)
        ref = {k: np.asarray(v) for k, v in run(jm, jnp.asarray(Y)).items()}
    out = run(convert.gbt_from_state(state, "cpu"), torch.tensor(Y))
    for k in ref:
        assert rel_dev(out[k], ref[k], k) <= TOL, k


def test_cbt_matches_jax():
    Y = _chain_data(120)

    def run(m, Y):
        elbos = []
        for _ in range(3):
            m.raw_update(Y, iters=1)
            elbos.append(m.ELBO())
        return dict(ELBO=elbos, p=m.p, logZ=m.logZ, W=m.W.mu, x0=m.x0.mu, pi=m.pi.alpha,
                    KL=m.KLqprior())

    with jax.enable_x64(True):
        rng.seed(3)
        jm = JT.ChainedBayesianTransformer(1, 1, 2, 2)
        state = convert.cbt_state(jm)
        ref = {k: np.asarray(v) for k, v in run(jm, jnp.asarray(Y)).items()}
    out = run(convert.cbt_from_state(state, "cpu"), torch.tensor(Y))
    out["ELBO"] = torch.stack(out["ELBO"])
    for k in ref:
        assert rel_dev(out[k], ref[k], k) <= TOL, k


def test_cbt_discovers_the_chain():
    """tests/test_transformers.py's chain discovery, from the initial state
    of the JAX model built as that test builds it (float32, seed 3)."""
    Y = torch.tensor(_chain_data())
    rng.seed(3)
    state = convert.cbt_state(JT.ChainedBayesianTransformer(1, 1, 2, 2))
    m = convert.cbt_from_state(state, "cpu")
    elbos = []
    for _ in range(10):
        m.raw_update(Y, iters=1)
        elbos.append(float(m.ELBO()))
    assert np.isfinite(elbos).all() and elbos[-1] > elbos[0]
    p = m.p.mean(0).numpy()
    assert 1 - p.sum(-1)[0] > 0.9
    assert p[1, 0] > 0.9 and p[2, 1] > 0.9


def test_discrete_transformer_is_focused_alias():
    assert PT.DiscreteBayesianTransformer is PT.FocusedBayesianTransformer
