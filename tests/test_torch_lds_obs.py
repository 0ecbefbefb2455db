"""An LDS with a caller's observation model, and the two-moons loop, against
the JAX package, in float64 on the CPU (the JAX side under the scoped
``jax.enable_x64``; state carried by ``pyvbmp_tpu_torch.utils.convert``):

- ``LinearDynamicalSystems((4,), 2, obs_model=...)`` with a
  MatrixNormalWishart and a MatrixNormalGamma observation model of event
  shape (4, 2) and ``pad_X=True`` (its bias column is the LDS's regressor),
  each with the sequential and the scan smoother, on the LDS-core data
  recipe (``benchmarks/core_models_bench.py:lds_data``) cut to T=30,
  batch=5: 3 sweeps through ``lds_state`` (the ELBO trajectory, the
  smoothed means, ``ELBO()``, the observation model's mean) and the state's
  round trip;
- an observation model of the wrong width raises ``ValueError`` naming the
  width it needs;
- ``examples/two_moons.py``'s loop (a dMixtureofLinearTransforms layer, an
  MNLR head, the head's backward message fused into the layer's forward one
  by ``MultivariateNormal_vector_format.combiner``) at the example's smoke
  size (n=80, 3 iterations) from one state (``dmixlt_state``,
  ``mnlr_state``): the messages, the layer's ELBOs, the head's KL and the
  predictions.

Tolerance: max |port - jax| / max |jax| <= 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import transforms as JT
from pyvbmp_tpu.dists import MultivariateNormal_vector_format as JMVN
from pyvbmp_tpu.models import LinearDynamicalSystems as JLDS
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch import transforms as PT
from pyvbmp_tpu_torch.dists import MultivariateNormal_vector_format as PMVN
from pyvbmp_tpu_torch.models import LinearDynamicalSystems as PLDS
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.utils.convert import (
    dmixlt_from_state, dmixlt_state, lds_from_state, lds_state, mnlr_from_state, mnlr_state,
)

TOL = 1e-8
T_LEN, BATCH, OBS, HIDDEN = 30, 5, 4, 2
SWEEPS = 3


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / np.abs(ref).max()


def lds_data(seed=0):
    """benchmarks/core_models_bench.py:lds_data at T=30, batch=5: a damped
    rotation in 2 dims seen through a random 4 x 2 map."""
    rs = np.random.RandomState(seed)
    th = 0.2
    A = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]) * 0.98
    C = rs.randn(OBS, HIDDEN)
    x = rs.randn(BATCH, HIDDEN)
    ys = []
    for _ in range(T_LEN):
        x = x @ A.T + 0.05 * rs.randn(BATCH, HIDDEN)
        ys.append(x @ C.T + 0.1 * rs.randn(BATCH, OBS))
    return np.stack(ys)


@pytest.fixture(scope="module", params=[
    (kind, parallel) for kind in ("MatrixNormalWishart", "MatrixNormalGamma")
    for parallel in (False, True)], ids=lambda p: f"{p[0]}-parallel_scan={p[1]}")
def lds_fitted(request):
    kind, parallel = request.param
    y = lds_data()
    with jax.enable_x64(True):
        rng.seed(3)
        obs = getattr(JT, kind).create((OBS, HIDDEN), pad_X=True)
        jm = JLDS((OBS,), HIDDEN, obs_model=obs, parallel_scan=parallel)
        state = lds_state(jm)
        jm.update(jnp.asarray(y), iters=SWEEPS)
        ref = dict(ELBO=np.asarray(jm.ELBO_save), mu=np.asarray(jm.px.mu),
                   ELBO_now=np.asarray(jm.ELBO()), B=np.asarray(jm.obs_model.mu))
    tm = lds_from_state(state, device="cpu", dtype=torch.float64)
    plain = scan.KALMAN_LANE.plain_calls
    tm.update(torch.tensor(y), iters=1)
    tm.update(torch.tensor(y), iters=SWEEPS - 1)
    # the scan smoother's two lane scans a pass (3 sweeps and the final
    # posterior's pass); the sequential smoother runs none
    assert scan.KALMAN_LANE.plain_calls - plain == (2 * (SWEEPS + 1) if parallel else 0)
    return kind, ref, tm


def test_lds_with_pad_x_obs_model_matches_jax(lds_fitted):
    kind, ref, tm = lds_fitted
    assert type(tm.obs_model) is getattr(PT, kind) and tm.obs_model.pad_X
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref["ELBO"]) / np.abs(ref["ELBO"])).max() <= TOL, (out, ref["ELBO"])
    assert out[-1] > out[0]
    assert rel_dev(tm.px.mu, ref["mu"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO_now"]) <= TOL
    assert rel_dev(tm.obs_model.mu, ref["B"]) <= TOL


def test_lds_with_pad_x_obs_model_round_trips(lds_fitted):
    _, _, tm = lds_fitted
    again = lds_from_state(lds_state(tm), device="cpu", dtype=torch.float64)
    assert type(again.obs_model) is type(tm.obs_model) and again.obs_model.pad_X
    assert torch.equal(again.obs_model.mu, tm.obs_model.mu)
    assert torch.equal(again.px.mu, tm.px.mu)


@pytest.mark.parametrize("pad_X", [False, True])
def test_obs_model_of_the_wrong_width_raises(pad_X):
    """(4, 3) with pad_X maps an X of width 4, (4, 2) without it one of 2;
    the LDS needs 3: (4, 2) with pad_X, (4, 3) without."""
    wrong = HIDDEN + 1 if pad_X else HIDDEN
    obs = PT.MatrixNormalGamma.create((OBS, wrong), pad_X=pad_X, dtype=torch.float64)
    width = HIDDEN + 1 - int(pad_X)
    with pytest.raises(ValueError, match=rf"needs hidden_dim \+ regression_dim \+ 1 = 3.*"
                                         rf"\({OBS}, {width}\)"):
        PLDS((OBS,), HIDDEN, obs_model=obs, device="cpu")


def test_obs_model_goes_to_the_model_device_and_dtype():
    obs = PT.MatrixNormalWishart.create((OBS, HIDDEN), pad_X=True, dtype=torch.float64)
    m = PLDS((OBS,), HIDDEN, obs_model=obs, dtype=torch.float32, device="cpu")
    assert m.obs_model.mu.dtype == torch.float32 and m.obs_model.pad_X


# -------------------------------------------------------------------- two moons
def two_moons(n, noise=0.08, seed=0):
    """examples/two_moons.py:two_moons."""
    rs = np.random.RandomState(seed)
    t = np.pi * rs.rand(n // 2)
    outer = np.stack([np.cos(t), np.sin(t)], -1)
    inner = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
    X = np.concatenate([outer, inner]) + noise * rs.randn(n, 2)
    y = np.concatenate([np.zeros(n // 2, int), np.ones(n // 2, int)])
    return X.astype(np.float32).astype(np.float64), y


def moons_loop(layer, head, X, Y, A, MVN, iters):
    """examples/two_moons.py's loop; returns what it passes along."""
    pX = MVN(mu=A(X)[..., None], Sigma=1e-4 * A(np.broadcast_to(np.eye(2), (len(X), 2, 2))))
    for _ in range(iters):
        pH = layer.forward(pX)
        head.update(pH, A(Y), iters=1)
        pH_msg, _ = head.backward(A(Y))
        pH_comb = pH.combiner(pH_msg)
        layer.update(pX, pH_comb, iters=1)
    pH = layer.forward(pX)
    out = head.forward(pH)
    return dict(comb_mean=pH_comb.mean(), comb_invSigma=pH_comb.EinvSigma(),
                msg_invSigmamu=pH_msg.EinvSigmamu(), pH_mean=pH.mean(), pH_Sigma=pH.ESigma(),
                out=out, layer_elbo=np.asarray(layer.ELBO_save), head_KL=head.KLqprior())


def test_two_moons_loop_matches_jax():
    X, y = two_moons(80)
    Y = np.eye(2)[y]
    with jax.enable_x64(True):
        rng.seed(0)
        layer = JT.dMixtureofLinearTransforms(2, 2, 4, pad_X=True)
        head = JT.MultiNomialLogisticRegression(2, 2, pad_X=True)
        states = dmixlt_state(layer), mnlr_state(head)
        ref = {k: np.asarray(v) for k, v in
               moons_loop(layer, head, X, Y, jnp.asarray, JMVN, 3).items()}
    layer = dmixlt_from_state(states[0], "cpu", torch.float64)
    head = mnlr_from_state(states[1], "cpu", torch.float64)
    out = moons_loop(layer, head, X, Y, torch.tensor, PMVN, 3)
    for k in ref:
        assert rel_dev(out[k], ref[k]) <= TOL, k
    assert np.array_equal(np.asarray(out["out"]).argmax(-1), ref["out"].argmax(-1))
