"""The port's ARHMM family (pyvbmp_tpu_torch/models/arhmm.py) and
MatrixNormalWishart.Elog_like_X_given_pY against the JAX package's, in
float64 on the CPU.

The JAX side runs under the scoped ``jax.enable_x64``; the same numpy inputs
go to both, and each model crosses from JAX to the port through
``utils.convert.arhmm_state``.  Data: the two-regime AR recipe of
tests/test_models_hmm_lds.py (test_arhmm_runs) cut to T=24, batch 4.
Tolerances: max relative deviation 1e-10 for the MNW message, 1e-8 for
the 3-sweep fits (the ELBO trajectory, p, KLqprior(), ELBO() and the
latent messages)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.dists.mvn_vector_format import MultivariateNormal_vector_format as JMVN
from pyvbmp_tpu.models import ARHMM as JARHMM
from pyvbmp_tpu.models import ARHMM_prXRY as JprXRY
from pyvbmp_tpu.models import ARHMM_prXY as JprXY
from pyvbmp_tpu.transforms import MatrixNormalWishart as JMNW
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists.mvn_vector_format import MultivariateNormal_vector_format as TMVN
from pyvbmp_tpu_torch.models import ARHMM as TARHMM
from pyvbmp_tpu_torch.models import ARHMM_prXRY as TprXRY
from pyvbmp_tpu_torch.models import ARHMM_prXY as TprXY
from pyvbmp_tpu_torch.transforms import MatrixNormalWishart as TMNW
from pyvbmp_tpu_torch.utils.convert import (
    arhmm_from_state, arhmm_state, load_state, node_state,
)

TOL = 1e-8
MSG_TOL = 1e-10
SWEEPS = 3
T_LEN, BATCH, K = 24, 4, 3


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / np.abs(ref).max()


def T64(x):
    return torch.tensor(np.asarray(x, np.float64))


def ar_data(T=T_LEN, B=BATCH, seed=0):
    """Two AR regimes switching every 10 steps: X (the previous point) and
    Y (the next), each (T, B, 1, 2, 1)."""
    rs = np.random.RandomState(seed)
    A1 = np.eye(2) * 0.9
    A2 = np.asarray([[0.0, -0.9], [0.9, 0.0]])
    x = rs.randn(B, 2)
    X, Y = [], []
    for t in range(T):
        A = A1 if (t // 10) % 2 == 0 else A2
        y = x @ A.T + 0.05 * rs.randn(B, 2)
        X.append(x)
        Y.append(y)
        x = y
    return np.stack(X)[..., None, :, None], np.stack(Y)[..., None, :, None]


def covs(rs, shape, d, scale=0.1):
    G = rs.randn(*shape, d, d) * scale
    return G @ np.swapaxes(G, -1, -2) + 0.05 * np.eye(d)


@pytest.mark.parametrize("pad_X", [False, True])
def test_mnw_elog_like_x_given_py_matches_jax(pad_X):
    rs = np.random.RandomState(4 + pad_X)
    S, n, p = 6, 2, 3
    X = rs.randn(S, K, p, 1)
    Y = rs.randn(S, K, n, 1) + X[..., :n, :]
    my, Sy = rs.randn(S, K, n, 1), covs(rs, (S, K), n)
    with jax.enable_x64(True):
        rng.seed(4)
        ja = JMNW.create((n, p), (K,), pad_X=pad_X).raw_update(jnp.asarray(X), jnp.asarray(Y))
        state = node_state(ja)
        px, Res = ja.Elog_like_X_given_pY(JMVN(mu=jnp.asarray(my), Sigma=jnp.asarray(Sy)))
        ref = [np.asarray(a) for a in (px.EinvSigma(), px.EinvSigmamu(), px.mean(),
                                       px.ESigma(), Res)]
    ta = load_state(TMNW.create((n, p), (K,), pad_X=pad_X, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(0)), state)
    px, Res = ta.Elog_like_X_given_pY(TMVN(mu=T64(my), Sigma=T64(Sy)))
    out = (px.EinvSigma(), px.EinvSigmamu(), px.mean(), px.ESigma(), Res)
    for i, (o, r) in enumerate(zip(out, ref)):
        assert rel_dev(o, r) <= MSG_TOL, i


def inputs(kind):
    """The numpy pieces of one model's observations."""
    X, Y = ar_data()
    rs = np.random.RandomState(8)
    if kind == "ARHMM":
        return dict(X=X, Y=Y)
    if kind == "ARHMM_prXY":
        return dict(X=X, SX=covs(rs, X.shape[:3], 2), Y=Y, SY=covs(rs, Y.shape[:3], 2))
    return dict(X=X, SX=covs(rs, X.shape[:3], 2), R=rs.randn(T_LEN, BATCH, 1, 1, 1), Y=Y)


def observations(kind, d, mvn, arr):
    """The tuple ``update`` takes, built with one package's MVN message type
    and array constructor."""
    if kind == "ARHMM":
        return (arr(d["X"]), arr(d["Y"]))
    if kind == "ARHMM_prXY":
        return (mvn(mu=arr(d["X"]), Sigma=arr(d["SX"])),
                mvn(mu=arr(d["Y"]), Sigma=arr(d["SY"])))
    return (mvn(mu=arr(d["X"]), Sigma=arr(d["SX"])), arr(d["R"]), arr(d["Y"]))


JAX_CLASSES = {"ARHMM": lambda pad: JARHMM(K, 2, 2, pad_X=pad),
               "ARHMM_prXY": lambda pad: JprXY(K, 2, 2, pad_X=pad),
               "ARHMM_prXRY": lambda pad: JprXRY(K, 2, 2, 1, pad_X=pad)}


def latent_messages(kind, m, d, mvn, arr):
    """Each model's latent-message read-outs after its fit."""
    if kind == "ARHMM":
        return m.Elog_like_X_given_Y(arr(d["Y"]))
    if kind == "ARHMM_prXY":
        return m.Elog_like_X_given_pY(mvn(mu=arr(d["Y"]), Sigma=arr(d["SY"])))
    YR = (arr(d["Y"]), arr(d["R"]))
    p_rev = arr(np.ascontiguousarray(np.asarray(m.p)[..., ::-1]))
    return (m.Elog_like(observations(kind, d, mvn, arr)), *m.Elog_like_X(YR),
            *m.Elog_like_X(YR, p=p_rev))


@pytest.fixture(scope="module", params=[(kind, pad) for kind in JAX_CLASSES
                                        for pad in (False, True)],
                ids=lambda c: f"{c[0]}-pad_X={c[1]}")
def reference(request):
    """(case, the JAX model's state before its fit, its outputs after SWEEPS
    sweeps with the sequential smoother)."""
    kind, pad = request.param
    d = inputs(kind)
    with jax.enable_x64(True):
        rng.seed(3)
        jm = JAX_CLASSES[kind](pad)
        state = arhmm_state(jm)
        jm.update(observations(kind, d, JMVN, jnp.asarray), iters=SWEEPS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   KL=np.asarray(jm.KLqprior()), ELBO=np.asarray(jm.ELBO()))
        ref["msgs"] = [np.asarray(a)
                       for a in latent_messages(kind, jm, d, JMVN, jnp.asarray)]
    return (kind, pad, d), state, ref


@pytest.fixture(scope="module", params=[False, True], ids=["sequential", "parallel"])
def fitted(request, reference):
    """(case, JAX outputs, port model) after SWEEPS sweeps from the JAX
    model's state, with the port's sequential or scan-based smoother (the
    JAX package's two agree to float64 rounding)."""
    (kind, pad, d), state, ref = reference
    tm = arhmm_from_state(dict(state, parallel_scan=request.param), device="cpu",
                          dtype=torch.float64)
    assert type(tm).__name__ == kind
    assert (tm.parallel_scan, tm.obs_dist.pad_X) == (request.param, pad)
    tm.update(observations(kind, d, TMVN, T64), iters=SWEEPS)
    return (kind, d), ref, tm


def test_elbo_trajectory_matches_jax(fitted):
    _, ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,) and np.isfinite(out).all()
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL


def test_posteriors_and_kl_match_jax(fitted):
    _, ref, tm = fitted
    assert tm.p.shape == (T_LEN, BATCH, K)
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO"]) <= TOL


def test_latent_messages_match_jax(fitted):
    """Elog_like_X_given_Y (ARHMM), Elog_like_X_given_pY (ARHMM_prXY),
    Elog_like and Elog_like_X with the stored p and with p given
    (ARHMM_prXRY), read from the fitted models."""
    (kind, d), ref, tm = fitted
    out = latent_messages(kind, tm, d, TMVN, T64)
    assert len(out) == len(ref["msgs"])
    for i, (o, r) in enumerate(zip(out, ref["msgs"])):
        assert rel_dev(o, r) <= TOL, i


def test_state_round_trips_through_numpy(fitted):
    _, _, tm = fitted
    again = arhmm_from_state(arhmm_state(tm), device="cpu", dtype=torch.float64)
    assert type(again) is type(tm)
    assert (again.parallel_scan, again.ptemp) == (tm.parallel_scan, tm.ptemp)
    assert again.obs_dist.pad_X == tm.obs_dist.pad_X
    assert torch.equal(again.obs_dist.mu, tm.obs_dist.mu)
    assert torch.equal(again.transition.alpha, tm.transition.alpha)
    assert torch.equal(again.p, tm.p)


def slots(m):
    """What a constructor's positional arguments set, read from either
    package's model."""
    o = m.obs_dist
    mask = None if o.X_mask is None else np.asarray(o.X_mask)
    tmask = m.transition_mask
    return (tuple(o.event_shape), tuple(o.batch_shape), bool(o.pad_X),
            None if o.mask is None else np.asarray(o.mask).tolist(),
            None if mask is None else mask.tolist(),
            None if tmask is None else np.asarray(tmask).tolist(),
            getattr(m, "p1", None), getattr(m, "p2", None))


def test_positional_constructors_build_the_same_models():
    """The JAX signatures, called positionally in both packages:
    ARHMM(dim, n, p, batch_shape, pad_X, X_mask, mask, transition_mask),
    ARHMM_prXY(dim, n, p, batch_shape, X_mask, mask, pad_X, transition_mask),
    ARHMM_prXRY(dim, n, p1, p2, batch_shape, mask, X_mask, transition_mask,
    pad_X); generator, dtype and device only by keyword."""
    tmask = np.ones((3, 3), bool)
    tmask[0, 2] = False
    xm = np.asarray([[True, False, True]])
    am = np.ones((2, 3), bool)
    am[1, 0] = False
    xm_rxy = np.asarray([[True, True, False, True]])
    am_rxy = np.ones((2, 4), bool)
    calls = [
        (JARHMM, TARHMM, (3, 2, 3, (2,), False, xm, am, tmask)),
        (JprXY, TprXY, (3, 2, 3, (2,), xm, am, False, tmask)),
        (JprXRY, TprXRY, (3, 2, 3, 1, (2,), am_rxy, xm_rxy, tmask, True)),
    ]
    for jcls, tcls, args in calls:
        with jax.enable_x64(True):
            want = slots(jcls(*args))
        got = slots(tcls(*args, generator=torch.Generator().manual_seed(0), device="cpu",
                         dtype=torch.float64))
        assert got == want, tcls.__name__
    with pytest.raises(TypeError):
        TprXRY(3, 2, 3, 1, (), None, None, None, False, torch.Generator())
