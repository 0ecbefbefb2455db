"""BayesianFactorAnalysis and BayesNet, the port against the JAX package in
float64 on the CPU.  Each JAX model is built under the scoped
``jax.enable_x64``, its state reaches the port through
``convert.bfa_state``/``convert.bayesnet_state``, and both run the same
updates on the same numpy data (made from a seed).  Tolerance: max |port -
jax| / max |jax| <= 1e-8 for every compared output.

- BFA at ``batch_shape=()`` and ``(2,)``: 3 ``raw_update`` sweeps (ELBO_save,
  every field of A, q(z)'s mean), then ``update_latents``/``update_parms``,
  ``forward``, ``backward``, ``postdict``, ``ELBO`` and ``KLqprior``;
- the JAX package's ``test_bfa_recovery`` (ELBO non-decreasing after the
  first sweep, column-space error < 0.1) run on the port from the initial
  state of the JAX model built as that test builds it;
- BayesNet with one layer (the two-moons network: hidden 2, 4 experts) and
  two (hidden (3, 2), experts (2, 2)): 3 sweeps with FBI on and off, every
  layer's and the head's posterior means, and ``predict``;
- float32 against float64 from one state (the card's comparison, on the
  CPU): BFA's ELBO and A's mean within 1e-4, and BayesNet on the digits
  task, every layer's and the head's means within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.dists.mvn_vector_format import MultivariateNormal_vector_format as JMVN_vf
from pyvbmp_tpu.models import BayesianFactorAnalysis as JBFA
from pyvbmp_tpu.models import BayesNet as JBayesNet
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists.mvn_vector_format import MultivariateNormal_vector_format as TMVN_vf
from pyvbmp_tpu_torch.models import BayesianFactorAnalysis, BayesNet
from pyvbmp_tpu_torch.models.bayesian_factor_analysis import _sample_outer
from pyvbmp_tpu_torch.ops import scan, weighted_scatter as ws
from pyvbmp_tpu_torch.utils import convert

TOL = 1e-8
SWEEPS = 3


def rel_dev(port, ref, what=""):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    scale = np.abs(ref).max()
    return np.abs(port - ref).max() / scale if scale > 0 else np.abs(port).max()


def flat(d, prefix=""):
    """A nested node_state as {dotted key: array}."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                out.update(flat(x, f"{prefix}{k}.{i}."))
        elif v is not None:
            out[prefix + k] = v
    return out


def compare_nodes(port, ref):
    p, r = flat(convert.node_state(port)), flat(convert.node_state(ref))
    assert p.keys() == r.keys()
    for k in r:
        assert rel_dev(p[k], r[k], k) <= TOL, k


def factor_data(seed, S, o, h, batch=()):
    rs = np.random.RandomState(seed)
    A = rs.randn(*batch, o, h)
    z = rs.randn(S, *batch, h)
    return np.einsum("...oh,s...h->s...o", A, z) + 0.1 * rs.randn(S, *batch, o)


@pytest.fixture(scope="module", params=[(), (2,)], ids=["unbatched", "batch2"])
def bfa(request):
    """(JAX model after SWEEPS sweeps and its outputs, the port's after the
    same sweeps from the same state, the data)."""
    batch = request.param
    Y = factor_data(5, 60, 6, 2, batch)
    with jax.enable_x64(True):
        rng.seed(4)
        jm = JBFA(6, 2, batch_shape=batch)
        state = convert.bfa_state(jm)
        jm.raw_update(jnp.asarray(Y), iters=SWEEPS)
    tm = convert.bfa_from_state(state, "cpu", torch.float64)
    tm.raw_update(torch.tensor(Y), iters=SWEEPS)
    return jm, tm, Y


def test_bfa_sweeps_match_jax(bfa):
    jm, tm, _ = bfa
    out, ref = np.asarray(tm.ELBO_save), np.asarray(jm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)
    compare_nodes(tm.A, jm.A)
    assert rel_dev(tm.pz.mean(), jm.pz.mean()) <= TOL
    assert rel_dev(tm.logZ, jm.logZ) <= TOL
    assert rel_dev(tm.ELBO_last, jm.ELBO_last) <= TOL


def test_bfa_stepwise_api_matches_jax(bfa):
    """update_latents, update_parms, ELBO and KLqprior after the sweeps."""
    jm, tm, Y = bfa
    with jax.enable_x64(True):
        jm.update_latents(jnp.asarray(Y))
        ref = dict(logZ=np.asarray(jm.logZ), mu=np.asarray(jm.pz.mean()),
                   elbo=np.asarray(jm.ELBO()), kl=np.asarray(jm.KLqprior()))
        jm.update_parms(jnp.asarray(Y), lr=0.7)
    tm.update_latents(torch.tensor(Y))
    assert rel_dev(tm.logZ, ref["logZ"]) <= TOL
    assert rel_dev(tm.pz.mean(), ref["mu"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["elbo"]) <= TOL
    assert rel_dev(tm.KLqprior(), ref["kl"]) <= TOL
    tm.update_parms(torch.tensor(Y), lr=0.7)
    compare_nodes(tm.A, jm.A)


def test_bfa_messages_match_jax(bfa):
    """forward from a q(z), backward from a message over y, postdict."""
    jm, tm, Y = bfa
    rs = np.random.RandomState(6)
    zmu = rs.randn(*Y.shape[:-1], 2, 1)
    ymu = Y[..., None] + 0.1 * rs.randn(*Y.shape, 1)
    with jax.enable_x64(True):
        fw = jm.forward(JMVN_vf(mu=jnp.asarray(zmu), Sigma=0.5 * jnp.eye(2)))
        bw, bres = jm.backward(JMVN_vf(mu=jnp.asarray(ymu), Sigma=0.2 * jnp.eye(6)))
        pd = jm.postdict(jnp.asarray(Y))
        ref = [np.asarray(x) for x in (fw.EinvSigma(), fw.EinvSigmamu(), bw.EinvSigma(),
                                       bw.EinvSigmamu(), bres, pd.EinvSigma(),
                                       pd.EinvSigmamu(), pd.mean())]
    fw = tm.forward(TMVN_vf(mu=torch.tensor(zmu), Sigma=0.5 * torch.eye(2, dtype=torch.float64)))
    bw, bres = tm.backward(TMVN_vf(mu=torch.tensor(ymu),
                                   Sigma=0.2 * torch.eye(6, dtype=torch.float64)))
    pd = tm.postdict(torch.tensor(Y))
    out = (fw.EinvSigma(), fw.EinvSigmamu(), bw.EinvSigma(), bw.EinvSigmamu(), bres,
           pd.EinvSigma(), pd.EinvSigmamu(), pd.mean())
    for i, (o, r) in enumerate(zip(out, ref)):
        assert rel_dev(o, r, i) <= TOL, i


@pytest.mark.parametrize("ns", [1, 2])
def test_sample_outer_is_the_sum_of_outer_products(ns):
    """The M-step's sample sums as one matmul equal the JAX package's sum of
    (samples, a, b) outer products within 1e-11, with broadcast batch axes."""
    rs = np.random.RandomState(ns)
    A = torch.tensor(rs.randn(*(7, 5)[:ns], 3, 4))
    B = torch.tensor(rs.randn(*(7, 5)[:ns], 1, 2))
    ref = (A[..., :, None] * B[..., None, :]).sum(tuple(range(ns)))
    out = _sample_outer(A, B, ns)
    assert out.shape == (3, 4, 2)
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= 1e-11


def test_bfa_recovery():
    """tests/test_models_hmm_lds.py::test_bfa_recovery on the port: the JAX
    model's initial state (float32, built as that test builds it) fit in
    float64."""
    rs = np.random.RandomState(4)
    ns, o, h = 400, 8, 2
    A = rs.randn(o, h)
    z = rs.randn(ns, h)
    Y = (z @ A.T + 0.1 * rs.randn(ns, o)).astype(np.float32)
    rng.seed(0)
    state = convert.bfa_state(JBFA(o, h))
    bfa = convert.bfa_from_state(state, "cpu", torch.float64)
    bfa.raw_update(torch.tensor(Y, dtype=torch.float64), iters=10)
    e = np.asarray(bfa.ELBO_save)
    assert (np.diff(e)[1:] > -np.abs(e[-1]) * 1e-4).all()
    Ahat = bfa.A.mean().numpy()
    proj = Ahat @ np.linalg.pinv(Ahat)
    err = np.linalg.norm(A - proj @ A) / np.linalg.norm(A)
    assert err < 0.1


def moons(n, seed=0):
    rs = np.random.RandomState(seed)
    t = np.pi * rs.rand(n // 2)
    X = np.concatenate([np.stack([np.cos(t), np.sin(t)], -1),
                        np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)]) + 0.08 * rs.randn(n, 2)
    y = np.concatenate([np.zeros(n // 2, int), np.ones(n // 2, int)])
    return X, np.eye(2)[y], y


NETS = {"one layer": ((2,), (4,)), "two layers": ((3, 2), (2, 2))}


@pytest.fixture(scope="module", params=[(net, fbi) for net in NETS for fbi in (True, False)],
                ids=lambda p: f"{p[0]}, FBI {'on' if p[1] else 'off'}")
def bayesnet(request):
    net, fbi = request.param
    hidden, experts = NETS[net]
    X, Y, y = moons(60)
    with jax.enable_x64(True):
        rng.seed(2)
        jm = JBayesNet(2, 2, hidden, experts)
        state = convert.bayesnet_state(jm)
        jm.update(jnp.asarray(X), jnp.asarray(Y), iters=SWEEPS, FBI=fbi)
        ref = np.asarray(jm.predict(jnp.asarray(X)))
        acc = jm.accuracy(jnp.asarray(X), y)
    tm = convert.bayesnet_from_state(state, "cpu", torch.float64)
    before = [(k.launches, k.plain_calls) for k in (*scan.SCANS, ws.WEIGHTED_OUTER)]
    tm.update(torch.tensor(X), torch.tensor(Y), iters=SWEEPS, FBI=fbi)
    after = [(k.launches, k.plain_calls) for k in (*scan.SCANS, ws.WEIGHTED_OUTER)]
    return jm, tm, X, y, ref, acc, before == after


def test_bayesnet_sweeps_match_jax(bayesnet):
    jm, tm, *_ = bayesnet
    assert len(tm.layers) == len(jm.layers)
    for tl, jl in zip(tm.layers, jm.layers):
        compare_nodes(tl.A, jl.A)
        compare_nodes(tl.pi.beta, jl.pi.beta)
    compare_nodes(tm.head.beta, jm.head.beta)


def test_bayesnet_predict_matches_jax(bayesnet):
    _, tm, X, y, ref, acc, _ = bayesnet
    assert rel_dev(tm.predict(torch.tensor(X)), ref) <= TOL
    assert tm.accuracy(torch.tensor(X), y) == acc


def test_bayesnet_sweeps_reach_no_scatter_or_scan(bayesnet):
    """The message path never reaches the weighted scatter or a scan, not
    even their plain versions."""
    assert bayesnet[-1]


def test_bayesnet_state_round_trips(bayesnet):
    _, tm, X, *_ = bayesnet
    again = convert.bayesnet_from_state(convert.bayesnet_state(tm), "cpu", torch.float64)
    assert torch.equal(again.predict(torch.tensor(X)), tm.predict(torch.tensor(X)))


def test_bayesnet_layers_draw_from_their_own_generators():
    """One generator seeds a generator for each layer and the head: the same
    seed builds the same network, and the layers' draws differ."""
    make = lambda s: BayesNet(2, 2, (3, 3), (2, 2), device="cpu",
                              generator=torch.Generator().manual_seed(s))
    a, b, c = make(0), make(0), make(1)
    assert torch.equal(a.layers[1].A.mu, b.layers[1].A.mu)
    assert not torch.equal(a.layers[1].A.mu, c.layers[1].A.mu)
    assert not torch.equal(a.layers[0].A.mu[..., :3, :2], a.layers[1].A.mu[..., :3, :2])
    assert a.head.n == 1 and a.layers[0].A.p == 3 and a.layers[1].A.p == 4


def test_bfa_float32_follows_float64():
    """The same state in float32 and float64 over 3 sweeps: the ELBO and A's
    mean within 1e-4 (the card's comparison, here on the CPU)."""
    Y = factor_data(7, 500, 16, 3)
    state = convert.bfa_state(BayesianFactorAnalysis(
        16, 3, generator=torch.Generator().manual_seed(0), device="cpu"))
    out = {}
    for dtype in (torch.float32, torch.float64):
        m = convert.bfa_from_state(state, "cpu", dtype)
        m.raw_update(torch.tensor(Y, dtype=dtype), iters=SWEEPS)
        out[dtype] = (np.asarray(m.ELBO_save), m.A.mean().double())
    e32, e64 = out[torch.float32][0], out[torch.float64][0]
    assert (np.abs(e32 - e64) / np.abs(e64)).max() <= 1e-4
    assert rel_dev(out[torch.float32][1], out[torch.float64][1].numpy()) <= 1e-4


def test_bayesnet_float32_follows_float64_on_digits():
    """The digits task (benchmarks/classification_bakeoff.py, 1347 training
    digits), hidden (16, 8), experts (4, 4), 3 sweeps from one state in
    float32 and float64: every layer's expert means and the head's weights
    within 1e-5 (which the input layer's update missed in float32; it runs
    in float64), and the float32 model stays float32."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmarks"))
    from classification_bakeoff import load_digits_task

    Xtr, ytr, _, _ = load_digits_task()
    state = convert.bayesnet_state(BayesNet(10, 64, (16, 8), (4, 4), device="cpu",
                                            generator=torch.Generator().manual_seed(1)))
    nets = {}
    for dtype in (torch.float32, torch.float64):
        net = convert.bayesnet_from_state(state, "cpu", dtype)
        net.update(torch.tensor(Xtr, dtype=dtype),
                   torch.tensor(np.eye(10)[ytr], dtype=dtype), iters=SWEEPS)
        nets[dtype] = net
    f, d = nets[torch.float32], nets[torch.float64]
    pairs = [(a.A.mu, b.A.mu) for a, b in zip(f.layers, d.layers)] + [(f.head.beta.mu,
                                                                       d.head.beta.mu)]
    for a, b in pairs:
        assert a.dtype == torch.float32
        assert rel_dev(a.double(), b.numpy()) <= 1e-5
    assert f.layers[0].logZ.dtype == f.layers[0].p.dtype == torch.float32
