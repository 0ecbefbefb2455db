"""The port's conjugate nodes against the JAX package's, in float64 on the
CPU (the JAX side under the scoped ``jax.enable_x64``; a node's state goes
to the port through ``pyvbmp_tpu_torch.utils.convert.node_state`` and
``load_state``).

Each case builds one node in both packages from one state, runs the same
updates on the same numpy statistics or data (``ss_update``, or
``raw_update`` / ``update`` with and without weights, with ``lr`` and
``beta``), and compares every expectation, the KL and the likelihoods:

- Wishart, WishartEigh, WishartUnitDet, WishartUnitTrace (``d``, ``invU``,
  ``U`` and ``nu``, never the eigenvectors ``v``), ``to_event``;
- DiagonalWishart and DiagonalWishartUnitTrace;
- MatrixNormalGamma with and without ``pad_X``, MatrixNormalGamma_UnitTrace
  (the expectation suite, ``Elog_like``, ``forward``);
- Hierarchical_Dirichlet, Transition and HierarchicalTransition;
- MultivariateNormal_vector_format (``raw_update``, ``combiner``,
  ``nat_combiner``, ``Elog_like``) and MultivariateNormal (matrix layout);
- NormalInverseWishart_vector_format and its ``_invSigma`` variant
  (``raw_update`` and the message ``update``);
- GMM_vector: ``initialize`` and 3 iterations through ``convert.gmm_state``;
- the methods that the port's classes lacked against the JAX package's
  (``tests/test_torch_api.py`` keeps that list empty): Dirichlet's and
  Transition's ``raw_update``/``update``/``Elog_like``/``to_event``/``var``/
  ``logZ`` (and the (3, 3) Transition updated from counts of shape
  (10, 3, 3, 3, 3)), NormalInverseWishart's ``EX``/``ESigma``/``EXXT``/
  ``EinvUX``/``to_event``, Gamma's ``ElogX``/``entropy``/``logZprior``/
  ``var``, Delta's expectations and reshapes, MatrixNormalWishart's and
  MatrixNormalGamma's (UnitTrace too) point estimates, messages and
  expectation suite, and the shape properties.

Tolerance: max |port - jax| / max |jax| <= 1e-8 (1e-8 absolute for an
output that vanishes by construction).  The same nodes on the card against
the CPU: ``tests/test_torch_kernels.py::test_node_suite_on_the_card_follows_the_cpu``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import dists as JD
from pyvbmp_tpu import transforms as JT
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch import dists as PD
from pyvbmp_tpu_torch import transforms as PT
from pyvbmp_tpu_torch.utils.convert import gmm_from_state, gmm_state, load_state, node_state

TOL = 1e-8
F64 = dict(dtype=torch.float64, device="cpu")
S, B, D = 40, 3, 4  # samples, batch, event width


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def spd(rs, shape, d, n=12):
    W = rs.randn(*shape, d, n)
    return W @ np.swapaxes(W, -1, -2)


def _numpy(out):
    return {k: np.asarray(v) for k, v in out.items()}


# -- the cases: (JAX node, port node, the operations run on both) ---------------
# ``ops(node, A, lib)`` gets a node of either package, the package's array
# constructor A and its dists module (for message types); it returns a dict of
# arrays.
WISHART_EXP = ("mean", "meaninv", "ESigma", "EinvSigma", "invEinvSigma", "ElogdetinvSigma",
               "logdetEinvSigma", "KLqprior", "logZ")


def wishart_ops(beta):
    def ops(n, A, lib):
        rs = np.random.RandomState(1)
        N = np.array([10.0, 0.5, 7.0])  # an entry <= 1: the eigh nodes drop its SExx
        n1 = n.ss_update(A(spd(rs, (B,), D)), A(N), lr=0.8, beta=beta)
        out = {k: getattr(n1, k)() for k in WISHART_EXP}
        out["to_event"] = n1.to_event(1).KLqprior()
        out["nu"] = n1.nu
        if hasattr(n1, "d"):
            out.update(d=n1.d, invU=n1.invU, U=n1.U, trace_inv=n1.ETraceinvSigma(),
                       trace=n1.ETraceSigma())
        return out
    return ops


def diag_wishart_ops(n, A, lib):
    rs = np.random.RandomState(2)
    n1 = n.ss_update(A(rs.rand(B, D) * 5), A(rs.rand(B, 1) * 10 + 1), lr=0.9, beta=0.4)
    out = {k: getattr(n1, k)() for k in ("ESigma", "EinvSigma", "ElogdetinvSigma",
                                         "logdetEinvSigma", "mean", "invEinvSigma",
                                         "KLqprior", "logZ")}
    out["to_event"] = n1.to_event(1).KLqprior()
    return out


def mng_ops(weighted, pad):
    def ops(n, A, lib):
        rs = np.random.RandomState(3)
        p = n.p - int(pad)
        X = rs.randn(S, 2, p, 1)
        Y = rs.randn(4, p) @ X * 0.7 + 0.3 * rs.randn(S, 2, 4, 1) + 0.5
        w = A(rs.rand(S, 2)) if weighted else None
        n1 = n.raw_update(A(X), A(Y), p=w, lr=0.9, beta=0.5)
        M = A(spd(rs, (2,), 4))
        out = {k: getattr(n1, k)() for k in (
            "EinvUX", "EXTinvUX", "EXTX", "EXXT", "ElogdetinvU", "ElogdetinvSigma",
            "EinvSigma", "ESigma", "invEinvSigma", "KLqprior")}
        out.update(mu=n1.mu, V=n1.V, EXTAX=n1.EXTAX(M), EXmMUTAXmMU=n1.EXmMUTAXmMU(M),
                   like=n1.Elog_like(A(X), A(Y)))
        pX = lib.MultivariateNormal_vector_format(
            mu=A(X[:5]), Sigma=A(np.broadcast_to(0.1 * np.eye(p), (5, 2, p, p)).copy()))
        pY = n1.forward(pX)[0]
        out.update(fwd_invSigma=pY.EinvSigma(), fwd_invSigmamu=pY.EinvSigmamu())
        return out
    return ops


def hd_ops(weighted):
    def ops(n, A, lib):
        rs = np.random.RandomState(4)
        X = rs.dirichlet(np.ones(24), (S, 2)).reshape(S, 2, 3, 4, 2)
        w = A(rs.rand(S, 2)) if weighted else None
        n1 = n.raw_update(A(X), p=w, lr=0.8, beta=0.5).raw_update(A(X), p=w, beta=0.5)
        out = dict(mean=n1.mean(), loggeomean=n1.loggeomean(), KL=n1.KLqprior(), NA=n1.NA)
        out.update({f"alpha{i}": d.alpha for i, d in enumerate(n1.dists)})
        return out
    return ops


def transition_ops(n, A, lib):
    rs = np.random.RandomState(5)
    NA = rs.rand(2, 2, 3, 2, 3) * 4
    n1 = n.ss_update(A(NA), lr=0.7, beta=0.5)
    logits, obs = A(rs.randn(5, 2, 2, 3)), A(rs.randn(5, 2, 2, 3))
    sm, xi = n1.backward_smoothe(logits, obs)
    X = A(rs.dirichlet(np.ones(6), (5, 2)).reshape(5, 2, 2, 3))
    return dict(loggeomean=n1.loggeomean(), KL=n1.KLqprior(), mean=n1.mean(),
                filter=n1.forward_filter(logits, obs), smoothed=sm, xi=xi,
                log_forward=n1.log_forward(logits), log_backward=n1.log_backward(obs),
                like=n1.Elog_like(X, X))


def htransition_ops(weighted):
    def ops(n, A, lib):
        rs = np.random.RandomState(6)
        X = rs.dirichlet(np.ones(36), (S, 2)).reshape(S, 2, 2, 3, 2, 3)
        # the node's batch shape ends in the source state's axes
        w = A(rs.rand(S, 2, 2, 3)) if weighted else None
        n1 = n.raw_update(A(X), p=w, lr=0.9, beta=0.5).raw_update(A(X), p=w, beta=0.5)
        out = dict(mean=n1.mean(), loggeomean=n1.loggeomean(), KL=n1.KLqprior(),
                   marginal=n1.marginal(-1), like=n1.Elog_like(A(X * 3)))
        out.update({f"alpha{i}": d.alpha for i, d in enumerate(n1.dists)})
        return out
    return ops


def mvn_vf_ops(weighted):
    def ops(n, A, lib):
        rs = np.random.RandomState(7)
        X = rs.randn(S, B, D, 1) * 2 + 1
        w = A(rs.rand(S, B)) if weighted else None
        n1 = n.raw_update(A(X), p=w)
        other = lib.MultivariateNormal_vector_format(
            invSigma=A(spd(rs, (B,), D)), invSigmamu=A(rs.randn(B, D, 1)))
        c = n1.combiner(other)
        nc = n1.nat_combiner(A(spd(rs, (B,), D)), A(rs.randn(B, D, 1)))
        out = {k: getattr(n1, k)() for k in ("mean", "ESigma", "EinvSigma", "EinvSigmamu",
                                             "ElogdetinvSigma", "EXXT", "EXTX", "Res",
                                             "KLqprior")}
        out.update(like=n1.Elog_like(A(X)), event_like=n1.to_event(1).Elog_like(A(X)),
                   c_mean=c.mean(), c_Sigma=c.ESigma(), nc_mean=nc.mean(),
                   nc_logdet=nc.ElogdetinvSigma())
        return out
    return ops


def mvn_ops(weighted):
    def ops(n, A, lib):
        rs = np.random.RandomState(8)
        X = rs.randn(S, B, D) * 2 - 1
        w = A(rs.rand(S, B)) if weighted else None
        n1 = n.raw_update(A(X), p=w)
        nat = lib.MultivariateNormal(invSigma=A(spd(rs, (B,), D)), invSigmamu=A(rs.randn(B, D)))
        out = {k: getattr(n1, k)() for k in ("mean", "ESigma", "EinvSigma", "EinvSigmamu",
                                             "ElogdetinvSigma", "EXXT", "EXTX", "KLqprior")}
        out.update(like=n1.Elog_like(A(X)), event_like=n1.to_event(1).Elog_like(A(X)),
                   nat_mean=nat.mean(), nat_logdet=nat.ElogdetinvSigma(),
                   nat_EXXT=nat.EXXT())
        return out
    return ops


NIW_EXP = ("mean", "EXXT", "EinvSigma", "ESigma", "ElogdetinvSigma", "EinvSigmamu",
           "EinvUX", "EXTinvUX", "EXmMUTinvUXmMU", "KLqprior")


def niw_vf_ops(weighted, beta, message):
    def ops(n, A, lib):
        rs = np.random.RandomState(9)
        X = rs.randn(S, B, D, 1) * 1.5 + 2
        w = A(rs.rand(S, B)) if weighted else None
        if message:
            pX = lib.MultivariateNormal_vector_format(
                mu=A(X), Sigma=A(np.broadcast_to(0.2 * np.eye(D), (S, B, D, D)).copy()))
            n1 = n.update(pX, p=w, lr=0.8, beta=beta)
        else:
            n1 = n.raw_update(A(X), p=w, lr=0.8, beta=beta)
        out = {k: getattr(n1, k)() for k in NIW_EXP}
        out.update(like=n1.Elog_like(A(X)), event_KL=n1.to_event(1).KLqprior())
        if hasattr(n1, "xi"):
            out.update(logZ=n1.logZ(), logdetEinvSigma=n1.logdetEinvSigma(), U=n1.U,
                       invU=n1.invU)
        return out
    return ops


KEY = jax.random.key(11)
NIW_PRIOR = {"lambda": 2.0, "lambda_mu": 0.5, "nu": D + 3.0, "invU": 1.5 * np.eye(D)}
CASES = {
    **{f"Wishart beta={b}": (lambda: JD.Wishart.create((D, D), (B,), scale=0.7),
                             lambda: PD.Wishart.create((D, D), (B,), scale=0.7, **F64),
                             wishart_ops(b)) for b in (None, 0.5)},
    **{f"{name} beta={b}": (
        lambda name=name: getattr(JD, name).create((D, D), (B,), scale=0.7, key=KEY),
        lambda name=name: getattr(PD, name).create((D, D), (B,), scale=0.7, **F64),
        wishart_ops(b))
       for name in ("WishartEigh", "WishartUnitDet", "WishartUnitTrace") for b in (None, 0.3)},
    **{name: (lambda name=name: getattr(JD, name).create((D,), (B,), scale=0.7, key=KEY),
              lambda name=name: getattr(PD, name).create((D,), (B,), scale=0.7, **F64),
              diag_wishart_ops)
       for name in ("DiagonalWishart", "DiagonalWishartUnitTrace")},
    **{f"{name} pad_X={pad} weighted={wt}": (
        lambda name=name, pad=pad: getattr(JT, name).create((4, 3), (2,), pad_X=pad, key=KEY),
        lambda name=name, pad=pad: getattr(PT, name).create((4, 3), (2,), pad_X=pad, **F64),
        mng_ops(wt, pad))
       for name, pad in (("MatrixNormalGamma", False), ("MatrixNormalGamma", True),
                         ("MatrixNormalGamma_UnitTrace", True)) for wt in (False, True)},
    **{f"Hierarchical_Dirichlet weighted={wt}": (
        lambda: JD.Hierarchical_Dirichlet.create((3, 4, 2), (2,), key=KEY),
        lambda: PD.Hierarchical_Dirichlet.create((3, 4, 2), (2,), **F64),
        hd_ops(wt)) for wt in (False, True)},
    "Transition": (lambda: JT.Transition.create((2, 3), (2,), key=KEY),
                   lambda: PT.Transition.create((2, 3), (2,), **F64), transition_ops),
    **{f"HierarchicalTransition weighted={wt}": (
        lambda: JT.HierarchicalTransition.create((2, 3), (2,), key=KEY),
        lambda: PT.HierarchicalTransition.create((2, 3), (2,), **F64),
        htransition_ops(wt)) for wt in (False, True)},
    **{f"NormalInverseWishart_vector_format weighted={wt} message={msg}": (
        lambda: JD.NormalInverseWishart_vector_format.create(
            (D, 1), (B,), scale=0.8, prior_parms=NIW_PRIOR),
        lambda: PD.NormalInverseWishart_vector_format.create(
            (D, 1), (B,), scale=0.8, prior_parms=NIW_PRIOR, **F64),
        niw_vf_ops(wt, 0.2, msg)) for wt in (False, True) for msg in (False, True)},
    **{f"NormalInverseWishart_vector_format_invSigma weighted={wt} beta={b}": (
        lambda: JD.NormalInverseWishart_vector_format_invSigma.create(
            (D, 1), (B,), scale=0.8, prior_parms={"lambda": 2.0, "lambda_mu": 0.5}),
        lambda: PD.NormalInverseWishart_vector_format_invSigma.create(
            (D, 1), (B,), scale=0.8, prior_parms={"lambda": 2.0, "lambda_mu": 0.5}, **F64),
        niw_vf_ops(wt, b, False)) for wt in (False, True) for b in (0.0, 0.5)},
}


def _mvn_vf(A, lib):
    rs = np.random.RandomState(12)
    return lib.MultivariateNormal_vector_format(mu=A(rs.randn(B, D, 1)),
                                                Sigma=A(spd(rs, (B,), D)))


def _mvn(A, lib):
    rs = np.random.RandomState(13)
    return lib.MultivariateNormal(mu=A(rs.randn(B, D)), Sigma=A(spd(rs, (B,), D)))


# message types: built from numpy in both packages, no state to carry
MESSAGE_CASES = {
    **{f"MultivariateNormal_vector_format weighted={wt}": (_mvn_vf, mvn_vf_ops(wt))
       for wt in (False, True)},
    **{f"MultivariateNormal weighted={wt}": (_mvn, mvn_ops(wt)) for wt in (False, True)},
}


def _compare(out, ref):
    """Every output within TOL of the JAX one, relative to its largest
    entry; an output that vanishes by construction (WishartUnitDet's
    <logdet Sigma^-1>, ~1e-15) is held to TOL absolute."""
    assert out.keys() == ref.keys()
    for k in ref:
        if np.abs(ref[k]).max() < 1e-6:
            assert np.abs(out[k] - ref[k]).max() <= TOL, k
        else:
            assert rel_dev(out[k], ref[k]) <= TOL, k


@pytest.mark.parametrize("name", list(CASES))
def test_node_matches_jax(name):
    make_jax, make_port, ops = CASES[name]
    with jax.enable_x64(True):
        jn = make_jax()
        state = node_state(jn)
        ref = _numpy(ops(jn, jnp.asarray, JD))
    tn = load_state(make_port(), state)
    _compare(_numpy(ops(tn, torch.tensor, PD)), ref)


@pytest.mark.parametrize("name", list(MESSAGE_CASES))
def test_message_matches_jax(name):
    make, ops = MESSAGE_CASES[name]
    with jax.enable_x64(True):
        ref = _numpy(ops(make(jnp.asarray, JD), jnp.asarray, JD))
    _compare(_numpy(ops(make(torch.tensor, PD), torch.tensor, PD)), ref)


@pytest.mark.parametrize("name", ["Wishart", "WishartEigh", "Hierarchical_Dirichlet",
                                  "HierarchicalTransition", "MatrixNormalGamma_UnitTrace",
                                  "NormalInverseWishart_vector_format_invSigma"])
def test_node_state_round_trips(name):
    """A node carried through node_state/load_state keeps every tensor (a
    list of sub-nodes included) and its class."""
    make = next(v[1] for k, v in CASES.items() if k.split(" ")[0] == name)
    a = make()
    b = load_state(make(), node_state(a))
    assert type(b) is type(a)
    flat_a, flat_b = node_state(a), node_state(b)

    def same(x, y):
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, list):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return (x is None and y is None) or np.array_equal(x, y)

    assert same(flat_a, flat_b)


def test_unit_trace_variants_hold_their_constraint():
    """Tr(<Sigma^-1>) = dim after an update (the Newton solves converge)."""
    rs = np.random.RandomState(14)
    SExx, N = torch.tensor(spd(rs, (B,), D)), torch.tensor([10.0, 6.0, 7.0])
    w = PD.WishartUnitTrace.create((D, D), (B,), **F64).ss_update(SExx, N)
    assert torch.allclose(w.ETraceinvSigma(), torch.full((B,), float(D), dtype=torch.float64))
    dw = PD.DiagonalWishartUnitTrace.create((D,), (B,), **F64).ss_update(
        torch.tensor(rs.rand(B, D) * 5), torch.tensor(rs.rand(B, 1) * 10 + 1))
    assert torch.allclose(dw.gamma.mean().sum(-1), torch.full((B,), float(D),
                                                             dtype=torch.float64))
    ud = PD.WishartUnitDet.create((D, D), (B,), **F64).ss_update(SExx, N)
    assert ud.ElogdetinvSigma().abs().max() < 1e-6


NC = 4


@pytest.fixture(scope="module")
def gmm_vector_fit():
    rs = np.random.RandomState(15)
    mus = rs.randn(NC, D) * 4
    X = (mus[rs.randint(0, NC, 200)] + rs.randn(200, D))[..., None]
    with jax.enable_x64(True):
        rng.seed(15)
        jm = JD.GMM_vector(NC, D)
        jm.initialize(jnp.asarray(X))
        state = gmm_state(jm)
        jm.update(jnp.asarray(X), iters=3)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   KL=np.asarray(jm.KLqprior()), ELBO=np.asarray(jm.ELBO()))
    tm = gmm_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(torch.tensor(X), iters=1)
    tm.update(torch.tensor(X), iters=2)
    return X, ref, tm


def test_gmm_vector_matches_jax(gmm_vector_fit):
    _, ref, tm = gmm_vector_fit
    assert isinstance(tm, PD.GMM_vector)
    out = np.asarray(tm.ELBO_save)
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL
    assert out[-1] > out[0]
    for k, got in (("p", tm.p), ("KL", tm.KLqprior()), ("ELBO", tm.ELBO())):
        assert rel_dev(got, ref[k]) <= TOL, k


def test_gmm_vector_initialize_keeps_invU(gmm_vector_fit):
    """initialize seeds the means with data rows and leaves invU as it was."""
    X = torch.tensor(gmm_vector_fit[0])
    m = PD.GMM_vector(NC, D, generator=torch.Generator().manual_seed(0), **F64)
    invU = m.dist.invU
    m.initialize(X, generator=torch.Generator().manual_seed(1))
    rows = {tuple(r) for r in X[..., 0].tolist()}
    assert all(tuple(r) in rows for r in m.dist.mu[..., 0].tolist())
    assert torch.allclose(m.dist.invU, invU)



# -- the methods the port lacked (the public-attribute diff's repairs) ------------
def dirichlet_repair_ops(weighted):
    def ops(n, A, lib):
        rs = np.random.RandomState(21)
        shape = (S,) + n.batch_shape + n.event_shape
        X = rs.rand(*shape) * 3
        w = A(rs.rand(S, *n.batch_shape)) if weighted else None
        n1 = n.raw_update(A(X), p=w, lr=0.8, beta=0.5).update(A(X), p=w, beta=0.5)
        out = dict(alpha=n1.alpha, NA=n1.NA, var=n1.var(), logZ=n1.logZ(),
                   to_event=np.asarray(n1.to_event(1).event_shape))
        if type(n).__name__ == "Dirichlet":  # Transition's KL and likelihood differ
            out.update(like=n1.Elog_like(A(X)), to_event_KL=n1.to_event(1).KLqprior())
        return out
    return ops


def niw_repair_ops(n, A, lib):
    rs = np.random.RandomState(22)
    n1 = n.raw_update(A(rs.randn(S, B, D) + 1.0), lr=0.9)
    return dict(EX=n1.EX(), ESigma=n1.ESigma(), EXXT=n1.EXXT(), EinvUX=n1.EinvUX(),
                to_event=n1.to_event(1).KLqprior())


def gamma_repair_ops(n, A, lib):
    rs = np.random.RandomState(23)
    n1 = n.ss_update(A(rs.rand(B, D) * 3), A(rs.rand(B, D) * 3), lr=0.9)
    return dict(ElogX=n1.ElogX(), entropy=n1.entropy(), logZprior=n1.logZprior(),
                var=n1.var())


MNW_REPAIRED = ("weights", "bias", "var", "logdetEinvSigma", "ElogdetinvU", "EXinvVXT",
                "EXmMUTinvUXmMU", "EXmMUinvVXmMUT", "EXTX", "EXXT", "EXTinvUX")


def mnw_repair_ops(pad):
    def ops(n, A, lib):
        rs = np.random.RandomState(24)
        p = n.p - int(pad)
        X = rs.randn(S, 2, p, 1)
        Y = rs.randn(4, p) @ X * 0.7 + 0.3 * rs.randn(S, 2, 4, 1) + 0.5
        n1 = n.raw_update(A(X), A(Y), p=A(rs.rand(S, 2)), lr=0.9)
        M4, Mp = A(spd(rs, (2,), 4)), A(spd(rs, (2,), n.p))
        out = {k: getattr(n1, k)() for k in MNW_REPAIRED}
        out.update(EXTAX=n1.EXTAX(M4), EXmMUTAXmMU=n1.EXmMUTAXmMU(M4), EXAXT=n1.EXAXT(Mp),
                   EXmMUAXmMUT=n1.EXmMUAXmMUT(Mp), to_event=n1.to_event(1).KLqprior())
        pX = lib.MultivariateNormal_vector_format(
            mu=A(X[:5]), Sigma=A(np.broadcast_to(0.1 * np.eye(p), (5, 2, p, p)).copy()))
        ef = n1.Eforward(pX)
        out.update(Eforward_invSigma=ef.EinvSigma(), Eforward_invSigmamu=ef.EinvSigmamu())
        post, res = n1.postdict(A(Y[:5]))
        out.update(postdict_invSigma=post.EinvSigma(), postdict_invSigmamu=post.EinvSigmamu(),
                   postdict_Res=res)
        if type(n).__name__ == "MatrixNormalWishart":  # MNG's forward has no residual
            pY, res = n1.predict_given_pX(pX)
            out.update(pgx_mu=pY.mean(), pgx_Sigma=pY.ESigma(), pgx_Res=res)
        return out
    return ops


REPAIR_CASES = {
    **{f"Dirichlet weighted={wt}": (
        lambda: JD.Dirichlet.create((D,), (B,), key=KEY),
        lambda: PD.Dirichlet.create((D,), (B,), **F64), dirichlet_repair_ops(wt))
       for wt in (False, True)},
    **{f"Transition weighted={wt}": (
        lambda: JT.Transition.create((2, 3), (2,), key=KEY),
        lambda: PT.Transition.create((2, 3), (2,), **F64), dirichlet_repair_ops(wt))
       for wt in (False, True)},
    "NormalInverseWishart": (lambda: JD.NormalInverseWishart.create((D,), (B,), key=KEY),
                             lambda: PD.NormalInverseWishart.create((D,), (B,), **F64),
                             niw_repair_ops),
    "Gamma": (lambda: JD.Gamma.create((D,), (B,), key=KEY),
              lambda: PD.Gamma.create((D,), (B,), **F64), gamma_repair_ops),
    **{f"{name} pad_X={pad}": (
        lambda name=name, pad=pad: getattr(JT, name).create((4, 3), (2,), pad_X=pad, key=KEY),
        lambda name=name, pad=pad: getattr(PT, name).create((4, 3), (2,), pad_X=pad, **F64),
        mnw_repair_ops(pad))
       for name in ("MatrixNormalWishart", "MatrixNormalGamma", "MatrixNormalGamma_UnitTrace")
       for pad in (False, True)},
}


@pytest.mark.parametrize("name", list(REPAIR_CASES))
def test_repaired_methods_match_jax(name):
    make_jax, make_port, ops = REPAIR_CASES[name]
    with jax.enable_x64(True):
        jn = make_jax()
        state = node_state(jn)
        ref = _numpy(ops(jn, jnp.asarray, JD))
    tn = load_state(make_port(), state)
    _compare(_numpy(ops(tn, torch.tensor, PD)), ref)


def test_delta_matches_jax():
    rs = np.random.RandomState(25)
    X, M = rs.rand(S, 2, D, 1) + 0.1, spd(rs, (), D)

    def ops(lib, A):
        d = lib.Delta(A(X))
        return dict(E=d.E(lambda x: x * 2.0), EXX=d.EXX(), EXTX=d.EXTX(), EXTAX=d.EXTAX(A(M)),
                    ElogX=d.ElogX(), sum=d.sum(1), sum_keep=d.sum(0, keepdim=True),
                    cumsum=d.cumsum(0), unsqueeze=d.unsqueeze(-3).X,
                    squeeze=d.unsqueeze(1).squeeze(1).X)

    with jax.enable_x64(True):
        ref = _numpy(ops(JD, jnp.asarray))
    _compare(_numpy(ops(PD, torch.tensor)), ref)


def test_transition_updates_from_tensor_counts():
    """A (3, 3)-state Transition updated from counts of shape
    (10, 3, 3, 3, 3) gives a node in both packages, with the same alpha."""
    X = np.random.RandomState(26).rand(10, 3, 3, 3, 3)
    with jax.enable_x64(True):
        jn = JT.Transition.create((3, 3), key=KEY)
        state = node_state(jn)
        jn = jn.raw_update(jnp.asarray(X))
        ref = np.asarray(jn.alpha)
    tn = load_state(PT.Transition.create((3, 3), **F64), state).raw_update(torch.tensor(X))
    assert isinstance(tn, PT.Transition) and isinstance(jn, JT.Transition)
    assert rel_dev(tn.alpha, ref) <= TOL


def test_repaired_shapes_and_stubs():
    """The shape properties; Hierarchical_Dirichlet.marginal raising as in
    the JAX package; LDS/DMBD.set_latent_parms a no-op."""
    from pyvbmp_tpu_torch import models as PM

    with jax.enable_x64(True):
        jnodes = [getattr(JD, n).create((D, D), (B, 2), key=KEY) if n != "Wishart"
                  else JD.Wishart.create((D, D), (B, 2))
                  for n in ("Wishart", "WishartEigh", "WishartUnitDet", "WishartUnitTrace")]
        jnodes += [getattr(JD, n).create((D,), (B,), key=KEY)
                   for n in ("DiagonalWishart", "DiagonalWishartUnitTrace")]
        jshapes = [(n.batch_dim, n.event_dim) for n in jnodes]
        jm = JD.MultivariateNormal_vector_format(mu=jnp.zeros((S, B, D, 1)))
        assert jm.ndim == 4
        with pytest.raises(NotImplementedError):
            JD.Hierarchical_Dirichlet.create((3, 2), key=KEY).marginal(0)
    pnodes = [getattr(PD, n).create((D, D), (B, 2), **F64)
              for n in ("Wishart", "WishartEigh", "WishartUnitDet", "WishartUnitTrace")]
    pnodes += [getattr(PD, n).create((D,), (B,), **F64)
               for n in ("DiagonalWishart", "DiagonalWishartUnitTrace")]
    assert [(n.batch_dim, n.event_dim) for n in pnodes] == jshapes == [(2, 2)] * 4 + [(1, 1)] * 2
    assert PD.MultivariateNormal_vector_format(mu=torch.zeros(S, B, D, 1)).ndim == 4
    with pytest.raises(NotImplementedError):
        PD.Hierarchical_Dirichlet.create((3, 2), **F64).marginal(0)
    lds = PM.LinearDynamicalSystems((3,), 2, device="cpu")
    dmbd = PM.DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2), device="cpu")
    assert lds.set_latent_parms() is None and dmbd.set_latent_parms() is None
