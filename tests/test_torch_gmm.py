"""The port's mixtures against the JAX package's, in float64 on the CPU (the
JAX side under the scoped ``jax.enable_x64``; state carried by
``pyvbmp_tpu_torch.utils.convert.gmm_state`` / ``load_state``):

- GaussianMixtureModel with NormalInverseWishart components and isotropic
  (NormalGamma) ones, and PoissonMixtureModel: 3 VB-EM iterations from one
  state (one ``update(iters=1)``, then ``update(iters=2)`` on the port, one
  fused ``update(iters=3)`` on JAX), the ELBO trajectory, the assignments p,
  the component means, ``KLqprior()`` and ``ELBO()``;
- a Mixture whose components carry a batch dim (NIW, batch (2,));
- the NormalGamma node alone: ``raw_update`` with and without weights, its
  likelihood, KL and expectations;
- Mixture's stepwise API (``update_assignments``, ``update_parms``) and its
  averages.

Tolerance: max |port - jax| / max |jax| <= 1e-8.  The data follow
``benchmarks/core_models_bench.py:gmm_data`` at a small size."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import dists as JD
from pyvbmp_tpu import models as JM
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch import dists as PD
from pyvbmp_tpu_torch.models import GaussianMixtureModel, PoissonMixtureModel
from pyvbmp_tpu_torch.utils.convert import gmm_from_state, gmm_state, load_state, node_state

TOL = 1e-8
N, NC, D = 300, 4, 3
ITERS = 3


def gmm_data(seed=0):
    rs = np.random.RandomState(seed)
    mus = rs.randn(NC, D) * 4
    z = rs.randint(0, NC, N)
    return mus[z] + rs.randn(N, D)


def poisson_data(seed=0):
    rs = np.random.RandomState(seed)
    rates = rs.gamma(2.0, 3.0, (NC, D))
    return rs.poisson(rates[rs.randint(0, NC, N)]).astype(np.float64)


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / np.abs(ref).max()


def jax_model(kind):
    if kind == "poisson":
        return JM.PoissonMixtureModel(NC, D)
    return JM.GaussianMixtureModel(NC, D, isotropic=kind == "isotropic")


@pytest.fixture(scope="module", params=["niw", "isotropic", "poisson"])
def fitted(request):
    kind = request.param
    X = poisson_data() if kind == "poisson" else gmm_data()
    with jax.enable_x64(True):
        rng.seed(3)
        jm = jax_model(kind)
        if kind != "poisson":
            jm.initialize(jnp.asarray(X))
        state = gmm_state(jm)
        jm.update(jnp.asarray(X), iters=ITERS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   means=np.asarray(jm.means()), KL=np.asarray(jm.KLqprior()),
                   ELBO=np.asarray(jm.ELBO()), NA=np.asarray(jm.NA))
    tm = gmm_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(torch.tensor(X), iters=1)
    tm.update(torch.tensor(X), iters=ITERS - 1)
    return kind, ref, tm


def test_state_rebuilds_the_component_kind(fitted):
    kind, _, tm = fitted
    want = {"niw": PD.NormalInverseWishart, "isotropic": PD.NormalGamma,
            "poisson": PD.Gamma}[kind]
    assert isinstance(tm.dist, want)
    assert isinstance(tm, PoissonMixtureModel if kind == "poisson" else GaussianMixtureModel)


def test_elbo_trajectory_matches_jax(fitted):
    _, ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (ITERS,)
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL, (out, ref["elbo"])
    assert out[-1] > out[0]


def test_posteriors_match_jax(fitted):
    _, ref, tm = fitted
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.NA, ref["NA"]) <= TOL
    assert rel_dev(tm.means(), ref["means"]) <= TOL
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO"]) <= TOL
    assert torch.equal(tm.assignment(), tm.p.argmax(-1))


def test_state_round_trips(fitted):
    _, _, tm = fitted
    again = gmm_from_state(gmm_state(tm), device="cpu", dtype=torch.float64)
    assert torch.equal(again.dist.mu if hasattr(tm.dist, "mu") else again.dist.alpha,
                       tm.dist.mu if hasattr(tm.dist, "mu") else tm.dist.alpha)
    assert torch.equal(again.pi.alpha, tm.pi.alpha)


def test_batched_mixture_matches_jax():
    """NIW components with a batch dim: dist batch (2, NC), data (N, 2, D)."""
    X = np.stack([gmm_data(1), gmm_data(2)], 1)
    with jax.enable_x64(True):
        rng.seed(4)
        jm = JD.Mixture(JD.NormalInverseWishart.create((D,), (2, NC)), (NC,))
        pi0, dist0 = node_state(jm.pi), node_state(jm.dist)
        jm.update(jnp.asarray(X), iters=ITERS)
        ref_elbo, ref_p = np.asarray(jm.ELBO_save), np.asarray(jm.p)
    g = torch.Generator().manual_seed(0)
    tm = PD.Mixture(PD.NormalInverseWishart.create((D,), (2, NC), generator=g,
                                                   dtype=torch.float64), (NC,), generator=g)
    tm.pi, tm.dist = load_state(tm.pi, pi0), load_state(tm.dist, dist0)
    tm.update(torch.tensor(X), iters=ITERS)
    assert (np.abs(np.asarray(tm.ELBO_save) - ref_elbo) / np.abs(ref_elbo)).max() <= TOL
    assert rel_dev(tm.p, ref_p) <= TOL
    assert tm.ELBO_last.shape == (2,)


def test_stepwise_api_and_averages_match_jax():
    X = gmm_data(5)
    with jax.enable_x64(True):
        rng.seed(5)
        jm = JM.GaussianMixtureModel(NC, D)
        state = gmm_state(jm)
        jx = jnp.asarray(X)
        jm.update_assignments(jx)
        jm.update_parms(jx, lr=0.7)
        jm.update_assignments(jx)
        ref = dict(p=np.asarray(jm.p), logZ=np.asarray(jm.logZ),
                   avg=np.asarray(jm.average(jnp.arange(NC, dtype=jnp.float64))),
                   ev=np.asarray(jm.event_average_f("EinvSigmamu")),
                   like=np.asarray(jm.Elog_like(jx)))
    tm = gmm_from_state(state, device="cpu", dtype=torch.float64)
    tx = torch.tensor(X)
    tm.update_assignments(tx)
    tm.update_parms(tx, lr=0.7)
    tm.update_assignments(tx)
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.logZ, ref["logZ"]) <= TOL
    assert rel_dev(tm.average(torch.arange(NC, dtype=torch.float64)), ref["avg"]) <= TOL
    assert rel_dev(tm.event_average_f("EinvSigmamu"), ref["ev"]) <= TOL
    assert rel_dev(tm.Elog_like(tx), ref["like"]) <= TOL


@pytest.mark.parametrize("weighted", [False, True])
def test_normal_gamma_node_matches_jax(weighted):
    rs = np.random.RandomState(6)
    X = rs.randn(50, 1, D) * 2 + 1
    p = rs.dirichlet(np.ones(NC), 50) if weighted else None
    with jax.enable_x64(True):
        n0 = JD.NormalGamma.create((D,), (NC,), scale=0.5, key=jax.random.key(6))
        n1 = n0.raw_update(jnp.asarray(X), None if p is None else jnp.asarray(p), lr=0.8)
        ref = {name: np.asarray(getattr(n1, name)()) for name in
               ("mean", "Emumu", "ElogdetinvSigma", "EmuTinvSigmamu", "EinvSigma",
                "ESigma", "Res", "EinvSigmamu", "KLqprior")}
        ref["like"] = np.asarray(n1.Elog_like(jnp.asarray(X)))
        ev = n1.to_event(1)
        ref["event_like"] = np.asarray(ev.Elog_like(jnp.asarray(X)))
        state = node_state(n0)
    t0 = load_state(PD.NormalGamma.create((D,), (NC,), scale=0.5, dtype=torch.float64), state)
    t1 = t0.raw_update(torch.tensor(X), None if p is None else torch.tensor(p), lr=0.8)
    for name, want in ref.items():
        if name == "like":
            got = t1.Elog_like(torch.tensor(X))
        elif name == "event_like":
            got = t1.to_event(1).Elog_like(torch.tensor(X))
        else:
            got = getattr(t1, name)()
        assert rel_dev(got, want) <= TOL, name


def test_gmm_initialize_seeds_means_with_data_rows():
    X = torch.tensor(gmm_data())
    m = GaussianMixtureModel(NC, D, generator=torch.Generator().manual_seed(0),
                             dtype=torch.float64, device="cpu")
    m.initialize(X, generator=torch.Generator().manual_seed(1))
    rows = {tuple(r) for r in X.tolist()}
    assert all(tuple(r) in rows for r in m.dist.mu.tolist())
    iso = GaussianMixtureModel(NC, D, isotropic=True, device="cpu")
    iso.initialize(X)
    assert isinstance(iso.dist, PD.NormalGamma)
