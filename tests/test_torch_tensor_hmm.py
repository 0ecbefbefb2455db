"""The port's tensor-state HMMs against the JAX package's, in float64 on the
CPU (the JAX side under the scoped ``jax.enable_x64``; state carried by
``pyvbmp_tpu_torch.utils.convert.tensor_hmm_state``):

- ``tensor_forward_backward`` at state axes (2, 2) and (2, 3, 2), with a
  transition per batch member and one that broadcasts over the batch: p,
  SEzz, SEz0 and logZ;
- ``Tensor_HMM`` (NormalInverseWishart (4,), batch (2, 4), state (2, 4)),
  ``HHMM`` (the same observations, event_dim=2) and
  ``Factorial_HMM(3, (2,), (4,))`` on the HMM-core data recipe
  (``benchmarks/core_models_bench.py:hmm_data``) cut to T=24, batch=6: 3
  sweeps from one state (``update(iters=1)`` then ``update(iters=2)`` on the
  port, one fused ``update(iters=3)`` on JAX), the ELBO trajectory, p,
  ``KLqprior()`` and ``ELBO()``, and the stepwise API;
- the Factorial projection on a random alpha.

Tolerance: max |port - jax| / max |jax| <= 1e-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import dists as JD
from pyvbmp_tpu import models as JM
from pyvbmp_tpu.models.tensor_hmm import tensor_forward_backward as jax_tfb
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu.utils.jaxutils import replace as jreplace
from pyvbmp_tpu_torch import models as PM
from pyvbmp_tpu_torch.dists import NormalInverseWishart
from pyvbmp_tpu_torch.models.tensor_hmm import tensor_forward_backward as port_tfb
from pyvbmp_tpu_torch.utils.convert import tensor_hmm_from_state, tensor_hmm_state
from pyvbmp_tpu_torch.utils.torchutils import replace

TOL = 1e-8
T, BATCH, D, K = 24, 6, 4, 8
SWEEPS = 3


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / np.abs(ref).max()


def hmm_data(seed=0):
    """benchmarks/core_models_bench.py:hmm_data at T=24, batch=6: sticky
    K-state chains seen through Gaussian means."""
    rs = np.random.RandomState(seed)
    mus = rs.randn(K, D) * 3
    z = np.zeros((T, BATCH), np.int64)
    for t in range(1, T):
        stay = rs.rand(BATCH) < 0.9
        z[t] = np.where(stay, z[t - 1], rs.randint(0, K, BATCH))
    return mus[z] + rs.randn(T, BATCH, D)


@pytest.mark.parametrize("event", [(2, 2), (2, 3, 2)])
@pytest.mark.parametrize("per_batch", [False, True])
def test_tensor_forward_backward_matches_jax(event, per_batch):
    rs = np.random.RandomState(len(event) + 2 * per_batch)
    n = int(np.prod(event))
    trans = np.log(rs.dirichlet(np.ones(n), (BATCH, n) if per_batch else n))
    trans = trans.reshape(((BATCH,) if per_batch else ()) + event + event)
    init = np.log(rs.dirichlet(np.ones(n), BATCH)).reshape((BATCH,) + event)
    obs = rs.randn(T, 3, BATCH, *event) * 2
    ed = len(event)
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in jax_tfb(jnp.asarray(trans), jnp.asarray(init),
                                               jnp.asarray(obs), ed, 0.7)]
    out = port_tfb(torch.tensor(trans), torch.tensor(init), torch.tensor(obs), ed, 0.7)
    for name, o, r in zip(("p", "SEzz", "SEz0", "logZ"), out, ref):
        assert rel_dev(o, r) <= TOL, name


def jax_model(kind):
    if kind == "Tensor_HMM":
        return JM.Tensor_HMM(JD.NormalInverseWishart.create((D,), (2, 4)), (2, 4))
    if kind == "HHMM":
        return JM.HHMM(JD.NormalInverseWishart.create((D,), (2, 4)), event_dim=2)
    return JM.Factorial_HMM(3, (2,), (D,))


@pytest.fixture(scope="module", params=["Tensor_HMM", "HHMM", "Factorial_HMM"])
def fitted(request):
    kind = request.param
    X = hmm_data()
    with jax.enable_x64(True):
        rng.seed(1)
        jm = jax_model(kind)
        state = tensor_hmm_state(jm)
        jm.update(jnp.asarray(X), iters=SWEEPS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   KL=np.asarray(jm.KLqprior()), ELBO=np.asarray(jm.ELBO()),
                   NA=np.asarray(jm.NA))
    tm = tensor_hmm_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(torch.tensor(X), iters=1)
    tm.update(torch.tensor(X), iters=SWEEPS - 1)
    return kind, state, ref, tm


def test_state_rebuilds_the_class(fitted):
    kind, _, _, tm = fitted
    assert type(tm) is getattr(PM, kind)
    if kind == "Factorial_HMM":
        assert tm.marg_sum_list == [(-5, -4, -2, -1), (-6, -4, -3, -1), (-6, -5, -3, -2)]


def test_elbo_trajectory_matches_jax(fitted):
    _, _, ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL, (out, ref["elbo"])
    assert out[-1] > out[0]


def test_posteriors_match_jax(fitted):
    _, _, ref, tm = fitted
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.NA, ref["NA"]) <= TOL
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO"]) <= TOL
    assert torch.equal(tm.assignment(), tm.p.argmax(-1))


def test_state_round_trips(fitted):
    _, _, _, tm = fitted
    again = tensor_hmm_from_state(tensor_hmm_state(tm), device="cpu", dtype=torch.float64)
    assert torch.equal(again.p, tm.p)
    assert torch.equal(again.initial.alpha, tm.initial.alpha)
    assert torch.equal(again.transition.loggeomean(), tm.transition.loggeomean())


def test_stepwise_api_matches_jax(fitted):
    """update_states, update_markov_parms (lr, beta) and update_obs_parms
    from the fit's starting state."""
    kind, state, _, _ = fitted
    X = hmm_data(1)
    with jax.enable_x64(True):
        rng.seed(1)
        jm = jax_model(kind)
        SEzz, SEz0, _, logZ = jm.update_states(jnp.asarray(X))
        jm.update_markov_parms(SEzz, SEz0, lr=0.7, beta=0.5)
        jm.update_obs_parms(jnp.asarray(X), lr=0.7)
        ref = dict(logZ=np.asarray(logZ), trans=np.asarray(jm.transition.loggeomean()),
                   init=np.asarray(jm.initial.alpha), KL=np.asarray(jm.KLqprior()))
    tm = tensor_hmm_from_state(state, device="cpu", dtype=torch.float64)
    SEzz, SEz0, _, logZ = tm.update_states(torch.tensor(X))
    tm.update_markov_parms(SEzz, SEz0, lr=0.7, beta=0.5)
    tm.update_obs_parms(torch.tensor(X), lr=0.7)
    for name, got in (("logZ", logZ), ("trans", tm.transition.loggeomean()),
                      ("init", tm.initial.alpha), ("KL", tm.KLqprior())):
        assert rel_dev(got, ref[name]) <= TOL, name


def test_factorial_projection_matches_jax():
    """alpha <- sum_i alpha.mean(factor i's marginal dims) / num_factors, on
    a random alpha, against the JAX package's projection and the formula."""
    rs = np.random.RandomState(2)
    araw = rs.rand(2, 2, 2, 2) + 0.5
    with jax.enable_x64(True):
        rng.seed(0)
        jm = JM.Factorial_HMM(2, (2,), (2,))
        ref = np.asarray(jm._post_markov_update(jreplace(jm.transition,
                                                         alpha=jnp.asarray(araw))).alpha)
    tm = PM.Factorial_HMM(2, (2,), (2,), generator=torch.Generator().manual_seed(0),
                          dtype=torch.float64, device="cpu")
    out = tm._post_markov_update(replace(tm.transition, alpha=torch.tensor(araw))).alpha
    assert rel_dev(out, ref) <= TOL
    expect = araw.mean(axis=(1, 3), keepdims=True) / 2 + araw.mean(axis=(0, 2), keepdims=True) / 2
    assert rel_dev(out, np.broadcast_to(expect, araw.shape)) <= TOL


def test_constructor_checks():
    obs = NormalInverseWishart.create((D,), (4,), generator=torch.Generator().manual_seed(0),
                                      dtype=torch.float64)
    with pytest.raises(ValueError, match="state's axes"):
        PM.Tensor_HMM(obs, (2, 4), device="cpu")
    with pytest.raises(ValueError, match="event_dim"):
        PM.HHMM(obs, event_dim=1, device="cpu")
