"""The port's HMM shell (pyvbmp_tpu_torch/models/hmm.py) against the JAX
package's, in float64 on the CPU.

The JAX side runs under the scoped ``jax.enable_x64``; the same numpy inputs
go to both.  The standalone HMM with NormalInverseWishart observations
crosses from JAX to the port through ``utils.convert.hmm_state``.
Tolerance: max relative deviation 1e-8 (the smoothers' outputs, the ELBO
trajectory, p, ``KLqprior()`` and ``ELBO()``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.dists import NormalInverseWishart as JNIW
from pyvbmp_tpu.models import HMM as JHMM
from pyvbmp_tpu.models.hmm import forward_backward as jax_fb
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists import NormalInverseWishart as TNIW
from pyvbmp_tpu_torch.models import HMM as THMM
from pyvbmp_tpu_torch.models.hmm import forward_backward, smoother_dispatch
from pyvbmp_tpu_torch.ops.parallel_hmm import forward_backward_parallel
from pyvbmp_tpu_torch.utils.convert import hmm_from_state, hmm_state

TOL = 1e-8
SWEEPS = 3
# the core_hmm config (benchmarks/core_models_bench.py:19) cut to T=24, batch=6
HMM_CFG = dict(T=24, batch=6, K=8, d=4)


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return np.abs(port - ref).max() / np.abs(ref).max()


def hmm_data(cfg, seed=0):
    """benchmarks/core_models_bench.py:hmm_data: sticky K-state chains seen
    through Gaussian means, (T, batch, d)."""
    rs = np.random.RandomState(seed)
    mus = rs.randn(cfg["K"], cfg["d"]) * 3
    z = np.zeros((cfg["T"], cfg["batch"]), np.int64)
    for t in range(1, cfg["T"]):
        stay = rs.rand(cfg["batch"]) < 0.9
        z[t] = np.where(stay, z[t - 1], rs.randint(0, cfg["K"], cfg["batch"]))
    return mus[z] + rs.randn(cfg["T"], cfg["batch"], cfg["d"])


@pytest.mark.parametrize("K", [3, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_forward_backward_matches_jax(K, masked):
    """The sequential smoother with a sample axis and a batch axis."""
    rs = np.random.RandomState(K + 10 * masked)
    trans = np.log(rs.dirichlet(np.ones(K), (2, K)))  # batch (2,)
    if masked:
        trans[:, 0, K - 1] = trans[:, K - 1, 0] = -np.inf
    init = np.log(rs.dirichlet(np.ones(K), 2))
    obs = rs.randn(17, 5, 2, K) * 2.0  # (T, sample, batch, K)
    with jax.enable_x64(True):
        ref = [np.asarray(x) for x in jax_fb(jnp.asarray(trans), jnp.asarray(init),
                                             jnp.asarray(obs), ptemp=0.7)]
    out = forward_backward(torch.tensor(trans), torch.tensor(init), torch.tensor(obs),
                           ptemp=0.7)
    for name, o, r in zip(["p", "SEzz", "SEz0", "logZ"], out, ref):
        assert o.shape == r.shape, name
        assert rel_dev(o, r) <= TOL, name
    if masked:
        assert out[1][..., 0, K - 1].abs().max() == 0.0


@pytest.fixture(scope="module", params=[False, True], ids=["sequential", "parallel"])
def fitted(request):
    """(JAX HMM, port HMM) after SWEEPS sweeps from one state, and the
    port's ELBO() and KLqprior() read before and after."""
    y = hmm_data(HMM_CFG)
    with jax.enable_x64(True):
        rng.seed(3)
        jm = JHMM(JNIW.create((HMM_CFG["d"],), (HMM_CFG["K"],)),
                  parallel_scan=request.param)
        state = hmm_state(jm)
        jm.update(jnp.asarray(y), iters=SWEEPS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   KL=np.asarray(jm.KLqprior()), ELBO=np.asarray(jm.ELBO()))
    tm = hmm_from_state(state, device="cpu", dtype=torch.float64)
    assert tm.parallel_scan == request.param
    tm.update(torch.tensor(y), iters=SWEEPS)
    return ref, tm


def test_elbo_trajectory_matches_jax(fitted):
    ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert np.isfinite(out).all()
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL


def test_posteriors_match_jax(fitted):
    ref, tm = fitted
    assert tm.p.shape == (HMM_CFG["T"], HMM_CFG["batch"], HMM_CFG["K"])
    assert rel_dev(tm.p, ref["p"]) <= TOL


def test_klqprior_and_elbo_match_jax(fitted):
    ref, tm = fitted
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO"]) <= TOL


def test_state_round_trips_through_numpy(fitted):
    _, tm = fitted
    again = hmm_from_state(hmm_state(tm), device="cpu", dtype=torch.float64)
    assert again.parallel_scan == tm.parallel_scan
    assert torch.equal(again.obs_dist.mu, tm.obs_dist.mu)
    assert torch.equal(again.transition.alpha, tm.transition.alpha)
    assert torch.equal(again.p, tm.p)


def test_constructor_positional_slots():
    """(obs_dist, transition_mask, ptemp, parallel_scan, time_mesh), as in
    the JAX package; generator, dtype and device only by keyword."""
    obs = TNIW.create((2,), (3,), generator=torch.Generator().manual_seed(0),
                      dtype=torch.float64)
    mask = torch.ones(3, 3)
    m = THMM(obs, mask, 0.5, True, device="cpu")
    assert (m.ptemp, m.parallel_scan, m.time_mesh) == (0.5, True, None)
    assert smoother_dispatch(m) is forward_backward_parallel
    assert THMM(obs, device="cpu").parallel_scan is False
    assert smoother_dispatch(THMM(obs, device="cpu")) is forward_backward
    with pytest.raises(NotImplementedError):
        THMM(obs, None, 1.0, False, "a mesh", device="cpu")
    with pytest.raises(TypeError):
        THMM(obs, None, 1.0, False, None, torch.Generator())


def test_parallel_and_sequential_smoothers_agree():
    """The two routes smoother_dispatch picks compute the same thing (the
    scan route through the plain logsemiring scan on the CPU)."""
    rs = np.random.RandomState(1)
    K = 6
    trans = torch.tensor(np.log(rs.dirichlet(np.ones(K), K)))
    init = torch.tensor(np.log(rs.dirichlet(np.ones(K))))
    obs = torch.tensor(rs.randn(20, 4, K))
    for a, b in zip(forward_backward(trans, init, obs),
                    forward_backward_parallel(trans, init, obs)):
        assert rel_dev(a, b.numpy()) <= TOL
