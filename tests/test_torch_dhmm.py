"""The port's input-driven HMM (pyvbmp_tpu_torch/models/dhmm.py) and its
two smoothers (the sequential ``driven_forward_backward`` and
``ops.parallel_hmm.driven_forward_backward_parallel``) against the JAX
package's, in float64 on the CPU.

The JAX side runs under the scoped ``jax.enable_x64``; the same numpy inputs
go to both, and the dHMM crosses from JAX to the port through
``utils.convert.dhmm_state``.  Tolerances: max relative deviation 1e-10
for the smoothers (each to its JAX counterpart, and the port's two to each
other), 1e-8 for the 3-sweep fits at the widths of
tests/test_models_hmm_lds.py (test_dhmm_runs: T=40, batch 5, K=3, inputs of
width 2, NormalInverseWishart observations of dimension 2): the ELBO
trajectory, p, the per-time SEzz, KLqprior() and ELBO()."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.dists import NormalInverseWishart as JNIW
from pyvbmp_tpu.models import dHMM as JdHMM
from pyvbmp_tpu.models.dhmm import driven_forward_backward as jax_seq
from pyvbmp_tpu.ops.parallel_hmm import driven_forward_backward_parallel as jax_scan
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists import NormalInverseWishart as TNIW
from pyvbmp_tpu_torch.models import dHMM as TdHMM
from pyvbmp_tpu_torch.models.dhmm import driven_forward_backward
from pyvbmp_tpu_torch.models.hmm import smoother_dispatch
from pyvbmp_tpu_torch.ops.parallel_hmm import driven_forward_backward_parallel
from pyvbmp_tpu_torch.utils.convert import dhmm_from_state, dhmm_state

SMOOTHER_TOL = 1e-10
TOL = 1e-8
SWEEPS = 3
DHMM_CFG = dict(T=40, B=5, K=3, p=2, d=2)


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    fin = np.isfinite(ref)
    assert np.array_equal(np.isfinite(port), fin)
    return np.abs(port[fin] - ref[fin]).max() / np.abs(ref[fin]).max()


@pytest.mark.parametrize("K", [3, 4, 5, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_driven_smoothers_match_jax(K, masked):
    """Per-time transitions with a sample and a batch axis; the masked case
    forbids 0 -> K-1 and K-1 -> 0 at every step."""
    rs = np.random.RandomState(K + 10 * masked)
    T = 13
    trans = np.log(rs.dirichlet(np.ones(K), (T, 5, 2, K)))  # (T, sample, batch)
    if masked:
        trans[..., 0, K - 1] = trans[..., K - 1, 0] = -np.inf
    init = np.log(rs.dirichlet(np.ones(K), 2))
    obs = rs.randn(T, 5, 2, K) * 2.0
    args = (trans, init, obs)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) for a in args]
        refs = [[np.asarray(x) for x in f(*jargs, 0.7)] for f in (jax_seq, jax_scan)]
    targs = [torch.tensor(a) for a in args]
    outs = [f(*targs, 0.7) for f in (driven_forward_backward, driven_forward_backward_parallel)]
    for out, ref in zip(outs, refs):
        for name, o, r in zip(["p", "SEzz", "SEz0", "logZ"], out, ref):
            assert rel_dev(o, r) <= SMOOTHER_TOL, name
    assert outs[1][1].shape == (T, 5, 2, K, K)  # SEzz stays per time step
    for name, a, b in zip(["p", "SEzz", "SEz0", "logZ"], *outs):
        assert rel_dev(a, b.numpy()) <= SMOOTHER_TOL, name
    if masked:
        assert outs[0][1][..., 0, K - 1].abs().max() == 0.0


def dhmm_data(cfg=DHMM_CFG):
    """tests/test_models_hmm_lds.py:test_dhmm_runs's recipe in float64:
    inputs U (T, B, p) and K Gaussian clusters Y (T, B, d)."""
    rs = np.random.RandomState(1)
    U = rs.randn(cfg["T"], cfg["B"], cfg["p"])
    mus = rs.randn(cfg["K"], cfg["d"]) * 3
    z = rs.randint(0, cfg["K"], (cfg["T"], cfg["B"]))
    Y = mus[z] + 0.2 * rs.randn(cfg["T"], cfg["B"], cfg["d"])
    return U, Y


@pytest.fixture(scope="module", params=[False, True], ids=["sequential", "parallel"])
def fitted(request):
    """(JAX outputs, port dHMM) after SWEEPS sweeps from one state, and one
    raw_update_states after them."""
    U, Y = dhmm_data()
    cfg = DHMM_CFG
    with jax.enable_x64(True):
        rng.seed(3)
        jm = JdHMM(JNIW.create((cfg["d"],), batch_shape=(cfg["K"],)), cfg["p"],
                   parallel_scan=request.param)
        state = dhmm_state(jm)
        jm.raw_update(jnp.asarray(U), jnp.asarray(Y), iters=SWEEPS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   KL=np.asarray(jm.KLqprior()), ELBO=np.asarray(jm.ELBO()))
        jm.raw_update_states(jnp.asarray(U)[..., None, :], jnp.asarray(Y)[..., None, :])
        ref.update(SEzz=np.asarray(jm.SEzz), SEz0=np.asarray(jm.SEz0),
                   states_p=np.asarray(jm.p))
    tm = dhmm_from_state(state, device="cpu", dtype=torch.float64)
    assert tm.parallel_scan == request.param
    tm.raw_update(torch.tensor(U), torch.tensor(Y), iters=SWEEPS)
    return ref, tm


def test_elbo_trajectory_matches_jax(fitted):
    ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,) and np.isfinite(out).all()
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL


def test_posteriors_kl_and_elbo_match_jax(fitted):
    ref, tm = fitted
    cfg = DHMM_CFG
    assert tm.p.shape == (cfg["T"], cfg["B"], cfg["K"])
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.KLqprior(), ref["KL"]) <= TOL
    assert rel_dev(tm.ELBO(), ref["ELBO"]) <= TOL


def test_per_time_pair_statistics_match_jax(fitted):
    ref, tm = fitted
    U, Y = dhmm_data()
    tm.raw_update_states(torch.tensor(U)[..., None, :], torch.tensor(Y)[..., None, :])
    cfg = DHMM_CFG
    assert tm.SEzz.shape == (cfg["T"], cfg["B"], cfg["K"], cfg["K"])
    assert rel_dev(tm.SEzz, ref["SEzz"]) <= TOL
    assert rel_dev(tm.SEz0, ref["SEz0"]) <= TOL
    assert rel_dev(tm.p, ref["states_p"]) <= TOL


def test_state_round_trips_through_numpy(fitted):
    _, tm = fitted
    again = dhmm_from_state(dhmm_state(tm), device="cpu", dtype=torch.float64)
    assert (again.parallel_scan, again.ptemp) == (tm.parallel_scan, tm.ptemp)
    assert torch.equal(again.transition.beta.mu, tm.transition.beta.mu)
    assert torch.equal(again.obs_dist.mu, tm.obs_dist.mu)
    assert torch.equal(again.initial.alpha, tm.initial.alpha)
    assert torch.equal(again.p, tm.p)


def test_constructor_slots_and_the_driven_dispatch():
    """(obs_dist, p, transition_mask, ptemp, parallel_scan, time_mesh), as in
    the JAX package; the initial Dirichlet pinned to its prior; the driven
    dispatch follows parallel_scan."""
    g = torch.Generator().manual_seed(0)
    obs = TNIW.create((2,), (3,), generator=g, dtype=torch.float64)
    m = TdHMM(obs, 2, None, 0.5, True, device="cpu", generator=g)
    assert (m.ptemp, m.parallel_scan, m.time_mesh) == (0.5, True, None)
    assert torch.equal(m.initial.alpha, m.initial.alpha_0)
    assert m.transition.beta.mu.shape == (3, 2, 3, 1)  # (source, K-1, p+1, 1)
    assert smoother_dispatch(m, driven=True) is driven_forward_backward_parallel
    assert smoother_dispatch(TdHMM(obs, 2, device="cpu"), driven=True) is driven_forward_backward
    with pytest.raises(TypeError, match="time_mesh"):  # not the port's Mesh
        TdHMM(obs, 2, None, 1.0, False, "a mesh", device="cpu")
    with pytest.raises(TypeError):
        TdHMM(obs, 2, None, 1.0, False, None, g)
