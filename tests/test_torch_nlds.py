"""The port's recurrent switching LDS (pyvbmp_tpu_torch/models/nlds.py) and
its Kalman smoother on per-time potentials against the JAX package's, in
float64 on the CPU.

The JAX side runs under the scoped ``jax.enable_x64``; the same numpy inputs
go to both, and the NLDS crosses from JAX to the port through
``utils.convert.nlds_state`` with one q(s) set on both models (so no side
draws the symmetry-breaking start).  Data: the two-regime rotation recipe of
examples/nlds_example.py (obs 3, hidden 2) cut to T=40, batch 3, switching
every 10 steps.  Tolerances, max relative deviation: 1e-10 for the
smoother on per-time potentials at h = 2 (the lane form) and h = 4 (the
plane form); 1e-7 for the 3-sweep fit (the ELBO trajectory, p and px.mu;
measured ~1e-14, the MNLR's Polya-Gamma iterations included)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import NLDS as JNLDS
from pyvbmp_tpu.ops.parallel_kalman import parallel_kalman_smoother as jax_kalman
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.dists import NormalInverseWishart as TNIW
from pyvbmp_tpu_torch.models import NLDS
from pyvbmp_tpu_torch.ops.parallel_kalman import parallel_kalman_smoother
from pyvbmp_tpu_torch.utils.convert import load_state, nlds_from_state, nlds_state, node_state

KALMAN_TOL = 1e-10
TOL = 1e-7
SWEEPS = 3
T_LEN, BATCH, K = 40, 3, 2


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    assert np.isfinite(port).all()
    return np.abs(port - ref).max() / np.abs(ref).max()


def T64(x):
    return torch.tensor(np.asarray(x, np.float64))


def switching_data(T=T_LEN, B=BATCH, every=10, seed=0):
    """examples/nlds_example.py's make_data: a 2-d latent rotating slowly or
    fast, the regime flipping every ``every`` steps, seen through a random
    3 x 2 map; (T, B, 3)."""
    def rot(th):
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])

    rs = np.random.RandomState(seed)
    As = [0.98 * rot(0.08), 0.98 * rot(0.5)]
    C = rs.randn(3, 2)
    x = rs.randn(B, 2)
    ys = []
    z = np.zeros(B, int)
    for t in range(T):
        if t % every == 0 and t > 0:
            z = 1 - z
        A = np.stack([As[zi] for zi in z])
        x = np.einsum("bij,bj->bi", A, x) + 0.05 * rs.randn(B, 2)
        ys.append(x @ C.T + 0.1 * rs.randn(B, 3))
    return np.stack(ys)


def q_s(seed=1):
    return np.random.RandomState(seed).dirichlet(np.ones(K), (T_LEN, BATCH))


@pytest.mark.parametrize("h", [2, 4])
def test_kalman_smoother_on_per_time_potentials_matches_jax(h):
    """The potentials an NLDS sweep builds: per-state dynamics and
    observation messages mixed under a q(s) at every step, (T, b, h, h)."""
    y = switching_data()[..., None]
    p = q_s()
    with jax.enable_x64(True):
        rng.seed(h)
        jm = JNLDS((3,), hidden_dim=h, mixture_dim=K)
        dp, op = jm._dyn_parms(jm.A), jm._obs_parms(jm.B)
        jp, jy = jnp.asarray(p), jnp.asarray(y)
        parms = {k: jnp.einsum("tbk,k...->tb...", jp, v) for k, v in dp.items()}
        iS, iSm, Res = jm._obs_like_per_s(op, jy)
        like = (jnp.einsum("tbk,kij->tbij", jp, iS),
                jnp.einsum("tbk,tbk...->tb...", jp, iSm),
                jnp.einsum("tbk,tbk->tb", jp, Res))
        u = jnp.ones(y.shape[:2] + (1, 1))
        ref = jax.tree_util.tree_map(np.asarray, jax_kalman(parms, jm.x0, like, u))
        x0_state = node_state(jm.x0)
        args = ({k: np.asarray(v) for k, v in parms.items()},
                [np.asarray(a) for a in like], np.asarray(u))
    assert args[0]["invQ"].shape == (T_LEN, BATCH, h, h)
    x0 = load_state(TNIW.create((h,), dtype=torch.float64), x0_state)
    out = parallel_kalman_smoother({k: T64(v) for k, v in args[0].items()}, x0,
                                   tuple(T64(a) for a in args[1]), T64(args[2]))
    flat_out = jax.tree_util.tree_leaves(out)
    flat_ref = jax.tree_util.tree_leaves(ref)
    assert len(flat_out) == len(flat_ref) == 9
    for i, (o, r) in enumerate(zip(flat_out, flat_ref)):
        assert rel_dev(o, r) <= KALMAN_TOL, i


@pytest.fixture(scope="module")
def fitted():
    """(JAX outputs, port NLDS) after SWEEPS sweeps from one state and one
    q(s)."""
    y = switching_data()
    with jax.enable_x64(True):
        rng.seed(3)
        jm = JNLDS((3,), hidden_dim=2, mixture_dim=K)
        jm.p = jnp.asarray(q_s())
        state = nlds_state(jm)
        jm.update(jnp.asarray(y), iters=SWEEPS)
        ref = dict(elbo=np.asarray(jm.ELBO_save), p=np.asarray(jm.p),
                   mu=np.asarray(jm.px.mu), logZ=np.asarray(jm.logZ))
    assert "p" in state
    tm = nlds_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(torch.tensor(y), iters=SWEEPS)
    return ref, tm


def test_elbo_trajectory_matches_jax(fitted):
    ref, tm = fitted
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,) and np.isfinite(out).all()
    assert (np.abs(out - ref["elbo"]) / np.abs(ref["elbo"])).max() <= TOL
    assert tm.ELBO() == tm.ELBO_save[-1]


def test_posteriors_match_jax(fitted):
    ref, tm = fitted
    assert tm.assignment_pr().shape == (T_LEN, BATCH, K)
    assert rel_dev(tm.p, ref["p"]) <= TOL
    assert rel_dev(tm.px.mu, ref["mu"]) <= TOL
    assert rel_dev(tm.logZ, ref["logZ"]) <= TOL
    assert torch.equal(tm.assignment(), tm.p.argmax(-1))


def test_state_round_trips_through_numpy(fitted):
    _, tm = fitted
    again = nlds_from_state(nlds_state(tm), device="cpu", dtype=torch.float64)
    for k in ("x0", "A", "B", "pi0"):
        a, b = getattr(again, k), getattr(tm, k)
        assert torch.equal(a.mu if hasattr(a, "mu") else a.alpha,
                           b.mu if hasattr(b, "mu") else b.alpha), k
    assert torch.equal(again.T.beta.mu, tm.T.beta.mu)
    assert torch.equal(again.p, tm.p)


def test_first_update_draws_blocky_q_s_from_the_generator():
    """Without a q(s), the first update starts from half a random state per
    segment of max(T // 8, 2) steps and half uniform, drawn from the model's
    generator: the same seed gives the same fit."""
    y = torch.tensor(switching_data(T=16, B=2))
    fits = []
    for _ in range(2):
        m = NLDS((3,), 2, K, generator=torch.Generator().manual_seed(5), device="cpu",
                 dtype=torch.float64)
        p0 = m._initial_p(16, 2, y)
        assert p0.shape == (16, 2, K)
        assert set(np.unique(p0.numpy())) <= {0.25, 0.75}
        assert (p0[::2] == p0[1::2]).all()  # segments of 2 steps
        m.update(y, iters=2)
        fits.append(np.asarray(m.ELBO_save))
    np.testing.assert_array_equal(*fits)


def test_fit_keeps_the_best_restart():
    """fit's restarts are fresh models drawn one after another from the
    model's generator; the one with the best final ELBO is kept."""
    y = torch.tensor(switching_data(T=16, B=2))
    kw = dict(device="cpu", dtype=torch.float64)
    m = NLDS((3,), 2, K, generator=torch.Generator().manual_seed(0), **kw)
    m.fit(y, iters=2, restarts=3)
    g = torch.Generator().manual_seed(0)
    NLDS((3,), 2, K, generator=g, **kw)  # the draws of m's own construction
    finals = []
    for _ in range(3):
        r = NLDS((3,), 2, K, generator=g, **kw)
        r.update(y, iters=2)
        finals.append(r.ELBO_save[-1])
    assert len(set(finals)) == 3
    assert m.ELBO_save[-1] == max(finals) and len(m.ELBO_save) == 2
    assert m.p.shape == (16, 2, K) and m.px.mu.shape == (16, 2, 2, 1)


def test_converted_model_without_p_updates_reproducibly():
    """A state without q(s) converts into a model with its own seeded
    generator: two conversions draw the same symmetry-breaking q(s) and fit
    alike."""
    y = torch.tensor(switching_data(T=16, B=2))
    state = nlds_state(NLDS((3,), 2, K, generator=torch.Generator().manual_seed(1),
                            device="cpu", dtype=torch.float64))
    assert "p" not in state
    fits = []
    for _ in range(2):
        m = nlds_from_state(state, device="cpu", dtype=torch.float64)
        assert m.generator is not None
        m.update(y, iters=2)
        fits.append(np.asarray(m.ELBO_save))
    np.testing.assert_array_equal(*fits)
