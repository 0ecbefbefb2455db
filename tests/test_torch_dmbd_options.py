"""DMBD's options beyond the main path, the port against the JAX package in
float64 on the CPU (JAX under the scoped ``jax.enable_x64``, state carried by
``pyvbmp_tpu_torch.utils.convert``):

- ``unique_obs=True`` (one role model per observable, no role
  ``transition_mask``): 2 sweeps from one state, the ELBO trajectory, role
  posteriors p and latent means px.mu within max relative deviation 1e-8;
- ``Elog_like`` from a fitted state, with ``latent_iters`` 1 and 2, within
  1e-8;
- the plots: the arrays ``plot_observation`` and ``plot_transition`` draw
  (obs and latent, with and without the mask) equal the JAX package's, and
  ``path`` writes a file."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

TOL = 1e-8
SWEEPS = 2
T_LEN, BATCH = 16, 3
LORENZ = dict(obs_shape=(3, 2), role_dims=(1, 2, 1), hidden_dims=(2, 2, 2))


def walks(seed):
    rs = np.random.RandomState(seed)
    y = np.cumsum(rs.randn(T_LEN, BATCH, 3, 2) * 0.3, 0)
    return (y - y.mean()) / y.std()


def rel_dev(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    return np.abs(port - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["unique_obs", "default"])
def fitted(request):
    """(JAX model after SWEEPS sweeps, its Elog_like at latent_iters 1 and
    2, the port model after SWEEPS sweeps from the same state, the data)."""
    unique = request.param == "unique_obs"
    y = walks(7 if unique else 8)
    with jax.enable_x64(True):
        rng.seed(7)
        jm = JDMBD(**LORENZ, unique_obs=unique, parallel_scan=True)
        state = dmbd_state(jm)
        jm.update(jnp.asarray(y), iters=SWEEPS)
        elog = {n: np.asarray(jm.Elog_like(jnp.asarray(y), latent_iters=n)) for n in (1, 2)}
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    tm.update(torch.tensor(y), iters=SWEEPS)
    return jm, elog, tm, y


def test_unique_obs_builds_one_role_model_per_observable():
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery as TDMBD

    m = TDMBD(**LORENZ, unique_obs=True, device="cpu")
    assert m.unique_obs and m.obs_model.batch_shape == (3,)
    assert m.obs_model.transition_mask is None
    d = TDMBD(**LORENZ, device="cpu")
    assert not d.unique_obs and d.obs_model.transition_mask is not None


def test_sweeps_match_jax(fitted):
    jm, _, tm, _ = fitted
    assert tm.unique_obs == jm.unique_obs
    ref = np.asarray(jm.ELBO_save)
    out = np.asarray(tm.ELBO_save)
    assert out.shape == (SWEEPS,)
    assert (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)
    assert out[-1] > out[0]
    assert rel_dev(tm.obs_model.p, jm.obs_model.p) <= TOL
    assert rel_dev(tm.px.mu, jm.px.mu) <= TOL


@pytest.mark.parametrize("latent_iters", [1, 2])
def test_elog_like_matches_jax(fitted, latent_iters):
    _, elog, tm, y = fitted
    out = tm.Elog_like(torch.tensor(y), latent_iters=latent_iters)
    assert out.shape == (BATCH,)
    assert rel_dev(out, elog[latent_iters]) <= TOL


def test_state_carries_unique_obs(fitted):
    _, _, tm, _ = fitted
    again = dmbd_from_state(dmbd_state(tm), device="cpu", dtype=torch.float64)
    assert again.unique_obs == tm.unique_obs
    assert (again.obs_model.transition_mask is None) == tm.unique_obs
    assert torch.equal(again.obs_model.obs_dist.mu, tm.obs_model.obs_dist.mu)


def drawn(fig):
    """The array a figure's one image shows."""
    from matplotlib import pyplot as plt

    arr = np.asarray(fig.axes[0].images[0].get_array())
    plt.close(fig)
    return arr


@pytest.mark.parametrize("kind", ["observation", "obs", "obs mask", "latent",
                                  "latent mask"])
def test_plots_draw_the_jax_arrays(fitted, kind, tmp_path):
    pytest.importorskip("matplotlib")
    jm, _, tm, _ = fitted
    if kind in ("obs", "obs mask") and tm.unique_obs:
        # one transition matrix per observable, and no mask: both packages
        # refuse to draw them as one matrix
        for m in (jm, tm):
            with pytest.raises(ValueError):
                m.plot_transition("obs", use_mask=kind.endswith("mask"))
        return

    def plot(m, path=None):
        if kind == "observation":
            return m.plot_observation(path=path)
        return m.plot_transition(kind.split()[0], use_mask=kind.endswith("mask"),
                                 path=path)

    with jax.enable_x64(True):
        ref = drawn(plot(jm))
    out = drawn(plot(tm))
    assert out.shape == ref.shape
    assert np.allclose(out.astype(np.float64), ref.astype(np.float64), rtol=TOL, atol=0)
    path = tmp_path / f"{kind.replace(' ', '_')}.png"
    plot(tm, str(path))
    assert path.stat().st_size > 0


def life_data(T, n, k):
    """examples/life_as_we_know_it_example.py's synthetic particle soup:
    (T' / 6, 6, n, 4) positions and velocities."""
    rs = np.random.RandomState(0)
    member = rs.randint(0, k, n)
    centers = np.cumsum(0.02 * rs.randn(T, k, 2), axis=0)
    jitter = 0.15 * rs.randn(T, n, 2)
    for t in range(1, T):
        jitter[t] = 0.95 * jitter[t - 1] + 0.05 * rs.randn(n, 2)
    data = centers[:, member] + jitter
    data = data / data.std()
    v = np.diff(data, axis=0)
    data = np.concatenate((data[1:], v / v.std()), -1)
    T6 = (data.shape[0] // 6) * 6
    return data[:T6].reshape(6, T6 // 6, n, 4).swapaxes(0, 1)


def rotor_data(T_synth, n):
    """examples/artificial_life_example.py's synthetic rotors: (T, 1, n, 4)."""
    rs = np.random.RandomState(0)
    t = np.arange(T_synth)[:, None]
    centers = 0.5 * np.stack([np.cos(2 * np.pi * t / 300.0), np.sin(2 * np.pi * t / 300.0)], -1)
    phase = rs.rand(n) * 2 * np.pi
    omega = 2 * np.pi / (20.0 + 10.0 * rs.rand(n))
    radius = 0.3 + 0.4 * rs.rand(n)
    ang = phase[None, :] + omega[None, :] * t
    data = centers + radius[None, :, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    data = data + 0.02 * rs.randn(*data.shape)
    data = data / data.std()
    v = np.diff(data, axis=0)
    data = np.concatenate((data[1:], v / v.std()), -1)
    return data[: data.shape[0] // 2][:, None]


# the two examples at their smoke widths: (data, constructor arguments, the
# (ptemp, sweeps) schedule, all at lr=0.5)
EXAMPLES = {
    "life": (lambda: life_data(80, 12, 2),
             dict(role_dims=(0, 1, 1), hidden_dims=(4, 2, 2), number_of_objects=2),
             [(1.0, 2)]),
    "artificial_life": (lambda: rotor_data(80, 6),
                        dict(role_dims=(0, 1, 0), hidden_dims=(4, 2, 1), regression_dim=-1,
                             number_of_objects=2),
                        [(5.0, 1), (1.0, 1)]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_widths_match_jax(name):
    """The life and artificial-life configurations (no environment roles,
    regression_dim=-1, ptemp annealed 5 -> 1) from one state: the ELBO
    trajectory and Elog_like within 1e-8."""
    make, cfg, schedule = EXAMPLES[name]
    y = make()
    with jax.enable_x64(True):
        rng.seed(11)
        jm = JDMBD(obs_shape=y.shape[-2:], parallel_scan=True, **cfg)
        state = dmbd_state(jm)
        for ptemp, n in schedule:
            jm.obs_model.ptemp = ptemp
            jm.update(jnp.asarray(y), iters=n, lr=0.5)
        ref, ref_elog = np.asarray(jm.ELBO_save), np.asarray(jm.Elog_like(jnp.asarray(y)))
    tm = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    for ptemp, n in schedule:
        tm.obs_model.ptemp = ptemp
        tm.update(torch.tensor(y), iters=n, lr=0.5)
    out = np.asarray(tm.ELBO_save)
    assert (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)
    assert rel_dev(tm.Elog_like(torch.tensor(y)), ref_elog) <= TOL


def test_cradle_data_float32_follows_float64():
    """DMBD on benchmarks/cradle_bench.py's Newton's-cradle data (5 balls,
    four at rest: means ~1, spreads ~1e-4) in float32 and float64 from one
    state: the ELBO trajectories agree within 1e-4, which the expanded
    quadratics of the latent messages (5e-3 on the first sweep) and the
    unshifted role scans (1.1e-4) did not give."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery as TDMBD
    from pyvbmp_tpu_torch.simulations import NewtonsCradle

    sim = NewtonsCradle(n_balls=5, ball_size=0.2, Tmax=200, batch_size=10, g=1, leak=0.01,
                        dt=0.05)
    y, _ = sim.generate_data("1 ball object", torch.Generator().manual_seed(3), device="cpu")
    state = dmbd_state(TDMBD((5, 2), (2, 2, 2), (2, 2, 2), parallel_scan=True,
                             generator=torch.Generator().manual_seed(1), device="cpu"))
    elbo = {}
    for dtype in (torch.float32, torch.float64):
        m = dmbd_from_state(state, device="cpu", dtype=dtype)
        m.update(y.to(dtype), iters=3)
        elbo[dtype] = np.asarray(m.ELBO_save)
    dev = np.abs(elbo[torch.float32] - elbo[torch.float64]) / np.abs(elbo[torch.float64])
    assert dev.max() <= 1e-4, dev
