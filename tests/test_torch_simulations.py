"""The port's simulators against the JAX package's, in float64 on the CPU.

Each port simulator keeps its random draws apart from its deterministic
part, so the JAX package's own draws (remade here from its keys, split as it
splits them) are fed to the port.  Tolerance: max |port - jax| / max |jax|
<= 1e-10, except Forager, whose host-side walk must agree exactly.  Also:
Lorenz and Flocking build on the card unless asked otherwise (no card and
no ``device`` raises ``NoCardError``) and give the numbers they gave before
``device`` was added."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu import simulations as J
from pyvbmp_tpu_torch import simulations as P
from pyvbmp_tpu_torch.utils.torchutils import NoCardError

TOL = 1e-10
CRADLE = dict(n_balls=5, ball_size=0.2, Tmax=100, batch_size=3, g=1, leak=0.01, dt=0.05)
INIT_TYPES = ["random", "1 ball object", "2 ball object", "1 + 1", "2 + 2", "2 + 3"]


def assert_rel(port, ref, what=""):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    dev = np.abs(port - ref).max() / np.abs(ref).max()
    assert dev <= TOL, f"{what}: rel dev {dev:.3e}"


def cradle_draws(key, init_type, B, n):
    """The uniform draws JAX ``NewtonsCradle.initialize`` makes from ``key``,
    under the port's names."""
    u = lambda k, shape: torch.tensor(np.asarray(jax.random.uniform(k, shape)))
    k1, k2, k3 = jax.random.split(key, 3)
    if init_type == "random":
        return {"theta": u(k1, (B, n))}
    if "+" not in init_type:
        m = int(init_type.split(" ")[0])
        return {"left": u(k1, (B, m)), "left_shift": u(k3, (B, 1)),
                "rest": u(k2, (B, n - m))}
    parts = init_type.split(" ")
    ml, mr = int(parts[0]), int(parts[2])
    kL, kR, kO, kSL, kSR = jax.random.split(k1, 5)
    return {"left": u(kL, (B, ml)), "left_shift": u(kSL, (B, 1)), "right": u(kR, (B, mr)),
            "right_shift": u(kSR, (B, 1)), "rest": u(kO, (B, n - ml - mr))}


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_newtons_cradle_matches_jax(init_type):
    key = jax.random.key(3)
    with jax.enable_x64(True):
        jsim = J.NewtonsCradle(**CRADLE)
        theta0 = np.asarray(jsim.initialize(init_type, key=key))
        data, theta = (np.asarray(a) for a in jsim.generate_data(init_type, key=key))
        draws = cradle_draws(key, init_type, CRADLE["batch_size"], CRADLE["n_balls"])
    sim = P.NewtonsCradle(**CRADLE)
    assert {k: tuple(v.shape) for k, v in draws.items()} == sim.draw_shapes(init_type)
    assert_rel(sim.initial_angles(init_type, draws), theta0, "theta0")
    out, th = sim.integrate(torch.tensor(theta0))
    assert_rel(out, data, "data")
    assert_rel(th, theta, "theta")


def test_newtons_cradle_with_string_matches_jax():
    key = jax.random.key(4)
    with jax.enable_x64(True):
        jsim = J.NewtonsCradle(**CRADLE, include_string=3)
        theta0 = np.asarray(jsim.initialize("1 ball object", key=key))
        data = np.asarray(jsim.generate_data("1 ball object", key=key)[0])
    out, _ = P.NewtonsCradle(**CRADLE, include_string=3).integrate(torch.tensor(theta0))
    assert out.shape == (CRADLE["Tmax"], CRADLE["batch_size"], 3 * CRADLE["n_balls"], 2)
    assert_rel(out, data, "data")


def test_newtons_cradle_draws_from_the_generator():
    sim = P.NewtonsCradle(**CRADLE)
    a = sim.generate_data("1 ball object", torch.Generator().manual_seed(0), "cpu")[0]
    b = sim.generate_data("1 ball object", torch.Generator().manual_seed(0), "cpu")[0]
    assert torch.equal(a, b) and a.dtype == torch.float64
    with pytest.raises(ValueError):
        sim.initialize("sideways", device="cpu")


def flame_args(num_steps):
    return dict(num_steps=num_steps, delta_t=0.02, thermal_diffusivity=0.5,
                temperature_threshold=0.45, num_sources=12)


def test_flame_simulate_and_fine_grain_match_jax():
    key = jax.random.key(0)
    with jax.enable_x64(True):
        jsim = J.FlameSimulator(**flame_args(150), key=key)
        ref = [np.asarray(a) for a in jsim.simulate()]
        fine = [np.asarray(a) for a in jsim.fine_grain(num_x=200)]
        draw = np.asarray(jax.random.uniform(key, (1,)))
    sim = P.FlameSimulator(**flame_args(150), heat_draw=draw, device="cpu")
    out = sim.simulate()
    assert np.isneginf(ref[1]).any() and np.isfinite(ref[1]).sum() > 1  # some ignite
    assert_rel(out[0], ref[0], "temperature")
    ign = out[1].numpy()
    assert np.array_equal(np.isneginf(ign), np.isneginf(ref[1]))
    assert_rel(out[1][torch.isfinite(out[1])], ref[1][np.isfinite(ref[1])], "ignition")
    assert_rel(out[2], ref[2], "heat")
    got = sim.fine_grain(num_x=200)
    for name, o, r in zip(("temperature", "fuel", "oxidizer"), got[:3], fine[:3]):
        assert_rel(o, r, name)
    assert np.array_equal(got[3].numpy(), fine[3])


def test_flame_draws_its_heat_from_the_generator():
    a = P.FlameSimulator(**flame_args(5), generator=torch.Generator().manual_seed(0),
                         device="cpu")
    b = P.FlameSimulator(**flame_args(5), heat_draw=torch.rand(
        1, generator=torch.Generator().manual_seed(0), dtype=torch.float64), device="cpu")
    assert torch.equal(a.heat, b.heat) and a.heat[0] == 5.0


def test_cartthingy_matches_jax():
    key = jax.random.key(1)
    B = 3
    with jax.enable_x64(True):
        ref = np.asarray(J.cartthingy.simulate(B, key=key))
        k1, k2, k3 = jax.random.split(key, 3)
        x0 = np.asarray(jax.random.normal(k1, (B,)))
        th1 = np.pi / 2 - np.pi * np.asarray(jax.random.uniform(k2, (B,)))
        th2 = np.pi / 2 - np.pi * np.asarray(jax.random.uniform(k3, (B,)))
    state0 = np.stack([x0, th1, th2, 0 * x0, 0 * x0, 0 * x0], -1)
    out = P.cartthingy.simulate(state0=state0, device="cpu")
    assert_rel(out, ref, "trajectory")
    drawn = P.cartthingy.simulate(B, torch.Generator().manual_seed(0), device="cpu")
    assert drawn.shape == ref.shape


def test_forager_matches_jax_exactly():
    jf, pf = J.Forager(), P.Forager()
    jf.num_steps = pf.num_steps = 400
    ref = jf.simulate(seed=7)
    out = pf.simulate(seed=7, device="cpu")
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32 and np.array_equal(o.numpy(), r)
    ref_b = jf.simulate_batches(3, seed=2)
    out_b = pf.simulate_batches(3, seed=2, device="cpu")
    for o, r in zip(out_b, ref_b):
        assert np.array_equal(o.numpy(), r)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", ["Lorenz", "Flocking", "NewtonsCradle", "Flame",
                                  "Forager", "cartthingy"])
def test_simulators_build_on_the_card_by_default(no_card, name):
    g = torch.Generator().manual_seed(0)
    calls = {
        "Lorenz": lambda: P.Lorenz().simulate(2, generator=g),
        "Flocking": lambda: P.Flocking(n_birds=3, Tmax=4, batch_size=2).simulate(g),
        "NewtonsCradle": lambda: P.NewtonsCradle(**CRADLE).generate_data(generator=g),
        "Flame": lambda: P.FlameSimulator(**flame_args(5), generator=g),
        "Forager": lambda: P.Forager().simulate(seed=0),
        "cartthingy": lambda: P.cartthingy.simulate(2, g),
    }
    with pytest.raises(NoCardError):
        calls[name]()


def test_lorenz_and_flocking_give_the_same_numbers_on_the_cpu():
    """The values Lorenz and Flocking gave before ``device`` was added."""
    sim = P.Lorenz()
    sim.num_steps = 60
    d = sim.simulate(3, generator=torch.Generator().manual_seed(0), device="cpu")
    assert d.shape == (11, 3, 3, 2) and d.device.type == "cpu"
    assert abs(d.sum().item() - 52.96264971555948) <= 1e-12
    assert np.allclose(d[5, 1].numpy(), [[0.2730462249522225, 0.27733560893554704],
                                         [0.5883067708979982, 0.5883129627181347],
                                         [0.09819211867309659, 0.1650198866677057]],
                       rtol=1e-13, atol=0)
    f = P.Flocking(n_birds=4, Tmax=10, batch_size=2).simulate(
        torch.Generator().manual_seed(0), device="cpu")
    assert f.shape == (10, 2, 4, 4)
    assert abs(f.sum().item() - -82.15601521828347) <= 1e-12
    assert np.allclose(f[9, 1, 2].numpy(), [1.0521673748896647, -0.8893539292981645,
                                            -1.353426066323674, 1.6883788666292177],
                       rtol=1e-13, atol=0)
