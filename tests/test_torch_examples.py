"""The port's examples (``pyvbmp_tpu_torch.examples``) against the JAX
package's (``examples/``), on the CPU.

- Data: every example's data equal to the JAX example's; exactly for the
  numpy pipelines (calcium, life, artificial life, NLDS, two moons), and
  from the JAX example's own draws (its keys, split as the JAX simulators
  split them) within 1e-10 relative for the simulators (Lorenz, Flame,
  Flocking, Newton's cradle), in float64 under the scoped
  ``jax.enable_x64``; the chaotic Lorenz system at full width over its
  first 700 of 2000 steps (see LORENZ_STEPS).
- Smoke: every example's ``main()`` in smoke mode on the CPU, plots on
  (written into a test directory): finite ELBOs, two moons at >= 0.5 as
  in the JAX package's test; ``animate_results`` writes its GIF from a
  fitted Lorenz model; every ``main()`` without a device raises
  ``NoCardError`` when there is no card.
- Fits: calcium (zero-width z blocks), flocking (scan smoothers) and NLDS,
  each fit by the port example's own ``fit`` at smoke width from the JAX
  model's initial state, against the JAX example's ELBO trace in float64
  within 1e-8."""
import importlib
import importlib.util
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.utils import rng
from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state, nlds_from_state, nlds_state
from pyvbmp_tpu_torch.utils.torchutils import NoCardError

TOL = 1e-8
SIM_TOL = 1e-10
EXAMPLES_DIR = Path(__file__).resolve().parent.parent / "examples"
NAMES = ["lorenz_example", "flame_example", "flocking_example", "newtons_cradle_example",
         "calcium_imaging_example", "life_as_we_know_it_example", "artificial_life_example",
         "nlds_example", "two_moons"]


def port(name):
    return importlib.import_module(f"pyvbmp_tpu_torch.examples.{name}")


def jax_example(name):
    """examples/<name>.py of the JAX package, imported from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_rel(out, ref, tol):
    out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()


# -- data ---------------------------------------------------------------------------
NUMPY_DATA = {
    "calcium full": ("calcium_imaging_example", lambda m: m.load_calcium(), {}),
    "calcium smoke": ("calcium_imaging_example",
                      lambda m: m.load_calcium(n_cells=8, n_chunks=2, chunk_len=40),
                      "SMOKE_DATA"),
    "life full": ("life_as_we_know_it_example", lambda m: m.load_life(), {}),
    "life smoke": ("life_as_we_know_it_example", lambda m: m.load_life(T=80, n=12, k=2),
                   "SMOKE_DATA"),
    "artificial life full": ("artificial_life_example", lambda m: m.load_rotor_story(), {}),
    "artificial life smoke": ("artificial_life_example",
                              lambda m: m.load_rotor_story(T_synth=80, n_particles=6),
                              "SMOKE_DATA"),
}


@pytest.mark.parametrize("case", sorted(NUMPY_DATA))
def test_numpy_pipelines_match_jax_exactly(case, tmp_path, monkeypatch):
    name, load, smoke = NUMPY_DATA[case]
    monkeypatch.chdir(tmp_path)  # no ./data: both take their simulated fallback
    ref = np.asarray(load(jax_example(name)))
    kw = getattr(port(name), smoke) if smoke else {}
    loader = {"calcium_imaging_example": "load_calcium",
              "life_as_we_know_it_example": "load_life",
              "artificial_life_example": "load_rotor_story"}[name]
    out = getattr(port(name), loader)(**kw, device="cpu")
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(out.numpy(), ref)


def test_nlds_and_two_moons_data_match_jax_exactly():
    for T, B in ((60, 4), (200, 8)):
        y, z = port("nlds_example").make_data(T, B, device="cpu")
        y_ref, z_ref = jax_example("nlds_example").make_data(T=T, B=B)
        assert np.array_equal(y.numpy(), np.asarray(y_ref)) and np.array_equal(z, z_ref)
    for n in (80, 400):
        X, y = port("two_moons").two_moons(n)
        X_ref, y_ref = jax_example("two_moons").two_moons(n)
        assert np.array_equal(X, X_ref) and np.array_equal(y, y_ref)
        pX, Y, labels = port("two_moons").make_data(n, device="cpu")
        assert np.array_equal(pX.mu[..., 0].numpy(), X_ref) and np.array_equal(labels, y_ref)
        assert np.array_equal(Y.argmax(-1).numpy(), y_ref)


# Lorenz-63 is chaotic: the last-bit differences of two float64
# integrations (XLA's and torch's) grow by orders of magnitude over the
# example's 2000 steps, past 1e-10 well before the end, so the full-width
# data (batch 20) is held to 1e-10 over its first LORENZ_STEPS steps
LORENZ_STEPS = 700


def lorenz_case(smoke, num_steps=None):
    """(JAX example data, port data) from the key the JAX example draws;
    ``num_steps`` replaces the example's integration length."""
    with jax.enable_x64(True):
        from pyvbmp_tpu.simulations import Lorenz as JLorenz

        B = 2 if smoke else 20
        rng.seed(0)
        key = rng.next_key()
        sim = JLorenz()
        steps = num_steps or (150 if smoke else sim.num_steps)
        sim.num_steps = steps
        ref = np.asarray(sim.simulate(B, key=key))
        if smoke:
            ref = ref[:24]
        ks = jax.random.split(key, 4)
        draws = [jax.random.uniform(k, (B,)) for k in ks[:3]]
        draws.append(jax.random.normal(ks[3], (3, B)))
        draws = [torch.tensor(np.asarray(d)) for d in draws]
    out = port("lorenz_example").make_data(B, smoke, device="cpu", dtype=torch.float64,
                                           draws=draws, num_steps=num_steps)
    return ref, out


def flame_case(smoke):
    with jax.enable_x64(True):
        from pyvbmp_tpu.simulations import FlameSimulator as JFlame

        rng.seed(0)
        key = rng.next_key()
        sim = JFlame(num_steps=120 if smoke else 500, delta_t=0.02, thermal_diffusivity=0.5,
                     temperature_threshold=0.45, num_sources=12, key=key)
        ref = np.asarray(sim.simulate()[0])[::5][..., None][:, None]
        draw = np.asarray(jax.random.uniform(key, (1,)))
    out = port("flame_example").make_data(smoke, device="cpu", dtype=torch.float64,
                                          heat_draw=draw)
    return ref, out


def flocking_case(smoke):
    from test_torch_flocking import jax_draws

    with jax.enable_x64(True):
        from pyvbmp_tpu.simulations import Flocking as JFlocking

        kw = dict(n_birds=6, Tmax=30, batch_size=2) if smoke else {}
        key = jax.random.key(0)
        ref = np.asarray(JFlocking(**kw).simulate(key))
        draws = jax_draws(key, JFlocking(**kw))
    out = port("flocking_example").make_data(smoke, device="cpu", dtype=torch.float64,
                                             draws=draws)
    return ref, out


def cradle_case(smoke):
    from test_torch_simulations import cradle_draws

    with jax.enable_x64(True):
        from pyvbmp_tpu.simulations import NewtonsCradle as JCradle

        Tmax, B = (30, 2) if smoke else (200, 10)
        key = jax.random.key(3)
        sim = JCradle(n_balls=5, ball_size=0.2, Tmax=Tmax, batch_size=B, g=1, leak=0.01,
                      dt=0.05)
        ref = np.asarray(sim.generate_data("1 ball object", key=key)[0])
        draws = cradle_draws(key, "1 ball object", B, 5)
    out = port("newtons_cradle_example").make_data(smoke, device="cpu", dtype=torch.float64,
                                                   draws=draws)
    return ref, out


SIM_DATA = {"lorenz": lambda smoke: lorenz_case(smoke, None if smoke else LORENZ_STEPS),
            "flame": flame_case, "flocking": flocking_case,
            "cradle": cradle_case}


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("name", sorted(SIM_DATA))
def test_simulated_data_matches_jax_on_its_draws(name, smoke):
    ref, out = SIM_DATA[name](smoke)
    assert out.dtype == torch.float64
    assert_rel(out, ref, SIM_TOL)


# -- smoke runs ------------------------------------------------------------------------
@pytest.fixture
def out_dir(tmp_path, monkeypatch):
    """The examples' smoke-mode files land in a directory of the test's."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("MPLBACKEND", "Agg")
    return tmp_path


PLOTS = {"lorenz_example": ["lorenz_pc_scores.png", "dmbd_lorenz_observation.png",
                            "dmbd_lorenz_role_transition.png", "dmbd_lorenz_A.png",
                            "dmbd_lorenz_A_mask.png"],
         "life_as_we_know_it_example": ["wil.gif"],
         "artificial_life_example": ["rotator_movie.gif"]}


@pytest.mark.parametrize("name", NAMES)
def test_example_smoke_on_the_cpu(name, out_dir, monkeypatch):
    monkeypatch.setenv("PYVBMP_EXAMPLE_SMOKE", "1")  # smoke=None reads it
    out = port(name).main(device="cpu")
    if name == "two_moons":
        assert np.isfinite(out) and out >= 0.5, f"two-moons classifier at chance: {out}"
    else:
        elbos = np.asarray(out.ELBO_save, dtype=np.float64)
        assert elbos.size and np.isfinite(elbos).all(), f"{name}: ELBO {elbos}"
    for f in PLOTS.get(name, []):
        assert (out_dir / f).stat().st_size > 0, f


def test_lorenz_example_feeds_animate_results(out_dir):
    model = port("lorenz_example").main(device="cpu", smoke=True, plots=False)
    from pyvbmp_tpu_torch.examples.animate_results import animate_results

    rng_data = port("lorenz_example").make_data(2, True, torch.Generator().manual_seed(0),
                                                device="cpu")
    out = animate_results("sbz", str(out_dir / "movie.gif"), fps=5).make_movie(
        model, rng_data, (0,))
    assert Path(out).stat().st_size > 0
    for kind in ("role", "particular"):
        a, c = animate_results(kind).assignments(model)
        assert a.shape == c.shape == tuple(rng_data.shape[:3]) and (a >= 0).all() and (a <= 1).all()


@pytest.mark.parametrize("name", NAMES)
def test_example_main_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCardError):
        port(name).main(smoke=True, plots=False)


def test_examples_import_without_matplotlib_or_jax():
    """The examples import matplotlib only inside their plotting helpers."""
    import subprocess

    code = ("import sys; sys.modules['matplotlib'] = None; sys.modules['jax'] = None\n"
            + "".join(f"import pyvbmp_tpu_torch.examples.{n}\n" for n in NAMES)
            + "import pyvbmp_tpu_torch.examples.animate_results\n"
            + "assert not any(m.startswith('pyvbmp_tpu.') for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=Path(__file__).resolve().parent.parent)


# -- fits against the JAX examples' ELBO traces ----------------------------------------------
def test_calcium_fit_matches_jax():
    """role_dims (1, 1, 0), hidden_dims (4, 2, 0): the zero-width z blocks."""
    jm_mod, pm = jax_example("calcium_imaging_example"), port("calcium_imaging_example")
    y = np.asarray(jm_mod.load_calcium(**pm.SMOKE_DATA), np.float64)
    with jax.enable_x64(True):
        from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD

        rng.seed(0)
        jm = JDMBD(obs_shape=y.shape[-2:], role_dims=(1, 1, 0), hidden_dims=(4, 2, 0),
                   regression_dim=-1, control_dim=0, number_of_objects=pm.SMOKE_OBJECTS)
        state = dmbd_state(jm)
        jm.update(jnp.asarray(y), iters=pm.SMOKE_ITERS, lr=0.5)
        ref = np.asarray(jm.ELBO_save)
        pa = np.asarray(jm.particular_assignment())
    tm = pm.fit(dmbd_from_state(state, "cpu", torch.float64), torch.tensor(y),
                pm.SMOKE_ITERS, verbose=False)
    assert tm.role_dim == 1 + 2 * 1 and tm.hidden_dim == 4 + 2 * 2
    out = np.asarray(tm.ELBO_save)
    assert out.shape == ref.shape and (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)
    assert np.array_equal(tm.particular_assignment().numpy(), pa)


def test_flocking_fit_matches_jax():
    pm = port("flocking_example")
    with jax.enable_x64(True):
        from pyvbmp_tpu.models import DynamicMarkovBlanketDiscovery as JDMBD
        from pyvbmp_tpu.simulations import Flocking as JFlocking

        y = np.asarray(JFlocking(n_birds=pm.SMOKE_BIRDS, Tmax=pm.SMOKE_TMAX,
                                 batch_size=pm.SMOKE_BATCH).simulate(jax.random.key(0)))
        rng.seed(0)
        jm = JDMBD(obs_shape=y.shape[-2:], role_dims=(2, 2, 2), hidden_dims=(2, 2, 2),
                   number_of_objects=pm.SMOKE_OBJECTS, parallel_scan=True)
        state = dmbd_state(jm)
        jm.update(jnp.asarray(y), iters=pm.SMOKE_ITERS, latent_iters=1, lr=0.5)
        ref = np.asarray(jm.ELBO_save)
    model = dmbd_from_state(state, "cpu", torch.float64)
    assert model.parallel_scan
    tm = pm.fit(model, torch.tensor(y), pm.SMOKE_ITERS, verbose=False)
    out = np.asarray(tm.ELBO_save)
    assert out.shape == ref.shape and (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)


def test_nlds_fit_matches_jax(monkeypatch):
    """The JAX example's fit (one restart in smoke mode: a fresh model from
    its key and a blocky q(s) from the next) against the port example's
    ``fit`` whose fresh model holds the JAX one's state and q(s)."""
    from pyvbmp_tpu_torch.models import nlds as port_nlds

    jm_mod, pm = jax_example("nlds_example"), port("nlds_example")
    y32, _ = jm_mod.make_data(T=pm.SMOKE_T, B=pm.SMOKE_B)
    y = np.asarray(y32, np.float64)
    with jax.enable_x64(True):
        import jax.random as jr

        from pyvbmp_tpu.models import NLDS as JNLDS

        rng.seed(0)
        JNLDS((3,), hidden_dim=2, mixture_dim=2)  # main's model draws the first key
        key = rng.next_key()  # fit's key
        p_key = rng.next_key()  # the first update's q(s)
        fresh = JNLDS((3,), 2, 2, key=jr.fold_in(key, 0))
        state = nlds_state(fresh)
        # the first update's blocky q(s), drawn as the JAX package draws it
        T, b, K = pm.SMOKE_T, pm.SMOKE_B, 2
        seg = max(T // 8, 2)
        states = jr.randint(p_key, ((T + seg - 1) // seg, b), 0, K)
        hard = jax.nn.one_hot(jnp.repeat(states, seg, axis=0)[:T], K, dtype=jnp.float64)
        state["p"] = np.asarray(0.5 * hard + 0.5 / K)
        rng.seed(0)  # the JAX example's own run
        jm = JNLDS((3,), hidden_dim=2, mixture_dim=2)
        jm.fit(jnp.asarray(y), iters=pm.SMOKE_ITERS, restarts=pm.SMOKE_RESTARTS)
        ref = np.asarray(jm.ELBO_save)
    monkeypatch.setattr(port_nlds, "NonLinearDynamicalSystems",
                        lambda *a, **k: nlds_from_state(state, "cpu", torch.float64))
    start = nlds_from_state(state, "cpu", torch.float64)
    tm = pm.fit(start, torch.tensor(y), pm.SMOKE_ITERS, pm.SMOKE_RESTARTS, verbose=False)
    out = np.asarray(tm.ELBO_save)
    assert out.shape == ref.shape and (np.abs(out - ref) / np.abs(ref)).max() <= TOL, (out, ref)
