"""DMBD on flame-front data (counterpart of examples/flame_example.py,
reference examples/Flame_example.py).

    python -m pyvbmp_tpu_torch.examples.flame_example
"""
import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..simulations import FlameSimulator
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, NUM_STEPS = 10, 500
SMOKE_ITERS, SMOKE_STEPS = 2, 120


def make_data(smoke=False, generator=None, device=None, dtype=torch.float32, heat_draw=None):
    """Every fifth step of the simulated temperatures, (T, 1, 12, 1) in
    ``dtype`` on ``device``; ``heat_draw`` (FlameSimulator's) replaces the
    generator's draw."""
    device = default_device(device)
    sim = FlameSimulator(num_steps=SMOKE_STEPS if smoke else NUM_STEPS, delta_t=0.02,
                         thermal_diffusivity=0.5, temperature_threshold=0.45,
                         num_sources=12, generator=generator, heat_draw=heat_draw,
                         device=device)
    temperature, ignition_times, heat = sim.simulate()
    data = temperature[::5][..., None]  # (T, n_sources, 1)
    return data[:, None].to(dtype)  # add batch dim


def build_model(generator=None, device=None, dtype=None):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=(12, 1), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1),
        generator=generator, dtype=dtype, device=device,
    )


def fit(model, data, iters=ITERS, verbose=True):
    model.update(data, iters=iters, latent_iters=1, lr=0.5, verbose=verbose)
    return model


def main(iters=ITERS, device=None, smoke=None, plots=True, dtype=torch.float32):
    smoke = smoke_mode(smoke)
    if smoke:
        iters = SMOKE_ITERS
    device = default_device(device)
    rng.seed(0)
    data = make_data(smoke, rng.next_generator(), device, dtype)
    model = fit(build_model(rng.next_generator(), device, dtype), data, iters)
    print("assignments:", np.unique(numpy(model.assignment())))
    return model


if __name__ == "__main__":
    main()
