"""DMBD on artificial-life ("rotor story") particle tracks (counterpart of
examples/artificial_life_example.py, reference
examples/Artificial_Life_example.py:12-57).

./data/rotor_story_{x,y}.txt are used with the reference's decimation and
normalization where they exist; otherwise a synthetic rotor system
(particles orbiting drifting centers) stands in.  The fit anneals the
assignment temperature from 5 to 1, as the reference does.

    python -m pyvbmp_tpu_torch.examples.artificial_life_example
"""
import os

import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import can_plot, out_path, smoke_mode

ITERS_WARM, ITERS, OBJECTS, HIDDEN = 10, 20, 10, (8, 4, 2)
SMOKE_ITERS_WARM, SMOKE_ITERS, SMOKE_OBJECTS, SMOKE_HIDDEN = 1, 1, 2, (4, 2, 1)
SMOKE_DATA = dict(T_synth=80, n_particles=6)


def load_rotor_story(data_dir="./data", T_synth=400, n_particles=16, device=None,
                     dtype=torch.float32):
    """(T, 1, N, 4) positions and velocities in ``dtype`` on ``device``."""
    device = default_device(device)
    yf = os.path.join(data_dir, "rotor_story_y.txt")
    xf = os.path.join(data_dir, "rotor_story_x.txt")
    if os.path.exists(yf) and os.path.exists(xf):
        y = np.genfromtxt(yf)[..., None]
        x = np.genfromtxt(xf)[..., None]
        data = np.concatenate((y, x), -1)[::10]
    else:
        print("rotor_story data not found; simulating a synthetic rotor system")
        rs = np.random.RandomState(0)
        t = np.arange(T_synth)[:, None]
        centers = 0.5 * np.stack(
            [np.cos(2 * np.pi * t / 300.0), np.sin(2 * np.pi * t / 300.0)], -1
        )  # (T,1,2) slow drift shared by all rotors
        phase = rs.rand(n_particles) * 2 * np.pi
        omega = 2 * np.pi / (20.0 + 10.0 * rs.rand(n_particles))
        radius = 0.3 + 0.4 * rs.rand(n_particles)
        ang = phase[None, :] + omega[None, :] * t
        data = centers + radius[None, :, None] * np.stack(
            [np.cos(ang), np.sin(ang)], -1
        )
        data = data + 0.02 * rs.randn(*data.shape)
    data = data / data.std()
    v = np.diff(data, axis=0)
    v = v / v.std()
    data = np.concatenate((data[1:], v), -1)
    data = data[: data.shape[0] // 2]
    return torch.as_tensor(data[:, None], dtype=dtype, device=device)


def build_model(obs_shape, generator=None, device=None, dtype=None, smoke=False):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=tuple(obs_shape),
        role_dims=(0, 1, 0),
        hidden_dims=SMOKE_HIDDEN if smoke else HIDDEN,
        regression_dim=-1,
        control_dim=0,
        number_of_objects=SMOKE_OBJECTS if smoke else OBJECTS,
        generator=generator, dtype=dtype, device=device,
    )


def fit(model, data, iters_warm=ITERS_WARM, iters=ITERS, verbose=True):
    # reference anneals the assignment temperature: ptemp 5 -> 1
    model.obs_model.ptemp = 5.0
    model.update(data, iters=iters_warm, latent_iters=1, lr=0.5, verbose=verbose)
    model.obs_model.ptemp = 1.0
    model.update(data, iters=iters, latent_iters=1, lr=0.5, verbose=verbose)
    return model


def main(iters_warm=ITERS_WARM, iters=ITERS, device=None, smoke=None, plots=True,
         dtype=torch.float32):
    smoke = smoke_mode(smoke)
    device = default_device(device)
    rng.seed(0)
    if smoke:
        iters_warm, iters = SMOKE_ITERS_WARM, SMOKE_ITERS
        data = load_rotor_story(**SMOKE_DATA, device=device, dtype=dtype)
    else:
        data = load_rotor_story(device=device, dtype=dtype)
    model = build_model(data.shape[-2:], rng.next_generator(), device, dtype, smoke)
    fit(model, data, iters_warm, iters)
    pa = model.particular_assignment().cpu().numpy()
    print("object usage:", np.bincount(pa[-1, 0], minlength=model.number_of_objects + 1))
    if plots and can_plot():
        from .animate_results import animate_results

        gif = out_path("rotator_movie.gif", smoke)
        animate_results("particular", gif).make_movie(model, data, (0,))
        print("wrote", gif)
    return model


if __name__ == "__main__":
    main()
