"""DMBD on the "life as we know it" particle dataset (counterpart of
examples/life_as_we_know_it_example.py, reference
examples/Life_as_we_know_it_test.py:12-44).

./data/l{x,y}.txt (128 particles) are used with the reference's pipeline
(drop the first 847 frames, reshape to 6 batches) where they exist;
otherwise a synthetic soup of interacting particle clusters stands in.

    python -m pyvbmp_tpu_torch.examples.life_as_we_know_it_example
"""
import os

import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import can_plot, out_path, smoke_mode

ITERS, OBJECTS, HIDDEN = 40, 6, (12, 4, 4)
SMOKE_ITERS, SMOKE_OBJECTS, SMOKE_HIDDEN = 2, 2, (4, 2, 2)
SMOKE_DATA = dict(T=80, n=12, k=2)


def load_life(data_dir="./data", T=770, n=64, k=6, device=None, dtype=torch.float32):
    """(T' / 6, 6, n, 4) positions and velocities in ``dtype`` on
    ``device``."""
    device = default_device(device)
    yf = os.path.join(data_dir, "ly.txt")
    xf = os.path.join(data_dir, "lx.txt")
    if os.path.exists(yf) and os.path.exists(xf):
        y = np.genfromtxt(yf).T[..., None]
        x = np.genfromtxt(xf).T[..., None]
        data = np.concatenate((x, y), -1)
        data = data / data.std()
        data = data[847:]
    else:
        print("life data not found; simulating clustered particle soup")
        rs = np.random.RandomState(0)
        # default T/n smaller than the real dataset so CPU runs finish
        member = rs.randint(0, k, n)
        centers = np.cumsum(0.02 * rs.randn(T, k, 2), axis=0)
        jitter = 0.15 * rs.randn(T, n, 2)
        # particles follow their cluster center with OU-style jitter
        for t in range(1, T):
            jitter[t] = 0.95 * jitter[t - 1] + 0.05 * rs.randn(n, 2)
        data = centers[:, member] + jitter
        data = data / data.std()
    v = np.diff(data, axis=0)
    v = v / v.std()
    data = data[1:]
    data = np.concatenate((data, v), -1)
    T6 = (data.shape[0] // 6) * 6
    data = data[:T6].reshape(6, T6 // 6, data.shape[-2], 4).swapaxes(0, 1)
    return torch.as_tensor(data, dtype=dtype, device=device)


def build_model(obs_shape, generator=None, device=None, dtype=None, smoke=False):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=tuple(obs_shape),
        role_dims=(0, 1, 1),
        hidden_dims=SMOKE_HIDDEN if smoke else HIDDEN,
        regression_dim=0,
        control_dim=0,
        number_of_objects=SMOKE_OBJECTS if smoke else OBJECTS,
        generator=generator, dtype=dtype, device=device,
    )


def fit(model, data, iters=ITERS, verbose=True):
    model.update(data, iters=iters, lr=0.5, verbose=verbose)
    return model


def main(iters=ITERS, device=None, smoke=None, plots=True, dtype=torch.float32):
    smoke = smoke_mode(smoke)
    device = default_device(device)
    rng.seed(0)
    if smoke:
        iters = SMOKE_ITERS
        data = load_life(**SMOKE_DATA, device=device, dtype=dtype)
    else:
        data = load_life(device=device, dtype=dtype)
    model = build_model(data.shape[-2:], rng.next_generator(), device, dtype, smoke)
    fit(model, data, iters)
    pa = model.particular_assignment().cpu().numpy()
    print(
        "object usage (batch 0, last frame):",
        np.bincount(pa[-1, 0], minlength=model.number_of_objects + 1).tolist(),
    )
    if plots and can_plot():
        from .animate_results import animate_results

        gif = out_path("wil.gif", smoke)
        animate_results("particular", gif).make_movie(model, data, (0,))
        print("wrote", gif)
    return model


if __name__ == "__main__":
    main()
