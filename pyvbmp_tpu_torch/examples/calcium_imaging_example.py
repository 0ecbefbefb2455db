"""DMBD on calcium-imaging traces (counterpart of
examples/calcium_imaging_example.py, reference
examples/Calcium_Imaging_example.py:9-25).

data/calciumForJeff.npy (3600 frames x 41 ROIs) is used with the
reference's reshape pipeline where it exists; otherwise synthetic calcium
traces (poisson-spiking cell assemblies convolved with an exponential
indicator kernel) stand in.  The model has no environment latents and no
boundary latents past the roles (role_dims (1, 1, 0), hidden_dims (4, 2, 0),
regression_dim -1, control_dim 0): its z blocks have width zero.

    python -m pyvbmp_tpu_torch.examples.calcium_imaging_example
"""
import os

import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, OBJECTS = 50, 5
SMOKE_ITERS, SMOKE_OBJECTS = 2, 2
SMOKE_DATA = dict(n_cells=8, n_chunks=2, chunk_len=40)


def load_calcium(data_dir="./data", n_cells=41, n_chunks=12, chunk_len=300,
                 device=None, dtype=torch.float32):
    """(chunk_len, n_chunks, n_cells, 2) traces and their differences, in
    ``dtype`` on ``device``."""
    device = default_device(device)
    T_total = n_chunks * chunk_len
    f = os.path.join(data_dir, "calciumForJeff.npy")
    if os.path.exists(f):
        data = np.load(f)[..., None].astype(np.float64)
    else:
        print("calciumForJeff.npy not found; simulating calcium traces")
        rs = np.random.RandomState(0)
        T_total = T_total + 1  # diff below drops one frame; keep the full T after
        n_assemblies = 5
        membership = rs.randint(0, n_assemblies, n_cells)
        drive = (rs.rand(T_total, n_assemblies) < 0.03).astype(float)
        spikes = drive[:, membership] * (rs.rand(T_total, n_cells) < 0.8)
        kernel = np.exp(-np.arange(30) / 8.0)
        traces = np.stack(
            [np.convolve(spikes[:, c], kernel)[:T_total] for c in range(n_cells)], -1
        )
        data = (traces + 0.05 * rs.randn(T_total, n_cells))[..., None]
    data = data / data.std()
    v = np.diff(data, axis=0)
    v = v / v.std()
    data = np.concatenate((data[1:], v), -1)[:T_total]
    # reference reshape: 12 chunks of 300 frames -> batch of 12
    data = data.reshape(n_chunks, chunk_len, -1, 2).swapaxes(0, 1)
    return torch.as_tensor(data, dtype=dtype, device=device)


def build_model(obs_shape, generator=None, device=None, dtype=None,
                number_of_objects=OBJECTS):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=tuple(obs_shape),
        role_dims=(1, 1, 0),
        hidden_dims=(4, 2, 0),
        regression_dim=-1,
        control_dim=0,
        number_of_objects=number_of_objects,
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
        data = load_calcium(**SMOKE_DATA, device=device, dtype=dtype)
    else:
        data = load_calcium(device=device, dtype=dtype)
    model = build_model(data.shape[-2:], rng.next_generator(), device, dtype,
                        SMOKE_OBJECTS if smoke else OBJECTS)
    fit(model, data, iters)
    pa = numpy(model.particular_assignment())
    print(
        "cell-to-object assignment (batch 0, last frame):",
        pa[-1, 0].tolist(),
    )
    return model


if __name__ == "__main__":
    main()
