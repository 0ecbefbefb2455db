"""DMBD with multiple objects on flocking data, with the scan smoothers
(counterpart of examples/flocking_example.py, reference
examples/Flocking_example.py:33-41; the boids simulator generates the
tracks).  At full width the sweeps run the logsemiring scan at (T, K, N) =
(200, 14, 120) and the plane Kalman scan at (200, 14, 10), two launches of
each a sweep.

    python -m pyvbmp_tpu_torch.examples.flocking_example
"""
import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..simulations import Flocking
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, OBJECTS, BIRDS, TMAX, BATCH = 20, 3, 12, 200, 10
SMOKE_ITERS, SMOKE_OBJECTS, SMOKE_BIRDS, SMOKE_TMAX, SMOKE_BATCH = 2, 2, 6, 30, 2


def simulator(smoke=False):
    if smoke:
        return Flocking(n_birds=SMOKE_BIRDS, Tmax=SMOKE_TMAX, batch_size=SMOKE_BATCH)
    return Flocking(n_birds=BIRDS, Tmax=TMAX, batch_size=BATCH)


def make_data(smoke=False, generator=None, device=None, dtype=torch.float32, draws=None):
    """(T, batch, birds, 4) in ``dtype`` on ``device``; ``draws``
    (Flocking.integrate's arguments) replace the generator's."""
    device = default_device(device)
    sim = simulator(smoke)
    if draws is None:
        data = sim.simulate(generator, device=device)
    else:
        data = sim.integrate(*(d.to(device) for d in draws))
    return data.to(dtype)


def build_model(generator=None, device=None, dtype=None, number_of_objects=OBJECTS,
                n_birds=BIRDS):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=(n_birds, 4), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2),
        number_of_objects=number_of_objects, parallel_scan=True,
        generator=generator, dtype=dtype, device=device,
    )


def fit(model, data, iters=ITERS, verbose=True):
    model.update(data, iters=iters, latent_iters=1, lr=0.5, verbose=verbose)
    return model


def main(iters=ITERS, number_of_objects=OBJECTS, device=None, smoke=None, plots=True,
         dtype=torch.float32):
    smoke = smoke_mode(smoke)
    if smoke:
        iters, number_of_objects = SMOKE_ITERS, SMOKE_OBJECTS
    device = default_device(device)
    rng.seed(0)
    data = make_data(smoke, rng.next_generator(), device, dtype)
    model = build_model(rng.next_generator(), device, dtype, number_of_objects,
                        data.shape[-2])
    fit(model, data, iters)
    pa = numpy(model.particular_assignment())
    print("ELBO trace:", ["%.0f" % e for e in model.ELBO_save])
    print("per-bird object frequencies (last frame):")
    for b in range(data.shape[-2]):
        vals, counts = np.unique(pa[-1, :, b], return_counts=True)
        print("  bird", b, dict(zip(vals.tolist(), counts.tolist())))
    return model


if __name__ == "__main__":
    main()
