"""DMBD on Newton's-cradle data (counterpart of
examples/newtons_cradle_example.py, reference
examples/NewtonsCradle_example.py).

    python -m pyvbmp_tpu_torch.examples.newtons_cradle_example
"""
import numpy as np
import torch

from ..models import DynamicMarkovBlanketDiscovery
from ..simulations import NewtonsCradle
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, TMAX, BATCH = 20, 200, 10
SMOKE_ITERS, SMOKE_TMAX, SMOKE_BATCH = 2, 30, 2
INIT_TYPE = "1 ball object"


def simulator(smoke=False):
    Tmax, batch_size = (SMOKE_TMAX, SMOKE_BATCH) if smoke else (TMAX, BATCH)
    return NewtonsCradle(n_balls=5, ball_size=0.2, Tmax=Tmax, batch_size=batch_size,
                         g=1, leak=0.01, dt=0.05)


def make_data(smoke=False, generator=None, device=None, dtype=torch.float32, draws=None):
    """(T, batch, 5, 2) ball positions in ``dtype`` on ``device``; ``draws``
    (NewtonsCradle.initial_angles's) replace the generator's."""
    device = default_device(device)
    sim = simulator(smoke)
    if draws is None:
        data, theta = sim.generate_data(INIT_TYPE, generator, device)
    else:
        theta0 = sim.initial_angles(INIT_TYPE, {k: v.to(device) for k, v in draws.items()})
        data, theta = sim.integrate(theta0)
    return data.to(dtype)


def build_model(generator=None, device=None, dtype=None):
    return DynamicMarkovBlanketDiscovery(
        obs_shape=(5, 2), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2),
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
    a = numpy(model.particular_assignment())
    print("per-ball object assignment frequencies:")
    for ball in range(5):
        vals, counts = np.unique(a[..., ball], return_counts=True)
        print(" ball", ball, dict(zip(vals.tolist(), counts.tolist())))
    return model


if __name__ == "__main__":
    main()
