"""Recurrent switching LDS on synthetic regime-switching rotations
(counterpart of examples/nlds_example.py).  Its smoother is the lane
Kalman scan (h = 2), two launches a sweep.

    python -m pyvbmp_tpu_torch.examples.nlds_example
"""
import numpy as np
import torch

from ..models import NLDS
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, RESTARTS, T, B = 30, 6, 200, 8
SMOKE_ITERS, SMOKE_RESTARTS, SMOKE_T, SMOKE_B = 2, 1, 60, 4


def make_data(T=T, B=B, seed=0, device=None, dtype=torch.float32):
    """(y (T, B, 3) in ``dtype`` on ``device``, the true regimes (T, B) as
    numpy)."""
    device = default_device(device)

    def rot(th):
        return np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])

    rs = np.random.RandomState(seed)
    As = [0.98 * rot(0.08), 0.98 * rot(0.5)]  # slow vs fast rotation regimes
    C = rs.randn(3, 2)
    x = rs.randn(B, 2)
    ys, zs = [], []
    z = np.zeros(B, int)
    for t in range(T):
        if t % 50 == 0 and t > 0:
            z = 1 - z
        A = np.stack([As[zi] for zi in z])
        x = np.einsum("bij,bj->bi", A, x) + 0.05 * rs.randn(B, 2)
        ys.append(x @ C.T + 0.1 * rs.randn(B, 3))
        zs.append(z.copy())
    return torch.as_tensor(np.stack(ys), dtype=dtype, device=device), np.stack(zs)


def build_model(generator=None, device=None, dtype=None):
    return NLDS((3,), hidden_dim=2, mixture_dim=2, generator=generator, dtype=dtype,
                device=device)


def fit(model, y, iters=ITERS, restarts=RESTARTS, verbose=True):
    return model.fit(y, iters=iters, restarts=restarts, verbose=verbose)


def accuracy(model, ztrue):
    """Segmentation accuracy against the true regimes, up to the labels'
    order."""
    hard = numpy(model.assignment())
    return max((hard == ztrue).mean(), (hard == 1 - ztrue).mean())


def main(iters=ITERS, restarts=RESTARTS, device=None, smoke=None, plots=True,
         dtype=torch.float32):
    smoke = smoke_mode(smoke)
    if smoke:
        iters, restarts = SMOKE_ITERS, SMOKE_RESTARTS
    device = default_device(device)
    rng.seed(0)
    y, ztrue = make_data(*((SMOKE_T, SMOKE_B) if smoke else (T, B)), device=device,
                         dtype=dtype)
    model = fit(build_model(rng.next_generator(), device, dtype), y, iters, restarts)
    print(f"segmentation accuracy vs true regimes: {accuracy(model, ztrue):.3f}")
    print("per-state dynamics norms:", np.round(np.linalg.norm(
        numpy(model.A.mu)[:, :, :-1], axis=(1, 2)), 3))
    return model


if __name__ == "__main__":
    main()
