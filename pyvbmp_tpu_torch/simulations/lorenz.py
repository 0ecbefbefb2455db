"""Batched Lorenz-63 simulator with per-trajectory parameter jitter, velocity
channels, smoothing + decimation and std-normalization (counterpart of
pyvbmp_tpu/simulations/lorenz.py; random draws come from a
``torch.Generator``, so a seed does not give the JAX package's numbers).
The draws are made on the CPU, so a seed gives the same draws on every
device; the integration runs on ``device``, the card unless the caller asks
for another."""
from __future__ import annotations

import torch

from ..utils.torchutils import default_device


class Lorenz:
    def __init__(self):
        self.sigma = 10.0
        self.rho = 28.0
        self.beta = 8.0 / 3.0
        self.dt = 0.01
        self.num_steps = 2000

    def simulate(self, batch_num, generator=None, device=None):
        """(T, batch, 3, 2) float64 on ``device``: positions and velocities,
        T = (num_steps - 1) // 5 after smoothing and decimation."""
        device = default_device(device)
        f64 = torch.float64
        u = [torch.rand(batch_num, generator=generator, dtype=f64) for _ in range(3)]
        xyz0 = torch.randn(3, batch_num, generator=generator, dtype=f64)
        return self.integrate(*(x.to(device) for x in (*u, xyz0)))

    def integrate(self, u_sigma, u_rho, u_beta, xyz0):
        """``simulate`` from its draws: U[0, 1) jitters (batch,) of sigma,
        rho and beta and the starting points xyz0 (3, batch), on their
        device."""
        jitter = 0.02

        def jittered(value, u):
            return value * (1 + 2 * (u - 0.5) * jitter)

        sigma, rho, beta = (jittered(v, u) for v, u in
                            ((self.sigma, u_sigma), (self.rho, u_rho), (self.beta, u_beta)))
        x, y, z = xyz0
        traj = []
        for _ in range(self.num_steps):
            dx = sigma * (y - x)
            dy = x * (rho - z) - y
            dz = x * y - beta * z
            x, y, z = x + dx * self.dt, y + dy * self.dt, z + dz * self.dt
            traj.append(torch.stack([x, y, z], -1))
        data = torch.stack(traj, 0)  # (T, batch, 3)

        n_smoothe = 5
        v_data = (data[1:] - data[:-1]) / self.dt
        data = torch.stack([data[1:], v_data], -1)
        data = self._smoothe(data, n_smoothe)[::n_smoothe]
        return data / data.std(dim=(0, 1, 2), keepdim=True, correction=0)

    @staticmethod
    def _smoothe(data, n):
        out = 0.0
        for i in range(n):
            out = out + data[i : data.shape[0] - n + i]
        return out / n
