"""Boids-style flocking simulator (counterpart of
pyvbmp_tpu/simulations/flocking.py): (T, batch, n_birds, 4) position and
velocity trajectories under separation, alignment and cohesion, with a mild
pull to the origin, a speed limit and std-normalization.

Random draws come from a ``torch.Generator``, so a seed does not give the
JAX package's numbers; ``integrate`` takes the draws themselves, so the two
packages can be run on the same ones.  ``simulate`` makes its draws on the
CPU, so a seed gives the same draws on every device, and integrates on
``device``, the card unless the caller asks for another."""
from __future__ import annotations

import torch

from ..utils.torchutils import default_device


class Flocking:
    def __init__(self, n_birds=12, Tmax=200, batch_size=10, dt=0.05,
                 sep_radius=0.5, align_radius=1.5, coh_radius=2.5,
                 sep_w=1.0, align_w=0.4, coh_w=0.3, noise=0.05, speed=1.0):
        self.n_birds = n_birds
        self.Tmax = Tmax
        self.batch_size = batch_size
        self.dt = dt
        self.sep_radius = sep_radius
        self.align_radius = align_radius
        self.coh_radius = coh_radius
        self.sep_w = sep_w
        self.align_w = align_w
        self.coh_w = coh_w
        self.noise = noise
        self.speed = speed

    def simulate(self, generator=None, dtype=torch.float64, device=None):
        """(Tmax, batch_size, n_birds, 4) trajectories on ``device``, from
        initial positions ~ N(0, 2^2), velocities ~ N(0, 0.5^2) and
        standard normal acceleration noise drawn from ``generator``."""
        device = default_device(device)
        B, N = self.batch_size, self.n_birds

        def draw(*shape):
            return torch.randn(shape, generator=generator, dtype=dtype).to(device)

        pos0 = draw(B, N, 2) * 2.0
        vel0 = draw(B, N, 2) * 0.5
        noise = draw(self.Tmax, B, N, 2)
        return self.integrate(pos0, vel0, noise)

    def _rules(self, pos, vel):
        N = pos.shape[-2]
        d = pos[:, :, None, :] - pos[:, None, :, :]  # (B, N, N, 2) i - j
        dist = torch.sqrt((d**2).sum(-1) + 1e-6)
        eye = torch.eye(N, dtype=torch.bool, device=pos.device)

        def nbr(radius):
            return ((dist < radius) & ~eye).to(pos.dtype)

        m_sep = nbr(self.sep_radius)
        m_align = nbr(self.align_radius)
        m_coh = nbr(self.coh_radius)
        # separation: push away from close neighbours
        sep = (d / dist[..., None] ** 2 * m_sep[..., None]).sum(2)
        # alignment: match the neighbours' velocity
        cnt_a = m_align.sum(-1, keepdim=True) + 1e-6
        align = (vel[:, None, :, :] * m_align[..., None]).sum(2) / cnt_a - vel
        # cohesion: move toward the neighbours' centre of mass
        cnt_c = m_coh.sum(-1, keepdim=True) + 1e-6
        coh = (pos[:, None, :, :] * m_coh[..., None]).sum(2) / cnt_c - pos
        # mild attraction to the origin keeps the flock bounded
        home = -0.05 * pos
        return self.sep_w * sep + self.align_w * align + self.coh_w * coh + home

    def integrate(self, pos0, vel0, noise):
        """Trajectories from pos0, vel0 (batch, n_birds, 2) and the standard
        normal acceleration noise (T, batch, n_birds, 2): (T, batch,
        n_birds, 4) positions and velocities, divided by their std."""
        pos, vel = pos0, vel0
        traj = []
        for z in noise:
            acc = self._rules(pos, vel) + self.noise * z
            vel = vel + self.dt * acc
            sp = torch.sqrt((vel**2).sum(-1, keepdim=True) + 1e-8)
            vel = vel * torch.clamp(self.speed / sp, max=1.0)  # speed limit
            pos = pos + self.dt * vel
            traj.append(torch.cat([pos, vel], -1))
        data = torch.stack(traj)
        return data / data.std(dim=(0, 1, 2), keepdim=True, correction=0)
