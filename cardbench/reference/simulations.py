"""Frozen copies of the two simulators the benchmark's data comes from:
batched Lorenz-63 and boids flocking, as the port's ``simulations/lorenz.py``
and ``simulations/flocking.py`` stood when the benchmark was defined.  A
later change to the port's simulators cannot move the benchmark's data.

Draws come from a ``torch.Generator`` on ``device`` (a seed gives the same
data on every run on one kind of device), the integration runs on
``device`` in float64.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def lorenz(batch, num_steps, generator, device, sigma=10.0, rho=28.0, beta=8.0 / 3.0,
           parameter_jitter=0.02, dt=0.01, smoothing_steps=5, keep_every=5):
    """(T, batch, 3, 2) positions and velocities of ``batch`` Lorenz-63
    trajectories with ``parameter_jitter`` on sigma, rho and beta, integrated
    by Euler steps of ``dt`` for ``num_steps`` steps, smoothed over
    ``smoothing_steps`` steps, every ``keep_every``-th kept, divided by their
    std; T = (num_steps - 1 - smoothing_steps - 1) // keep_every + 1."""
    u = [torch.rand(batch, generator=generator, dtype=F64, device=device) for _ in range(3)]
    x, y, z = torch.randn(3, batch, generator=generator, dtype=F64, device=device)
    sigma, rho, beta = (v * (1 + 2 * (ui - 0.5) * parameter_jitter)
                        for v, ui in zip((sigma, rho, beta), u))
    traj = []
    for _ in range(num_steps):
        dx = sigma * (y - x)
        dy = x * (rho - z) - y
        dz = x * y - beta * z
        x, y, z = x + dx * dt, y + dy * dt, z + dz * dt
        traj.append(torch.stack([x, y, z], -1))
    data = torch.stack(traj, 0)
    n = smoothing_steps
    data = torch.stack([data[1:], (data[1:] - data[:-1]) / dt], -1)
    data = sum(data[i:data.shape[0] - n + i] for i in range(n)) / n
    data = data[::keep_every]
    return data / data.std(dim=(0, 1, 2), keepdim=True, correction=0)


def flocking(batch, n_birds, T, generator, device, dt=0.05, sep_radius=0.5,
             align_radius=1.5, coh_radius=2.5, sep_w=1.0, align_w=0.4, coh_w=0.3,
             noise=0.05, speed=1.0):
    """(T, batch, n_birds, 4) positions and velocities of boids under
    separation, alignment and cohesion, a mild pull to the origin and a
    speed limit, from positions ~ N(0, 2^2), velocities ~ N(0, 0.5^2) and
    standard normal acceleration noise, divided by their std."""
    def draw(*shape):
        return torch.randn(shape, generator=generator, dtype=F64, device=device)

    pos, vel = draw(batch, n_birds, 2) * 2.0, draw(batch, n_birds, 2) * 0.5
    kicks = draw(T, batch, n_birds, 2)
    eye = torch.eye(n_birds, dtype=torch.bool, device=device)
    traj = []
    for z in kicks:
        d = pos[:, :, None, :] - pos[:, None, :, :]
        dist = torch.sqrt((d ** 2).sum(-1) + 1e-6)
        m_sep, m_align, m_coh = (((dist < r) & ~eye).to(F64)
                                 for r in (sep_radius, align_radius, coh_radius))
        sep = (d / dist[..., None] ** 2 * m_sep[..., None]).sum(2)
        align = ((vel[:, None] * m_align[..., None]).sum(2)
                 / (m_align.sum(-1, keepdim=True) + 1e-6) - vel)
        coh = ((pos[:, None] * m_coh[..., None]).sum(2)
               / (m_coh.sum(-1, keepdim=True) + 1e-6) - pos)
        acc = sep_w * sep + align_w * align + coh_w * coh - 0.05 * pos + noise * z
        vel = vel + dt * acc
        sp = torch.sqrt((vel ** 2).sum(-1, keepdim=True) + 1e-8)
        vel = vel * torch.clamp(speed / sp, max=1.0)
        pos = pos + dt * vel
        traj.append(torch.cat([pos, vel], -1))
    data = torch.stack(traj)
    return data / data.std(dim=(0, 1, 2), keepdim=True, correction=0)
