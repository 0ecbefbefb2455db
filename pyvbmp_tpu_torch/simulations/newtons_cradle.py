"""Pendulum-chain (Newton's cradle) simulator with collision handling
(counterpart of pyvbmp_tpu/simulations/newtons_cradle.py).

The random part and the deterministic part are apart: ``draws`` takes the
uniform draws an ``init_type`` needs from a ``torch.Generator`` (made on
the CPU in float64, so a seed gives the same draws on every device),
``initial_angles`` maps them to the starting angles and ``integrate`` steps
the chain from those angles on their device.  The JAX package's draws can
be fed to either, so the two packages run on the same numbers."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.torchutils import default_device


def _parse(init_type):
    """("random", ()), ("object", (m,)) or ("pair", (ml, mr))."""
    if init_type == "random":
        return "random", ()
    if init_type.endswith("ball object") and "+" not in init_type:
        return "object", (int(init_type.split(" ")[0]),)
    if "+" in init_type:
        parts = init_type.split(" ")
        return "pair", (int(parts[0]), int(parts[2]))
    raise ValueError(f"unknown init_type {init_type}")


class NewtonsCradle:
    def __init__(self, n_balls, ball_size, Tmax, batch_size, g, leak, dt,
                 include_string=False):
        self.n_balls = n_balls
        self.Tmax = Tmax
        self.batch_size = batch_size
        self.dt = dt
        self.ball_size = ball_size
        self.g = g
        self.leak = leak
        self.include_string = include_string

    def x_loc(self, like):
        """The balls' rest positions, like ``like`` (dtype and device)."""
        n = self.n_balls
        return (torch.arange(n, dtype=like.dtype, device=like.device) - (n - 1) / 2) \
            * self.ball_size

    def draw_shapes(self, init_type):
        """Name -> shape of each uniform draw ``init_type`` needs, in the
        order ``draws`` takes them."""
        B, n = self.batch_size, self.n_balls
        kind, m = _parse(init_type)
        if kind == "random":
            return {"theta": (B, n)}
        if kind == "object":
            return {"left": (B, m[0]), "left_shift": (B, 1), "rest": (B, n - m[0])}
        ml, mr = m
        return {"left": (B, ml), "left_shift": (B, 1), "right": (B, mr),
                "right_shift": (B, 1), "rest": (B, n - ml - mr)}

    def draws(self, init_type="random", generator=None):
        """U[0, 1) draws for ``init_type``, float64 on the CPU."""
        return {k: torch.rand(s, generator=generator, dtype=torch.float64)
                for k, s in self.draw_shapes(init_type).items()}

    def initial_angles(self, init_type, draws):
        """(batch, n_balls) starting angles from the uniform ``draws``."""
        pi = np.pi
        kind, m = _parse(init_type)
        if kind == "random":
            return torch.sort(draws["theta"] * 2 * pi - pi, -1).values / 20.0

        def side(u, shift, sign):
            return 2 * pi * (u - 0.5) / 100 + sign * pi / 2 * (shift + 2) / 3

        theta = torch.sort(side(draws["left"], draws["left_shift"], -1), -1).values
        if kind == "object":
            other = torch.sort(2 * pi * (draws["rest"] - 0.5), -1).values / 100.0
            return torch.cat([theta, other], -1)
        right = torch.sort(side(draws["right"], draws["right_shift"], +1), -1).values
        if draws["rest"].shape[-1] > 0:
            other = torch.sort(2 * pi * (draws["rest"] - 0.5), -1).values / 1000.0
            return torch.cat([theta, other, right], -1)
        return torch.cat([theta, right], -1)

    def initialize(self, init_type="random", generator=None, device=None):
        """Starting angles (batch, n_balls), float64 on ``device`` (the card
        unless the caller asks for another)."""
        device = default_device(device)
        draws = {k: v.to(device) for k, v in self.draws(init_type, generator).items()}
        return self.initial_angles(init_type, draws)

    def integrate(self, theta0):
        """Trajectories from the starting angles theta0 (batch, n_balls):
        (Tmax, batch, n_balls * strings, 2) positions and (Tmax, batch,
        n_balls) angles, on theta0's device.  Each step's collision sweep
        over the pairs (k-1, k), k = 1..n-1, is sequential: a pair reads
        the velocities the pairs before it swapped."""
        dt, g, leak, bs = self.dt, self.g, self.leak, self.ball_size
        x_loc = self.x_loc(theta0)
        theta_prev, v_prev = theta0, torch.zeros_like(theta0)
        thetas = [theta0]
        for _ in range(self.Tmax - 1):
            v = v_prev - dt * g * torch.sin(theta_prev) - leak * dt * v_prev
            theta = theta_prev + dt * v
            X = torch.sin(theta) + x_loc
            Y = -torch.cos(theta)
            for k in range(1, self.n_balls):
                dist = (X[:, k] - X[:, k - 1]) ** 2 + (Y[:, k] - Y[:, k - 1]) ** 2
                hit = (dist < bs ** 2).to(theta.dtype)
                v_km1, v_k = v[:, k - 1], v[:, k]
                v = v.clone()
                v[:, k - 1] = v_k * hit + v_km1 * (1 - hit)
                v[:, k] = v_km1 * hit + v_k * (1 - hit)
                theta = theta.clone()
                theta[:, k - 1] = theta_prev[:, k - 1] + dt * v[:, k - 1]
                theta[:, k] = theta_prev[:, k] + dt * v[:, k]
            theta = torch.sort(theta, -1).values
            theta_prev, v_prev = theta, v
            thetas.append(theta)
        theta = torch.stack(thetas)

        X = torch.sin(theta) + x_loc
        Y = -torch.cos(theta)
        s = self.include_string
        if isinstance(s, int) and not isinstance(s, bool):
            for k in range(1, s):
                R = 1 - k / s
                X = torch.cat([X, torch.sin(theta) * R + x_loc], -1)
                Y = torch.cat([Y, -torch.cos(theta) * R], -1)
        return torch.stack([X, Y], -1), theta

    def generate_data(self, init_type="random", generator=None, device=None):
        """``integrate(initialize(init_type, generator, device))``."""
        return self.integrate(self.initialize(init_type, generator, device))
