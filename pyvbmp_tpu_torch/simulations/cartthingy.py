"""Cart + double pendulum simulator (counterpart of
pyvbmp_tpu/simulations/cartthingy.py).

``initial_state`` draws the starting state from a ``torch.Generator`` (on
the CPU in float64, so a seed gives the same state on every device);
``integrate`` steps the system from any starting state on its device, so
the JAX package's starting state can be fed to it."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.torchutils import default_device

M_C, M_P1, M_P2 = 1.0, 0.5, 0.5
L1 = L2 = 1.0
G = 1.0
ATTRACTOR = 0.1
DT = 0.02
T_END = 50.0


class cartthingy:
    @staticmethod
    def initial_state(batch_num=1, generator=None):
        """(batch, 6) float64 on the CPU: cart position ~ N(0, 1), both
        angles ~ U(-pi/2, pi/2], all velocities 0."""
        x0 = torch.randn(batch_num, generator=generator, dtype=torch.float64)
        th1 = np.pi / 2 - np.pi * torch.rand(batch_num, generator=generator,
                                             dtype=torch.float64)
        th2 = np.pi / 2 - np.pi * torch.rand(batch_num, generator=generator,
                                             dtype=torch.float64)
        zero = torch.zeros_like(x0)
        return torch.stack([x0, th1, th2, zero, zero, zero], -1)

    @staticmethod
    def integrate(state0):
        """Euler steps from state0 (batch, 6) = (x, theta1, theta2, and
        their velocities) over T_END / DT steps, every fifth kept: (N', batch,
        6) on state0's device."""
        traj = [state0]
        state = state0
        for _ in range(int(T_END / DT) - 1):
            x, th1, th2, xd, th1d, th2d = state.unbind(-1)
            s1, s2, c1, c2 = torch.sin(th1), torch.sin(th2), torch.cos(th1), torch.cos(th2)
            denom = M_C + M_P1 * s1 ** 2 + M_P2 * s2 ** 2
            xdd = (
                -ATTRACTOR * x
                + s1 * (M_P1 * L1 * th1d ** 2)
                + s2 * (M_P2 * L2 * th2d ** 2)
                + M_P1 * G * s1 * c1
                + M_P2 * G * s2 * c2
            ) / denom
            th1dd = -G * L1 * s1 - c1 * xdd / L1
            th2dd = -G * L2 * s2 - c2 * xdd / L2
            state = torch.stack([x + xd * DT, th1 + th1d * DT, th2 + th2d * DT,
                                 xd + xdd * DT, th1d + th1dd * DT, th2d + th2dd * DT], -1)
            traj.append(state)
        return torch.stack(traj)[::5]

    @staticmethod
    def simulate(batch_num=1, generator=None, state0=None, device=None):
        """``integrate`` from ``state0``, or from ``initial_state(batch_num,
        generator)``, on ``device`` (the card unless the caller asks for
        another)."""
        device = default_device(device)
        if state0 is None:
            state0 = cartthingy.initial_state(batch_num, generator)
        return cartthingy.integrate(torch.as_tensor(state0, dtype=torch.float64).to(device))
