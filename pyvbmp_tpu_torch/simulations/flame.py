"""1-D heat-diffusion / ignition simulator by Green's functions
(counterpart of pyvbmp_tpu/simulations/flame.py).

Its one random number, the uniform that scales the sources' heat, comes
from a ``torch.Generator`` (drawn on the CPU in float64) or as
``heat_draw``, so the JAX package's draw can be fed to it.  Everything
else is deterministic and runs on ``device``, the card unless the caller
asks for another.  A source that has not ignited has ignition time -inf,
and the Green's function of a source at t - t0 <= 0 is 0, as in the JAX
package."""
from __future__ import annotations

import numpy as np
import torch

from ..utils.torchutils import default_device


class FlameSimulator:
    def __init__(self, num_steps, delta_t, thermal_diffusivity, temperature_threshold,
                 num_sources, generator=None, heat_draw=None, device=None,
                 dtype=torch.float64):
        device = default_device(device)
        self.num_steps = num_steps
        self.delta_t = delta_t
        self.thermal_diffusivity = thermal_diffusivity
        self.temperature_threshold = temperature_threshold
        self.num_sources = num_sources
        self.beta = 10
        if heat_draw is None:
            heat_draw = torch.rand(1, generator=generator, dtype=torch.float64)
        elif not isinstance(heat_draw, torch.Tensor):
            heat_draw = torch.tensor(np.array(heat_draw, np.float64))
        u = heat_draw.to(device=device, dtype=dtype).reshape(1)
        k = torch.arange(num_sources, dtype=dtype, device=device)
        heat = torch.sin(k * 2 * np.pi / num_sources * 5) * 0.4 * u + 1.0
        heat[0] = 5.0
        self.heat = heat
        locs = torch.linspace(0, num_sources, num_sources, dtype=dtype, device=device)
        locs[0] = -1.0
        self.source_locations = locs
        ign = torch.full((num_sources,), -float("inf"), dtype=dtype, device=device)
        ign[0] = -1.0
        self.ignition_times = ign

    def greens_function(self, x, x0, t, t0, amp):
        dt = t - t0
        kappa = self.thermal_diffusivity
        temp = amp * torch.exp(-((x - x0) ** 2) / (4 * kappa * dt)) \
            / torch.sqrt(4 * np.pi * kappa * dt)
        return torch.where(dt <= 0, torch.zeros_like(temp), temp)

    def sum_greens_functions(self, x, x0, t, t0, amp):
        t = t.reshape(t.numel(), 1, 1)
        x = x.reshape(1, x.numel(), 1)
        x0 = x0.reshape(1, 1, x0.numel())
        t0 = t0.reshape(1, 1, t0.numel())
        amp = amp.reshape(1, 1, amp.numel())
        return self.greens_function(x, x0, t, t0, amp).sum(-1).squeeze()

    def simulate(self):
        """Sequential ignition dynamics, one step at a time: returns the
        temperatures (num_steps, num_sources), capped at 2, and the final
        ignition times and heats (also kept on the simulator)."""
        locs = self.source_locations
        ign, heat = self.ignition_times, self.heat
        temps = []
        for step in range(self.num_steps):
            t = step * self.delta_t
            temp = self.greens_function(
                locs[:, None], locs[None, :], t, ign[None, :], heat[None, :]
            ).sum(-1)
            idx = (temp > self.temperature_threshold) & torch.isneginf(ign)
            ign = torch.where(idx, torch.full_like(ign, t), ign)
            heat = torch.where(idx, heat + np.sin(t * 2 * np.pi) * 0.2, heat)
            temps.append(torch.clamp(temp, max=2.0))
        self.ignition_times, self.heat = ign, heat
        return torch.stack(temps), ign, heat

    def fine_grain(self, num_x=1000, ignition_times=None, heat=None):
        """Temperature, fuel and oxidizer on a grid of ``num_x`` points,
        (num_steps, num_x) each, and the sources' grid indices."""
        if ignition_times is None:
            ignition_times = self.ignition_times
        if heat is None:
            heat = self.heat
        locs = self.source_locations
        delta_x = self.num_sources / num_x
        x = torch.linspace(0, self.num_sources, num_x, dtype=locs.dtype, device=locs.device)
        t = torch.arange(self.num_steps, dtype=locs.dtype, device=locs.device) * self.delta_t
        fine_temp = self.sum_greens_functions(x, locs, t, ignition_times, heat)
        fine_temp = torch.clamp(fine_temp, max=2.0)
        fuel, ox = self.fuel_ox_blobs(x, locs, t, ignition_times, heat)
        src_idx = torch.trunc(locs[1:] / delta_x).to(torch.int64)
        return fine_temp, fuel, ox, src_idx

    def fuel_ox_blobs(self, x, x0, t, t0, amp):
        x = x[..., None, None]
        t = t[..., None]
        x0 = x0[1:][None, :]
        t0 = t0[1:][None, :]
        fuel = torch.exp(-((x - x0) ** 2) / 0.1) * torch.sigmoid((t0 - t) / 0.1)
        ox = 0.5 * torch.exp(-((x - x0) ** 2) / 0.2) * torch.exp(-((t0 - t) ** 2) / 0.2)
        return fuel.sum(-1).transpose(-2, -1), 1 - ox.sum(-1).transpose(-2, -1)
