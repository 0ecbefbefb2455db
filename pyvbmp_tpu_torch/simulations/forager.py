"""Foraging-agent simulator (counterpart of
pyvbmp_tpu/simulations/forager.py).  The agent logic runs on the host in
plain Python, with Python's ``random`` module seeded as the JAX package
seeds it, so a seed gives the JAX package's numbers; the outputs are
float32 tensors on ``device``, the card unless the caller asks for
another."""
from __future__ import annotations

import math
import random

import numpy as np
import torch

from ..utils.torchutils import default_device


class Forager:
    def __init__(self):
        self.num_foods = 10
        self.food_range = 100
        self.forager_speed = 1
        self.vision_range = 20
        self.max_food_items = 3
        self.d_max = 75
        self.num_steps = 2000
        self.noise = 0.5

    def _walk(self, seed=None):
        """One agent's run as float32 numpy arrays: positions (steps + 1,
        2), food positions (steps + 1, foods, 2) and memory flags (steps +
        1, foods)."""
        if seed is not None:
            random.seed(seed)
        rand = lambda: random.uniform(-self.food_range, self.food_range)
        foods = [(rand(), rand()) for _ in range(self.num_foods)]
        loc = (0.0, 0.0)
        memory = []
        food_collected = 0
        food_in_memory = [0] * self.num_foods
        forager_positions = [loc]
        food_positions = [foods[:]]
        food_memory = [food_in_memory[:]]
        rand_direction = 2 * math.pi * random.uniform(0, 1)

        def move(loc, angle):
            return (
                loc[0] + self.forager_speed * math.cos(angle) + random.normalvariate(0, self.noise),
                loc[1] + self.forager_speed * math.sin(angle) + random.normalvariate(0, self.noise),
            )

        for _ in range(self.num_steps):
            new_items = [
                f
                for f in foods
                if f not in memory
                and math.hypot(loc[0] - f[0], loc[1] - f[1]) <= self.vision_range
            ]
            if new_items:
                memory.extend(new_items)
                for f in new_items:
                    food_in_memory[foods.index(f)] = 1

            if food_collected == self.max_food_items:
                angle = math.atan2(-loc[1], -loc[0])
                loc = move(loc, angle)
                if math.hypot(loc[0], loc[1]) <= self.forager_speed:
                    food_collected = 0
                    rand_direction = 2 * math.pi * random.uniform(0, 1)

            if food_collected < self.max_food_items:
                if memory:
                    nearest = min(
                        memory, key=lambda f: math.hypot(loc[0] - f[0], loc[1] - f[1])
                    )
                    angle = math.atan2(nearest[1] - loc[1], nearest[0] - loc[0])
                    loc = move(loc, angle)
                    if math.hypot(loc[0] - nearest[0], loc[1] - nearest[1]) <= self.forager_speed:
                        food_in_memory[foods.index(nearest)] = 0
                        foods[foods.index(nearest)] = (rand(), rand())
                        memory.remove(nearest)
                        food_collected += 1
                elif math.hypot(loc[0], loc[1]) <= self.d_max:
                    loc = move(loc, rand_direction)
                else:
                    loc = move(loc, math.atan2(loc[1], loc[0]) + math.pi / 2)

            forager_positions.append(loc)
            food_positions.append(foods[:])
            food_memory.append(food_in_memory[:])

        return (
            np.asarray(forager_positions, np.float32),
            np.asarray(food_positions, np.float32),
            np.asarray(food_memory, np.float32),
        )

    def simulate(self, seed=None, device=None):
        """One run: (positions, food positions, memory flags) as float32
        tensors on ``device``."""
        device = default_device(device)
        return tuple(torch.from_numpy(a).to(device) for a in self._walk(seed))

    def simulate_batches(self, batch_num, seed=0, device=None):
        """``batch_num`` runs seeded seed, seed + 1, ...: (steps + 1, batch,
        1 + foods, 2) agent and food positions and (steps + 1, batch,
        foods) memory flags on ``device``."""
        device = default_device(device)
        fp = np.zeros((self.num_steps + 1, batch_num, 2), np.float32)
        foodp = np.zeros((self.num_steps + 1, batch_num, self.num_foods, 2), np.float32)
        foodm = np.zeros((self.num_steps + 1, batch_num, self.num_foods), np.float32)
        for i in range(batch_num):
            fp[:, i], foodp[:, i], foodm[:, i] = self._walk(seed=seed + i)
        data = np.concatenate([fp[:, :, None, :], foodp], -2)
        return torch.from_numpy(data).to(device), torch.from_numpy(foodm).to(device)
