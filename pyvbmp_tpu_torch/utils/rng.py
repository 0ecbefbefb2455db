"""Seeding for scripts (counterpart of pyvbmp_tpu/utils/rng.py).

Every constructor of this package takes an explicit ``generator``; a script
that wants one seed for a whole run calls ``seed(s)`` once and passes
``next_generator()`` to each constructor in turn.  The generators come from
one seeded sequence of this module's own, so a seed reproduces the run;
nothing here touches torch's global generator.
"""
from __future__ import annotations

import torch

_state = {"generator": torch.Generator().manual_seed(0)}


def seed(s: int) -> None:
    """Restart the sequence from seed ``s``."""
    _state["generator"] = torch.Generator().manual_seed(int(s))


def next_generator(device="cpu"):
    """A fresh ``torch.Generator`` on ``device``, seeded by the next draw of
    the sequence.  The default is a CPU generator, which is what every
    constructor of this package draws from (its draws are made on the CPU,
    so a seed gives the same numbers on every device)."""
    s = int(torch.randint(0, 2**62, (), generator=_state["generator"]))
    return torch.Generator(device=device).manual_seed(s)
