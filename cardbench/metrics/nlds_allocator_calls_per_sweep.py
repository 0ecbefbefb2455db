"""``cudaMalloc`` plus ``cudaFree`` calls a sweep inside ``nlds.update``
(``charge.ALLOCATOR``; ``cardbench/nlds_charge.py``): in a steady state the
caching allocator makes none, and ``cudaFree`` waits for the device."""
from cardbench import charge, nlds_charge


def read(ctx):
    return nlds_charge.calls_in_update(ctx, charge.ALLOCATOR)
