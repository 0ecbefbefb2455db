"""``cudaMalloc`` plus ``cudaFree`` calls a sweep inside ``dmbd.update``
(``charge.ALLOCATOR``; ``cardbench/charge.py``): in a steady state the
caching allocator makes none, and ``cudaFree`` waits for the device."""
from cardbench import charge


def read(ctx):
    return charge.calls_in_update(ctx, charge.ALLOCATOR)
