"""Runtime calls a sweep in which the host waits for the device, inside
``dmbd.update``: ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the synchronous ``cudaMemcpy``
(``charge.SYNCS``; ``cardbench/charge.py``).  Each drains the device's
queue, so every kernel after it waits on the host's dispatch."""
from cardbench import charge


def read(ctx):
    return charge.calls_in_update(ctx, charge.SYNCS)
