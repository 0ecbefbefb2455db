"""Runtime calls a sweep in which the host waits for the device, inside
``nlds.update`` (``charge.SYNCS``; ``cardbench/nlds_charge.py``).  The
ELBO fetch (``nlds.elbo_fetch``) is the one meant to be there; each other
drains the device's queue."""
from cardbench import charge, nlds_charge


def read(ctx):
    return nlds_charge.calls_in_update(ctx, charge.SYNCS)
