"""Device kernels a sweep launched inside the NLDS s E-step
(``nlds.s_estep``: the observation, dynamics and transition logits and the
driven forward-backward with its scans; ``cardbench/nlds_charge.py``).  The
sequential forward-backward launches some fifty a time step; the scan
route a few hundred in all."""
from cardbench import nlds_charge


def read(ctx):
    return nlds_charge.launches_in(ctx, "nlds.s_estep")
