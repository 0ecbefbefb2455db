"""Device ms a sweep of the kernels launched inside the NLDS s E-step
(``nlds.s_estep``; ``cardbench/nlds_charge.py``)."""
from cardbench import nlds_charge


def read(ctx):
    return nlds_charge.device_ms_in(ctx, "nlds.s_estep")
