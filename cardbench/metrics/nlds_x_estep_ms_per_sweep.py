"""Device ms a sweep of the kernels launched inside the NLDS x E-step
(``nlds.x_estep``: the potentials mixed under q(s), the observation
messages, the lane Kalman smoother and its scans, the moments;
``cardbench/nlds_charge.py``)."""
from cardbench import nlds_charge


def read(ctx):
    return nlds_charge.device_ms_in(ctx, "nlds.x_estep")
