"""Device ms a sweep of the kernels launched inside the NLDS gate
(``nlds.gate``: the transition MNLR's two Polya-Gamma iterations over the
(samples, K, K - 1, p, p) outer-product tensor, then pi0;
``cardbench/nlds_charge.py``)."""
from cardbench import nlds_charge


def read(ctx):
    return nlds_charge.device_ms_in(ctx, "nlds.gate")
