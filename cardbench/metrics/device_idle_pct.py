"""Percent of an untraced sweep in which no operation runs on the device:
100 (1 - busy / sweep), busy the union of the device intervals a traced
sweep (device time, which the profiler hardly moves), sweep the mean time of
a sweep of the measured window (the profiler slows the host, so the traced
sweeps' own wall time would read the idle share high)."""


def read(ctx):
    if ctx["sweep_s"] <= 0 or not ctx["device_spans"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["sweeps"] / ctx["sweep_s"])
