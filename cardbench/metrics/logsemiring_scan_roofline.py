"""Share of its roofline of the role chain's log-semiring scan pair."""
from cardbench.metrics._scan_roofline import read as _read


def read(ctx):
    return _read(ctx, "logsemiring_scan")
