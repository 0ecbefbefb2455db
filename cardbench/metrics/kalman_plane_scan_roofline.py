"""Share of its roofline of the latent chain's plane Kalman scan pair."""
from cardbench.metrics._scan_roofline import read as _read


def read(ctx):
    return _read(ctx, "kalman_plane_scan")
