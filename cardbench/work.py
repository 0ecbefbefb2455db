"""The benchmark's yardstick for the device: peaks of one H100, the work a
scan must do whatever implements it, and the reduction of a profiler
trace to busy time and kernel groups.  Frozen with the benchmark, so that
a change to the program cannot move what its kernels are measured
against."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_FLOP_PER_S = 67e12  # dense FP32 outside the tensor cores, at 700 W

# kernel groups by name: the port's scan kernels, each with its fix-up
# and folded kernels; every other device kernel is the sweep's tensor algebra
SCAN_GROUPS = {
    "logsemiring_scan": ("logsemiring",),
    "kalman_plane_scan": ("kalman_plane",),
    "kalman_lane_scan": ("kalman_lane",),
    "weighted_outer": ("weighted_outer",),
}


def bound_ms(nbytes, flops):
    """(least time in ms, what bounds it) for a function that must move
    ``nbytes`` and do ``flops`` FP32 operations on one H100."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def scan_work(name, T, size, N):
    """(bytes, FP32 operations) of one inclusive scan of T elements on N
    lanes: each element read once and each prefix written once, and one
    combine per row after the first.  logsemiring: K^3 adds, exps and sums;
    plane Kalman: Cholesky (2/3 H^3), 2H+1 solves ((2H+1) H^2), A'A, B'B,
    A'B (6 H^3) and A'c, B'c, c'c; lane Kalman: the same on h <= 3."""
    if name.startswith("logsemiring"):
        floats, ops = size * size, 3 * size ** 3
    else:
        H = size
        packed = name.startswith("kalman_lane")
        floats = (H * (H + 1) + H * H if packed else 3 * H * H) + 2 * H + 1
        ops = 2 * H ** 3 / 3 + (2 * H + 1) * H * H + 6 * H ** 3 + 4 * H * H + 2 * H
    return 2 * 4 * T * N * floats, (T - 1) * N * ops


def group_of(kernel_name):
    """The scan group a device kernel belongs to, or None for the rest."""
    for group, keys in SCAN_GROUPS.items():
        if any(k in kernel_name for k in keys):
            return group
    return None


def union_seconds(spans):
    """Seconds covered by the union of (start_s, end_s) intervals."""
    busy, hi = 0.0, None
    lo = None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    if hi is not None:
        busy += hi - lo
    return busy


def idle_gaps(spans, start, end):
    """The (start_s, end_s) intervals of [start, end] that no span covers."""
    gaps, cur = [], start
    for a, b in sorted(spans):
        if a > cur:
            gaps.append((cur, min(a, end)))
        cur = max(cur, b)
        if cur >= end:
            break
    if cur < end:
        gaps.append((cur, end))
    return [(a, b) for a, b in gaps if b > a]
