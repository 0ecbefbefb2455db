"""The smoothers' prefix and suffix scans: three CUDA kernels, each walked in
one pass or folded into time chunks, and their plain PyTorch versions
(counterpart of pyvbmp_tpu/ops/chunked_scan.py:auto_scan and the Pallas
kernels pyvbmp_tpu/ops/pallas_scan.py:_build_call and _build_folded_call).

All three are inclusive scans over axis 0 of an associative combine with no
identity element, in chain order:

    forward: out[t] = e[0] o e[1] o ... o e[t]
    reverse: out[t] = e[t] o e[t+1] o ... o e[T-1]

- ``logsemiring_scan(M)``: M is (T, K, K, N), the combine is
  ``parallel_hmm._logmatmul_plane`` (the role chain);
- ``kalman_plane_scan((Jaa, Jab, Jbb, ha, hb, logw))``: Gaussian pair
  potentials in plane layout, the combine is
  ``parallel_kalman._combine_plane`` (the latent chain, h > 3);
- ``kalman_lane_scan((Jaa, Jab, Jbb, ha, hb, logw))``: the same potentials
  packed by components (``ops/smallmat.py``), the combine is
  ``parallel_kalman._combine_lane`` (the latent chain, h <= 3).

Time fold (pyvbmp_tpu/ops/pallas_scan.py:80-101, 477-585): with
``TIME_FOLD`` = "auto" a scan of T >= ``TIME_FOLD_MIN_T`` rows over
N <= ``TIME_FOLD_MAX_N`` lanes is cut into Cp = ``_time_fold_cp(T, N)``
chunks of L = ceil(T / Cp) rows and run as a three-phase block scan: (1) the
in-chunk scans, the chunks as a batch axis; (2) an exclusive scan of the
chunk totals; (3) one combine of each chunk's carry-in with each of its
rows.  "1" folds every scan that can be cut into chunks of >= 2 rows, "0"
(the default, as in the JAX package) none.  A lane scan folds only under
"1": the JAX package's automatic dispatch never sends a lane-layout scan at
small N to the Pallas kernel.  The switch and thresholds are read from the
JAX package's environment variables once, into module attributes that a
caller (or a test) may set.

Dispatch is by the device of the input: a CPU tensor goes through the plain
version (a sequential fold of the combine; folded, the three phases above in
torch ops, with the JAX package's duplicate-edge padding), a CUDA tensor
launches the kernel and raises on anything the kernel does not take.  There
is no fallback from one to the other.  A folded kernel launch runs two CUDA
kernels: phase 1, then phases 2-3 fused; it counts once, on the scan's
``folded`` counter.

The kernels are built and loaded by ``ops/_cuda.py``.
"""
from __future__ import annotations

import os

import torch

from ._cuda import load_library

# The sizes the kernels take: every K a C int holds (csrc/logsemiring_scan.cu
# has a generic path above 32), and the JAX package's plane Kalman range
# (parallel_kalman.py:PLANE_KALMAN_MAX_H).
LOGSEMIRING_SIZES = range(1, 2**31)
PLANE_MAX_H = 32

TIME_FOLD = os.environ.get("PYVBMP_PALLAS_TIME_FOLD", "0")
TIME_FOLD_MAX_N = int(os.environ.get("PYVBMP_PALLAS_TIME_FOLD_MAX_N", "256"))
TIME_FOLD_MIN_T = int(os.environ.get("PYVBMP_PALLAS_TIME_FOLD_MIN_T", "96"))
TIME_FOLD_CP = int(os.environ.get("PYVBMP_PALLAS_TIME_FOLD_CP", "8"))


def _time_fold_cp(T, N):
    """Number of chunks for the folded scan: more chunks shorten the serial
    walk (L = ceil(T/Cp)) but add phase-2/3 work; keep L >= 16."""
    cp = TIME_FOLD_CP
    while cp > 2 and (T + cp - 1) // cp < 16:
        cp //= 2
    return max(cp, 1)


def _time_fold_ok(leaves, T, N):
    """The JAX package's fold decision (``leaves`` is unused, as there)."""
    if TIME_FOLD == "0":
        return False
    if T < TIME_FOLD_MIN_T or N > TIME_FOLD_MAX_N:
        return TIME_FOLD == "1"
    return _time_fold_cp(T, N) >= 2


def fold_shape(T, N):
    """(Cp, L) of the time fold of T rows, or None where it cannot be cut
    into Cp >= 2 non-empty chunks of L >= 2 rows (the JAX package then runs
    the scan unfolded)."""
    Cp = _time_fold_cp(T, N)
    L = -(-T // Cp)
    if Cp < 2 or L < 2 or Cp * L - T >= L:
        return None
    return Cp, L


def fold_args(T, N, reverse):
    """The folded kernels' launch arguments (``Scan.launch``): chunks, L and
    offset, chunk c holding rows [c L + offset, (c + 1) L + offset) clipped
    to [0, T).  In reverse the chunks sit C L - T rows to the left, so the
    one short chunk is the last in chain order, whose total no other chunk
    needs."""
    Cp, L = fold_shape(T, N)
    return dict(chunks=Cp, L=L, offset=T - Cp * L if reverse else 0)


def _logmatmul_plane(a, b):
    from .parallel_hmm import _logmatmul_plane as combine

    return combine(a, b)


def _combine_plane(e1, e2):
    from .parallel_kalman import _combine_plane as combine

    return combine(e1, e2)


def _combine_lane(e1, e2):
    from .parallel_kalman import _combine_lane as combine

    return combine(e1[3].shape[-2], e1, e2)


def _fold(combine, leaves, reverse):
    """Sequential inclusive scan over axis 0 in chain order; the combine
    broadcasts over any axes between time and the leaf's own."""
    T = leaves[0].shape[0]
    out = [torch.empty_like(x) for x in leaves]
    carry = None
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        e = tuple(x[t] for x in leaves)
        if carry is None:
            carry = e
        elif reverse:
            carry = combine(e, carry)
        else:
            carry = combine(carry, e)
        for o, c in zip(out, carry):
            o[t] = c
    return out


class Scan:
    """One scan: its kernel, its plain version and their counts, and its
    time-folded route (``folded``, with counts of its own).

    ``launches`` counts one-pass kernel launches and nothing else;
    ``plain_calls`` counts runs of the one-pass plain version."""

    def __init__(self, name, symbol, source, replaces, sizes, combine,
                 leaf_shapes, size_of, fold_auto=True):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.sizes = sizes  # the K or H the kernel takes (a range)
        self.combine = combine
        self.leaf_shapes = leaf_shapes  # (T, size, N) -> shape of each leaf
        self.size_of = size_of  # leaves -> K or H
        self.fold_auto = fold_auto  # whether TIME_FOLD="auto" may fold it
        self.launches = 0
        self.plain_calls = 0
        self.folded = FoldedScan(self)

    def fold_plan(self, T, N):
        """(Cp, L) when the time-fold switch folds this scan, else None."""
        if TIME_FOLD == "auto" and not self.fold_auto:
            return None
        if not _time_fold_ok(None, T, N):
            return None
        return fold_shape(T, N)

    def __call__(self, leaves, reverse=False):
        folded = self.fold_plan(leaves[0].shape[0], leaves[0].shape[-1]) is not None
        route = self.folded if folded else self
        device = leaves[0].device
        if device.type == "cpu":
            return route.plain(leaves, reverse)
        if device.type == "cuda":
            return route.kernel(leaves, reverse)
        raise ValueError(f"{route.name}: no version for device {device}")

    def plain(self, leaves, reverse=False):
        """Sequential left fold in the kernel's association order."""
        self.plain_calls += 1
        return _fold(self.combine, leaves, reverse)

    def check(self, leaves):
        """(T, size, N) of leaves the kernel takes; raises on any other."""
        T, N = leaves[0].shape[0], leaves[0].shape[-1]
        size = self.size_of(leaves)
        if size not in self.sizes:
            raise ValueError(
                f"{self.name}: size {size} is outside the kernel's range "
                f"{self.sizes.start}..{self.sizes.stop - 1}"
            )
        want = self.leaf_shapes(T, size, N)
        if len(leaves) != len(want):
            raise ValueError(f"{self.name}: want {len(want)} leaves, got {len(leaves)}")
        device = leaves[0].device
        for x, shape in zip(leaves, want):
            if x.device != device or x.dtype != torch.float32:
                raise TypeError(f"{self.name}: leaves must be float32 on {device}")
            if tuple(x.shape) != shape or not x.is_contiguous():
                raise ValueError(
                    f"{self.name}: want contiguous {shape}, got {tuple(x.shape)}"
                )
        if T < 1 or N < 1:
            raise ValueError(f"{self.name}: empty scan (T={T}, N={N})")
        return T, size, N

    def launch(self, leaves, reverse, chunks=1, L=None, offset=0):
        """Run the kernel over checked leaves: one pass (chunks=1) or folded
        into ``chunks`` chunks of L rows whose first row is c L + offset."""
        T, size, N = self.check(leaves)
        lib = load_library()
        out = [torch.empty_like(x) for x in leaves]
        totals = [x.new_empty((chunks,) + x.shape[1:]) if chunks > 1 else None
                  for x in leaves]
        device = leaves[0].device
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, self.symbol)(
                *(x.data_ptr() for x in leaves), *(o.data_ptr() for o in out),
                *(None if t is None else t.data_ptr() for t in totals),
                T, size, N, chunks, T if L is None else L, offset,
                int(bool(reverse)), stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        return out

    def kernel(self, leaves, reverse=False):
        out = self.launch(leaves, reverse)
        self.launches += 1
        return out


class FoldedScan:
    """The time-folded route of a ``Scan`` (the counterpart of
    pallas_scan.py:_time_folded_scan, whose phase 1 is the Pallas kernel
    _build_folded_call): the folded kernel, its plain version and their
    counts."""

    replaces = "pyvbmp_tpu/ops/pallas_scan.py:351"

    def __init__(self, scan):
        self.scan = scan
        self.name = scan.name + "_folded"
        self.source = scan.source
        self.launches = 0
        self.plain_calls = 0

    def shape(self, leaves):
        T, N = leaves[0].shape[0], leaves[0].shape[-1]
        plan = fold_shape(T, N)
        if plan is None:
            raise ValueError(f"{self.name}: T={T} cannot be folded into chunks")
        return plan

    def plain(self, leaves, reverse=False):
        """The three phases in torch ops, as _time_folded_scan runs them.
        Time is padded to Cp L rows with copies of the edge element (the
        last row forward; the first row in reverse, where the JAX package
        flips the scan), which no output row depends on."""
        self.plain_calls += 1
        combine = self.scan.combine
        T = leaves[0].shape[0]
        Cp, L = self.shape(leaves)
        pad = Cp * L - T

        def padded(x):
            fill = (x[:1] if reverse else x[-1:]).expand((pad,) + x.shape[1:])
            return torch.cat([fill, x] if reverse else [x, fill], 0)

        # phase 1: the in-chunk scans, time leading, the chunks a batch axis
        local = _fold(
            combine,
            [padded(x).reshape((Cp, L) + x.shape[1:]).transpose(0, 1) for x in leaves],
            reverse,
        )
        # phase 2: inclusive scan of the chunk totals; chunk c's carry-in is
        # entry c - 1 of it (c + 1 in reverse)
        incl = _fold(combine, [x[0 if reverse else -1] for x in local], reverse)
        # phase 3: each chunk's carry-in with every row of the chunk
        for c in range(Cp):
            if c == (Cp - 1 if reverse else 0):
                continue  # the first chunk in chain order has no carry-in
            carry = tuple(x[c + 1 if reverse else c - 1] for x in incl)
            rows = tuple(x[:, c] for x in local)
            res = combine(rows, carry) if reverse else combine(carry, rows)
            for x, r in zip(local, res):
                x[:, c] = r
        out = [x.transpose(0, 1).reshape((Cp * L,) + x.shape[2:]) for x in local]
        return [x[pad:] if reverse else x[:T] for x in out]

    def kernel(self, leaves, reverse=False):
        self.shape(leaves)  # raises where T cannot be folded
        out = self.scan.launch(leaves, reverse,
                               **fold_args(leaves[0].shape[0], leaves[0].shape[-1], reverse))
        self.launches += 1
        return out


LOGSEMIRING = Scan(
    "logsemiring_scan",
    "logsemiring_scan_f32",
    "pyvbmp_tpu_torch/csrc/logsemiring_scan.cu",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=LOGSEMIRING_SIZES,
    combine=lambda a, b: (_logmatmul_plane(a[0], b[0]),),
    leaf_shapes=lambda T, K, N: [(T, K, K, N)],
    size_of=lambda leaves: leaves[0].shape[1],
)
KALMAN_PLANE = Scan(
    "kalman_plane_scan",
    "kalman_plane_scan_f32",
    "pyvbmp_tpu_torch/csrc/kalman_plane_scan.cuh",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=range(1, PLANE_MAX_H + 1),
    combine=_combine_plane,
    leaf_shapes=lambda T, H, N: [(T, H, H, N)] * 3 + [(T, H, N)] * 2 + [(T, N)],
    size_of=lambda leaves: leaves[0].shape[1],
)
KALMAN_LANE = Scan(
    "kalman_lane_scan",
    "kalman_lane_scan_f32",
    "pyvbmp_tpu_torch/csrc/kalman_lane_scan.cu",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=range(1, 4),
    combine=_combine_lane,
    leaf_shapes=lambda T, H, N: (
        [(T, H * (H + 1) // 2, N), (T, H * H, N), (T, H * (H + 1) // 2, N)]
        + [(T, H, N)] * 2 + [(T, N)]
    ),
    size_of=lambda leaves: leaves[3].shape[1] if len(leaves) > 3 else None,
    fold_auto=False,
)
SCANS = (LOGSEMIRING, KALMAN_PLANE, KALMAN_LANE)
FOLDED_SCANS = tuple(s.folded for s in SCANS)


def logsemiring_scan(M, reverse=False):
    """Inclusive (log,+) matrix scan of M (T, K, K, N) in chain order."""
    return LOGSEMIRING((M,), reverse)[0]


def kalman_plane_scan(elems, reverse=False):
    """Inclusive scan of Gaussian pair potentials (Jaa, Jab, Jbb, ha, hb,
    logw) in plane layout, chain order."""
    return tuple(KALMAN_PLANE(tuple(elems), reverse))


def kalman_lane_scan(elems, reverse=False):
    """Inclusive scan of Gaussian pair potentials (Jaa, Jab, Jbb, ha, hb,
    logw) packed by components (ops/smallmat.py), chain order."""
    return tuple(KALMAN_LANE(tuple(elems), reverse))


def plain_logsemiring_scan(M, reverse=False):
    return LOGSEMIRING.plain((M,), reverse)[0]


def plain_kalman_plane_scan(elems, reverse=False):
    return tuple(KALMAN_PLANE.plain(tuple(elems), reverse))
