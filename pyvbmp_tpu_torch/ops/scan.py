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

Time fold (pyvbmp_tpu/ops/pallas_scan.py:80-101, 477-585): a scan cut into
Cp chunks of L = ceil(T / Cp) rows runs as a three-phase block scan: (1)
the in-chunk scans, the chunks as a batch axis; (2) an exclusive scan of
the chunk totals; (3) one combine of each chunk's carry-in with each of its
rows.  Which scans fold is set by ``TIME_FOLD``, read once from the JAX
package's ``PYVBMP_PALLAS_TIME_FOLD``:

- "0" (the default): the card's plan.  A plane Kalman scan on a CUDA
  tensor folds where ``plane_plan(T, H, N, sms)`` plans it: at the rungs
  where one lane's combine fills a block, on lanes that leave more than
  half of the card's SMs idle, into as many chunks as the card and the
  chain's length call for.  Every other scan, and every scan on a CPU
  tensor, runs one pass.
- "auto": the JAX package's plan.  A scan of T >= ``TIME_FOLD_MIN_T``
  rows over N <= ``TIME_FOLD_MAX_N`` lanes is cut into Cp =
  ``_time_fold_cp(T, N)`` chunks, on either device.  A lane scan does not
  fold: the JAX package's automatic dispatch never sends a lane-layout
  scan at small N to the Pallas kernel.
- "1": the JAX package's plan for every scan that can be cut into chunks
  of >= 2 rows, the lane scan too.

The switch and the thresholds are module attributes that a caller (or a
test) may set.  ``Scan.launch(..., chunks=1)`` runs one pass whatever the
switch says.

Dispatch is by the device of the input: a CPU tensor goes through the plain
version (a sequential fold of the combine; folded, the three phases above in
torch ops, with the JAX package's duplicate-edge padding), a CUDA tensor
launches the kernel and raises on anything the kernel does not take.  There
is no fallback from one to the other.  A folded kernel launch runs two CUDA
kernels: phase 1, then phases 2-3 fused; it counts once, on the scan's
``folded`` counter, under the span ``scan.<name>_folded`` with the chunk
count as its args (``{"chunks": Cp}``).

The kernels are built and loaded by ``ops/_cuda.py``.

The smoothers take the steps that cross their time axis (the scans, the
shifts by one step, the first and last rows, the sums over time, and the
gathering of their outputs) from a ``Chain``: ``CHAIN``, the time axis held
whole by this process, by default, and a time axis cut across processes
from ``parallel/seq_parallel.py``.
"""
from __future__ import annotations

import functools
import math
import os

import torch

from ..utils.trace import span
from ._cuda import load_library

# The sizes the kernels take: every K a C int holds (csrc/logsemiring_scan.cu
# has a generic path above 32), and the JAX package's plane Kalman range
# (parallel_kalman.py:PLANE_KALMAN_MAX_H).
LOGSEMIRING_SIZES = range(1, 2**31)
PLANE_MAX_H = 32

TIME_FOLD = os.environ.get("PYVBMP_PALLAS_TIME_FOLD", "0")
TIME_FOLD_MAX_N = 256
TIME_FOLD_MIN_T = 96
TIME_FOLD_CP = 8

# The plane Kalman kernel's rungs (csrc/kalman_plane_scan.cu): potentials of
# size h run at the first rung >= h.
PLANE_RUNGS = (4, 6, 8, 10, 12, 14, 16, 24, 32)
# plane_plan's shortest chunk: the fastest of a card sweep at T = 64 (PERF.md
# section 6).
PLANE_FOLD_MIN_L = 8


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


def plane_rung(h):
    """The rung the plane Kalman kernel runs potentials of size h at (None
    past the widest, a size the kernel refuses)."""
    return next((H for H in PLANE_RUNGS if H >= h), None)


def plane_plan(T, H, N, sms):
    """(Cp, L) of the card's time fold of a plane Kalman scan of T rows of
    size H over N lanes on a card of ``sms`` SMs, or None for one pass.

    It folds only where one lane's combine fills a block (its rung's 2 H + 1
    right-hand sides outnumber a warp's threads, from rung 16 on:
    csrc/kalman_plane_scan.cuh:kLanes) and the N lane blocks leave more
    than half of the SMs idle, into

        Cp = min(sms // N, T // PLANE_FOLD_MIN_L, isqrt(5 T / 4))

    chunks, then the fewest chunks of L = ceil(T / Cp) rows that hold T, so
    that every chunk is non-empty (fold_shape's rule).  sms // N keeps the
    fix-up's N Cp blocks in one wave (one a SM at rung 32).  The cap
    balances the two serial walks: the last chunk's in-chunk scan of L rows,
    then its fix-up, which folds the Cp - 2 totals before it in series and
    combines the carry-in with L / 4 rows a warp; L + Cp + L / 4 is least
    at Cp = sqrt(5 T / 4)."""
    rung = plane_rung(H)
    if rung is None or 2 * rung + 1 <= 32 or 2 * N >= sms:
        return None
    Cp = min(sms // N, T // PLANE_FOLD_MIN_L, math.isqrt(5 * T // 4))
    if Cp < 2:
        return None
    L = -(-T // Cp)
    return -(-T // L), L


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    """The SM count of CUDA device ``index`` (None: the current one), read
    once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def fold_args(T, N, reverse, plan=None):
    """The folded kernels' launch arguments (``Scan.launch``) for the plan
    (Cp, L), ``fold_shape(T, N)`` where None: chunks, L and offset, chunk c
    holding rows [c L + offset, (c + 1) L + offset) clipped to [0, T).  In
    reverse the chunks sit C L - T rows to the left, so the one short chunk
    is the last in chain order, whose total no other chunk needs."""
    Cp, L = fold_shape(T, N) if plan is None else plan
    if Cp < 2 or L < 1 or not 0 <= Cp * L - T < L:
        raise ValueError(f"no fold of T={T} into {Cp} non-empty chunks of {L} rows")
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
                 leaf_shapes, size_of, fold_auto=True, card_plan=None):
        self.name = name
        self.span_name = "scan." + name  # the span its calls open (utils/trace.py)
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.sizes = sizes  # the K or H the kernel takes (a range)
        self.combine = combine
        self.leaf_shapes = leaf_shapes  # (T, size, N) -> shape of each leaf
        self.size_of = size_of  # leaves -> K or H
        self.fold_auto = fold_auto  # whether TIME_FOLD="auto" may fold it
        self.card_plan = card_plan  # (T, size, N, sms) -> plan under TIME_FOLD="0"
        self.launches = 0
        self.plain_calls = 0
        self.folded = FoldedScan(self)

    def fold_plan(self, T, N, size=None, device=None):
        """(Cp, L) when the time-fold switch folds this scan of T rows of
        ``size`` over N lanes on ``device``, else None.  Under "0" only a
        scan with a ``card_plan`` folds, and only on a CUDA device."""
        if TIME_FOLD == "0":
            if self.card_plan is None or device is None or device.type != "cuda":
                return None
            return self.card_plan(T, size, N, _sm_count(device.index))
        if TIME_FOLD == "auto" and not self.fold_auto:
            return None
        if not _time_fold_ok(None, T, N):
            return None
        return fold_shape(T, N)

    def __call__(self, leaves, reverse=False):
        device = leaves[0].device
        plan = self.fold_plan(leaves[0].shape[0], leaves[0].shape[-1], self.size_of(leaves),
                              device)
        if plan is None:
            route, how, args = self, {}, None
        else:
            route, how, args = self.folded, {"plan": plan}, {"chunks": plan[0]}
        with span(route.span_name, args):
            if device.type == "cpu":
                return route.plain(leaves, reverse, **how)
            if device.type == "cuda":
                return route.kernel(leaves, reverse, **how)
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
        self.span_name = "scan." + self.name
        self.source = scan.source
        self.launches = 0
        self.plain_calls = 0

    def shape(self, leaves, plan=None):
        """The plan (Cp, L), the JAX package's ``fold_shape`` where None;
        raises where it does not cut T rows into non-empty chunks."""
        T, N = leaves[0].shape[0], leaves[0].shape[-1]
        if plan is None:
            plan = fold_shape(T, N)
            if plan is None:
                raise ValueError(f"{self.name}: T={T} cannot be folded into chunks")
        fold_args(T, N, False, plan)  # raises on a plan with an empty chunk
        return plan

    def plain(self, leaves, reverse=False, plan=None):
        """The three phases in torch ops, as _time_folded_scan runs them.
        Time is padded to Cp L rows with copies of the edge element (the
        last row forward; the first row in reverse, where the JAX package
        flips the scan), which no output row depends on."""
        self.plain_calls += 1
        combine = self.scan.combine
        T = leaves[0].shape[0]
        Cp, L = self.shape(leaves, plan)
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

    def kernel(self, leaves, reverse=False, plan=None):
        T, N = leaves[0].shape[0], leaves[0].shape[-1]
        plan = self.shape(leaves, plan)  # raises where T cannot be folded
        out = self.scan.launch(leaves, reverse, **fold_args(T, N, reverse, plan))
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
    card_plan=plane_plan,
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


class Chain:
    """The smoothers' steps across the time axis, with the whole axis in
    this process.  ``parallel.seq_parallel.ShardedChain`` holds the same
    steps for a time axis cut across the ranks of a mesh: there the
    smoothers' inputs and outputs are this process's rows, and their sums
    over time this process's part, for the caller to complete.  Every
    method that takes tensors ``*xs`` returns a tuple.  ``holds_first``
    and ``holds_last`` say whether this process holds the chain's first
    and last rows."""

    holds_first = holds_last = True

    def scan(self, s, leaves, reverse=False):
        """Inclusive scan of ``leaves`` by ``s`` (a ``Scan``, or any
        callable (leaves, reverse) with a ``combine``)."""
        return tuple(s(tuple(leaves), reverse))

    def shift(self, xs, up, edge=None):
        """x[t] <- x[t + 1] (``up``) or x[t - 1], the row that falls off the
        end replaced by ``edge`` (a tuple of rows; zeros where None)."""
        if edge is None:
            edge = tuple(torch.zeros_like(x[:1]) for x in xs)
        else:
            edge = tuple(e[None] for e in edge)
        if up:
            return tuple(torch.cat([x[1:], e], 0) for x, e in zip(xs, edge))
        return tuple(torch.cat([e, x[:-1]], 0) for x, e in zip(xs, edge))

    def first(self, *xs):
        """The chain's row 0 of each of ``xs``, as a leading axis of one
        row where this process holds it and of none where it does not.  A
        value computed from these rows goes through ``held``."""
        return tuple(x[:1] for x in xs)

    def last(self, *xs):
        """The chain's last row, as ``first`` gives row 0."""
        return tuple(x[-1:] for x in xs)

    @staticmethod
    def held(x):
        """A value computed on the rows of ``first`` or ``last`` (its
        leading axis theirs): the value, or zeros where this process
        holds no such row."""
        return x[0] if x.shape[0] else x.new_zeros(x.shape[1:])


CHAIN = Chain()


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
