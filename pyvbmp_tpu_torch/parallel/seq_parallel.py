"""Sequence (time-axis) parallelism on ``torch.distributed`` (counterpart of
pyvbmp_tpu/parallel/seq_parallel.py).

The scan smoothers compose per-time elements with an associative combine,
so the time axis can be cut across the ranks of a mesh axis: each rank
scans its own chunk, the D chunk totals are all_gathered (one row each),
every rank folds the totals of its predecessors into a carry-in and
combines it with each of its rows.  That is the three-phase block scan of
the time fold (``ops/scan.py:FoldedScan``) with the chunks on different
ranks.  The steps by one row across a chunk edge (the backward message
shift, alpha_{t-1} for the pairwise statistics) are halo rows, the first
and last rows of the chain (SEz0 and the x_{-1} marginal; logZ) come from
the ranks that hold them, and the sums over time are all_reduced.  Per
call that is O(D) elements, whatever T; only the gathering of the
time-leading outputs grows with T.

Chunks follow ``torch.tensor_split``: rank d of the time axis holds rows
[start_d, end_d), the lengths differing by at most one, so any T works
without padding.  Where T < D the last ranks hold no rows: their totals and
halo rows are skipped by a flag gathered beside them, which the host reads.

The smoothers themselves are the single-process ones
(``ops.parallel_hmm``, ``ops.parallel_kalman``) given a ``ShardedChain``:
the local scans go through the same dispatch (the CUDA kernels on the card,
each rank on its own chunk); the carry-in combine is the plain torch
combine batched over the rows.

Every rank passes the whole, replicated inputs and gets back the whole
outputs with the JAX package's shapes: the time-leading outputs gathered
over the time axis (tag ``"gather"``), the reductions replicated.  On a 2-D
(seq x data) mesh ``batch_axis`` ("auto": the first non-time axis) also
splits the batch (axis 1 of the time-leading inputs); the outputs are
gathered over it too.
"""
from __future__ import annotations

import math
import warnings

import torch

from ..ops import scan
from .api import _check_mesh, data_parallel_axis, shard_batch


def _bounds(T, D, d):
    """Rows [start, end) of chunk d of T rows cut into D (tensor_split)."""
    q, rem = divmod(T, D)
    start = d * q + min(d, rem)
    return start, start + q + (1 if d < rem else 0)


def _flat(rows):
    """The tensors ``rows`` as one flat buffer in their common dtype."""
    dtype = rows[0].dtype
    for r in rows[1:]:
        dtype = torch.promote_types(dtype, r.dtype)
    return torch.cat([r.reshape(-1).to(dtype) for r in rows])


def _unflat(buf, like):
    out, i = [], 0
    for r in like:
        out.append(buf[i: i + r.numel()].reshape(r.shape).to(r.dtype))
        i += r.numel()
    return tuple(out)


def _gather_rows(mesh, axis, rows, valid, tag):
    """One all_gather of a flag and the rows ``rows`` of every rank of the
    line: (each rank's rows, in mesh order; each rank's flag)."""
    buf = _flat((rows[0].new_ones(1),) + tuple(rows))
    buf[0] = float(valid)
    got = mesh.all_gather(buf, axis, tag)
    flags = torch.stack([g[0] for g in got]).tolist()  # the host reads the flags
    return [_unflat(g[1:], rows) for g in got], [f > 0.5 for f in flags]


def _scan_parts(fn, single):
    """(local scan (leaves, reverse), combine on tuples) for a scan of
    ``ops.scan`` (anything with a ``combine``) or a bare combine."""
    if hasattr(fn, "combine"):
        return fn, fn.combine
    combine = (lambda a, b: (fn(a[0], b[0]),)) if single else fn
    return (lambda leaves, reverse: scan._fold(combine, list(leaves), reverse)), combine


def sharded_associative_scan(fn, elems, mesh, axis, reverse=False):
    """The inclusive scan of ``elems`` (a tensor or tuple of tensors, time
    leading) by ``fn`` over a time axis cut across ``axis`` of ``mesh``:
    ``elems`` are this rank's rows, the result this rank's rows of the
    whole scan.  ``fn`` is a scan of ``ops.scan`` (the kernel's dispatch
    runs the local scan, its ``combine`` the rest) or a bare associative
    combine (the local scan a sequential fold of it); it needs no identity.
    ``reverse`` gives the suffix scan in chain order."""
    single = isinstance(elems, torch.Tensor)
    elems = (elems,) if single else tuple(elems)
    run, combine = _scan_parts(fn, single)
    n = elems[0].shape[0]
    local = tuple(run(elems, reverse)) if n else elems
    D = mesh.shape[axis]
    if D == 1:
        return local[0] if single else local
    # this chunk's total is its last row in chain order
    total = (tuple(x[0 if reverse else -1] for x in local) if n
             else tuple(x.new_zeros(x.shape[1:]) for x in local))
    totals, valid = _gather_rows(mesh, axis, total, n > 0, "scan")
    d = mesh.coords[axis]
    carry = None
    for j in (range(d + 1, D) if reverse else range(d)):  # chain order
        if valid[j]:
            carry = totals[j] if carry is None else combine(carry, totals[j])
    out = local
    if carry is not None and n:
        rows = tuple(c.expand((n,) + tuple(c.shape)) for c in carry)
        out = tuple(combine(local, rows) if reverse else combine(rows, local))
    return out[0] if single else out


def _shift(mesh, axis, xs, up, edge):
    """x[t] <- x[t + 1] (``up``) or x[t - 1] across the cut time axis; the
    row that falls off the chain's end is ``edge``."""
    n = xs[0].shape[0]
    rows = (tuple(x[0 if up else -1] for x in xs) if n
            else tuple(x.new_zeros(x.shape[1:]) for x in xs))
    got, valid = _gather_rows(mesh, axis, rows, n > 0, "halo")
    d, D = mesh.coords[axis], mesh.shape[axis]
    near = range(d + 1, D) if up else range(d - 1, -1, -1)
    halo = next((got[j] for j in near if valid[j]), edge)
    if not n:
        return xs
    if up:
        return tuple(torch.cat([x[1:], h[None].to(x.dtype)], 0) for x, h in zip(xs, halo))
    return tuple(torch.cat([h[None].to(x.dtype), x[:-1]], 0) for x, h in zip(xs, halo))


def shift_up(x, mesh, axis, fill=0.0):
    """x[t] <- x[t + 1] across the time axis cut over ``axis`` (``fill`` at
    the chain's end): this rank's rows shifted, the halo row from the next
    rank that holds rows.  ``x`` is a tensor or a tuple of them."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    edge = tuple(a.new_full(a.shape[1:], fill) for a in xs)
    out = _shift(mesh, axis, xs, True, edge)
    return out[0] if single else out


def shift_down(x, mesh, axis, first_row):
    """x[t] <- x[t - 1] across the time axis cut over ``axis``; the chain's
    row 0 becomes ``first_row`` (one time row, or a tuple of them)."""
    single = isinstance(x, torch.Tensor)
    xs = (x,) if single else tuple(x)
    frs = (first_row,) if single else tuple(first_row)
    edge = tuple(fr if fr.ndim == a.ndim - 1 else fr[0] for a, fr in zip(xs, frs))
    out = _shift(mesh, axis, xs, False, edge)
    return out[0] if single else out


class ShardedChain(scan.Chain):
    """The smoothers' steps across a time axis of T rows cut over ``axis``
    of ``mesh`` (``ops.scan.Chain``), the batch (axis 1 of the time-leading
    inputs, ``batch_size`` wide) also split over ``batch_axis`` unless it is
    None."""

    def __init__(self, mesh, axis, T, batch_axis=None, batch_size=None):
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.rank} is not in {mesh!r}")
        self.mesh, self.axis, self.T = mesh, axis, T
        self.D = mesh.shape[axis]
        self.bounds = [_bounds(T, self.D, d) for d in range(self.D)]
        self.start, self.end = self.bounds[mesh.coords[axis]]
        self.batch_axis, self.batch_size = batch_axis, batch_size

    def local(self, x):
        x = x[self.start: self.end]
        if self.batch_axis is not None and x.ndim > 1 and x.shape[1] == self.batch_size:
            x = shard_batch(self.mesh, x, 1, self.batch_axis)
        return x

    def scan(self, s, leaves, reverse=False):
        return sharded_associative_scan(s, tuple(leaves), self.mesh, self.axis, reverse)

    def shift(self, xs, up, edge=None):
        if edge is None:
            edge = tuple(x.new_zeros(x.shape[1:]) for x in xs)
        return _shift(self.mesh, self.axis, tuple(xs), up, tuple(edge))

    def _row(self, xs, src, at):
        """Row ``at`` of the ``xs`` held by time coordinate ``src``, on
        every rank of the line: one broadcast."""
        rows = tuple(x[at] if x.shape[0] else x.new_zeros(x.shape[1:]) for x in xs)
        return _unflat(self.mesh.broadcast(_flat(rows), self.axis, src, "reduce"), rows)

    def first(self, *xs):
        return self._row(xs, 0, 0)

    def last(self, *xs):
        return self._row(xs, min(self.T, self.D) - 1, -1)

    def reduce(self, *xs):
        return self.mesh.all_reduce_many(xs, self.axis, "reduce")

    def gather(self, *xs, time=True):
        if time and self.D > 1:
            xs = self._gather_time(xs)
        if self.batch_axis is not None:
            dim = 1 if time else 0
            xs = tuple(torch.cat(self.mesh.all_gather(x, self.batch_axis, "gather"), dim)
                       if x.ndim > dim else x for x in xs)
        return xs

    def _gather_time(self, xs):
        """The time-leading ``xs`` over all T rows: each rank's rows padded
        to ceil(T / D), one all_gather of them side by side."""
        L = -(-self.T // self.D)
        n = xs[0].shape[0]
        cols = _flat_cols(xs)
        buf = torch.cat([cols, cols.new_zeros((L - n,) + tuple(cols.shape[1:]))], 0)
        got = self.mesh.all_gather(buf, self.axis, "gather")
        full = torch.cat([g[: e - s] for g, (s, e) in zip(got, self.bounds)], 0)
        out, i = [], 0
        for x in xs:
            w = math.prod(x.shape[1:])
            out.append(full[:, i: i + w].reshape((self.T,) + tuple(x.shape[1:])).to(x.dtype))
            i += w
        return tuple(out)


def _flat_cols(xs):
    """Time-leading tensors side by side as (rows, columns) in their common
    dtype."""
    n = xs[0].shape[0]
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.cat([x.reshape(n, math.prod(x.shape[1:])).to(dtype) for x in xs], 1)


def _resolve_axes(mesh, time_axis, batch_axis, T, batch_size):
    """The batch axis of the mesh to split, or None.  ``batch_axis="auto"``
    picks the first non-time axis when there is one and the batch divides
    its size, and otherwise warns and runs seq-only; a named axis raises on
    indivisibility.  "auto" never splits a batch that
    ``data_parallel_update`` has split over that axis already.  Uneven time
    chunks need no padding, so T is not resolved here."""
    _check_mesh(mesh)
    if time_axis not in mesh.shape:
        raise ValueError(f"{mesh!r} has no time axis {time_axis!r}")
    requested = batch_axis
    if batch_axis == "auto":
        others = [a for a in mesh.axis_names if a != time_axis]
        batch_axis = others[0] if others else None
        if batch_axis is not None and batch_axis == data_parallel_axis(mesh):
            batch_axis = None  # each rank holds its own block of the batch already
    if batch_axis is None or batch_size is None:
        return None
    if batch_axis not in mesh.shape or batch_axis == time_axis:
        raise ValueError(f"batch_axis {batch_axis!r} is not a non-time axis of {mesh!r}")
    Db = mesh.shape[batch_axis]
    if batch_size % Db != 0:
        if requested == "auto":
            # a silent loss of data parallelism is a large perf cliff on a
            # 2D mesh: say so
            warnings.warn(
                f"time_mesh: batch={batch_size} does not divide the "
                f"'{batch_axis}' mesh axis size {Db}; falling back to "
                f"seq-only sharding (no data parallelism). Pad the batch "
                f"or pass batch_axis explicitly to silence this.",
                stacklevel=4,
            )
            return None
        raise ValueError(
            f"batch={batch_size} must be divisible by the '{batch_axis}' "
            f"mesh axis size {Db}"
        )
    return batch_axis


def _chain(mesh, time_axis, batch_axis, T, batch_size):
    batch_axis = _resolve_axes(mesh, time_axis, batch_axis, T, batch_size)
    return ShardedChain(mesh, time_axis, T, batch_axis, batch_size)


def time_sharded_forward_backward(trans_logits, init_logits, obs_logits, mesh,
                                  ptemp=1.0, time_axis="seq", batch_axis="auto"):
    """``ops.parallel_hmm.forward_backward_parallel`` with the time axis
    cut over ``mesh[time_axis]``.  Same returns: (p, SEzz, SEz0, logZ),
    whole on every rank.

    trans_logits: (K, K) (or batch + (K, K)), init_logits: (K,),
    obs_logits: (T,) + batch + (K,); any T works.  ``ptemp`` is a float or
    a 0-d tensor."""
    chain = _chain(mesh, time_axis, batch_axis, obs_logits.shape[0],
                   obs_logits.shape[1] if obs_logits.ndim > 2 else None)
    from ..ops.parallel_hmm import forward_backward_parallel

    return forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp,
                                     chain=chain)


def time_sharded_driven_forward_backward(trans_logits, init_logits, obs_logits,
                                         mesh, ptemp=1.0, time_axis="seq",
                                         batch_axis="auto"):
    """``ops.parallel_hmm.driven_forward_backward_parallel`` (per-time
    transition logits, per-time SEzz) with the time axis cut over
    ``mesh[time_axis]``.

    trans_logits: (T,) + batch + (K, K), obs_logits: (T,) + batch + (K,)."""
    chain = _chain(mesh, time_axis, batch_axis, obs_logits.shape[0],
                   obs_logits.shape[1] if obs_logits.ndim > 2 else None)
    from ..ops.parallel_hmm import driven_forward_backward_parallel

    return driven_forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp,
                                            chain=chain)


def time_sharded_kalman_smoother(parms, x0, like, u, mesh, time_axis="seq",
                                 batch_axis="auto"):
    """``ops.parallel_kalman.parallel_kalman_smoother`` with the time axis
    cut over ``mesh[time_axis]``: the same layouts (lane at h <= 3, plane
    at h <= 32, dense above) and the same return contract, whole on every
    rank.  The elements are built whole (the x_{-1} prior folds into the
    chain's first one) and each rank smooths its rows."""
    from ..ops.parallel_kalman import element_batch_shape, parallel_kalman_smoother

    bshape, _ = element_batch_shape(parms, like)
    chain = _chain(mesh, time_axis, batch_axis, like[0].shape[0],
                   bshape[0] if len(bshape) > 2 else None)
    return parallel_kalman_smoother(parms, x0, like, u, chain=chain)
