"""Sequence (time-axis) parallelism on ``torch.distributed`` (counterpart of
pyvbmp_tpu/parallel/seq_parallel.py).

The scan smoothers compose per-time elements with an associative combine,
so the time axis can be cut across the ranks of a mesh axis: each rank
scans its own chunk, the D chunk totals are all_gathered (one row each),
every rank folds the totals of its predecessors into a carry-in and
combines it with each of its rows.  That is the three-phase block scan of
the time fold (``ops/scan.py:FoldedScan``) with the chunks on different
ranks.  The steps by one row across a chunk edge (the backward message
shift, alpha_{t-1} for the pairwise statistics) are halo rows.  Per call
that is O(D) elements, whatever T.

Chunks follow ``torch.tensor_split``: rank d of the time axis holds rows
[start_d, end_d), the lengths differing by at most one, so any T works
without padding.  Where T < D the last ranks hold no rows: their totals and
halo rows are skipped by a flag gathered beside them, which the host reads.

The smoothers themselves are the single-process ones
(``ops.parallel_hmm``, ``ops.parallel_kalman.kalman_smoother_rows``) given
a ``ShardedChain``: the local scans go through the same dispatch (the CUDA
kernels on the card, each rank on its own chunk); the carry-in combine is
the plain torch combine batched over the rows.  On a chain they take this
rank's rows of the time-leading inputs (``ShardedChain.take``) and return
its rows of the time-leading outputs (HMM p and the driven form's per-time
SEzz; the Kalman marginals and cross-covariances), its part of every sum
over time, and each chain-end value (SEz0, the x_{-1} marginal, logZ) on
the rank holding that row, zeros on the others: one all_reduce over the
time axis completes sums and chain-end values alike.

A model with ``time_mesh`` runs its whole sweep that way, as the JAX
package's sweep runs on the shards that its smoothers return:
``time_sweep`` cuts ``y`` (and u, r, and any whole per-time state it is
given) to this rank's rows [start, end) once, when the sweep starts, and
the model forms its observation logits, messages and sufficient
statistics on its rows.  Every sum that an M-step or the ELBO reads is
completed where it is formed (``torchutils.batch_sum``): one all_reduce
over the time axis, over time and batch on a 2-D mesh (tag ``"reduce"``).
A sweep gathers nothing; the parameters and ELBOs come out the same on
every rank, and the per-time state (each model's ``CHUNK_STATE``: a DMBD's
px and p, an HMM's p, a dHMM's p and SEzz, an LDS's px, a MixLDS's px)
stays this rank's chunk, as ``data_parallel_update`` leaves per-sample
state as this rank's block; logZ is completed over time when the update
ends.  ``gather_posterior(model)`` makes the state whole on request (tag
``"gather"``); no sweep calls it, and the state exporters
(``utils.convert``, ``utils.checkpoint``) refuse a model holding a chunk.

The public functions (``time_sharded_forward_backward``, its driven form,
``time_sharded_kalman_smoother``) take the whole, replicated inputs and
return the whole outputs with the JAX package's shapes: they run the
chain on this rank's rows, then gather the time-leading outputs over the
time axis (tag ``"gather"``) and complete the rest in one all_reduce.  On
a 2-D (seq x data) mesh ``batch_axis`` ("auto": the first non-time axis)
also splits the batch (axis 1 of the time-leading inputs); the outputs
are gathered over it too.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import warnings

import torch

from ..ops import scan
from .api import (_bounds, _check_mesh, _gather_leading, _time_sharded, data_parallel_axis,
                  shard_batch)


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
    None.  The smoothers take this rank's rows (``take``) and leave every
    output as its rows, its part of each sum over time, and each chain-end
    value (the first and last rows' SEz0, x_{-1} marginal and logZ) on the
    rank that holds that row, zeros on the others."""

    def __init__(self, mesh, axis, T, batch_axis=None, batch_size=None):
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.rank} is not in {mesh!r}")
        self.mesh, self.axis, self.T = mesh, axis, T
        self.D = mesh.shape[axis]
        self.bounds = [_bounds(T, self.D, d) for d in range(self.D)]
        self.start, self.end = self.bounds[mesh.coords[axis]]
        self.batch_axis, self.batch_size = batch_axis, batch_size
        self.holds_first = self.start == 0 and self.end > 0
        self.holds_last = self.end == T and self.end > self.start

    def take(self, x):
        """This rank's rows of a whole time-leading ``x`` (and its block of
        the batch, axis 1, where the batch is split)."""
        x = x[self.start: self.end]
        if self.batch_axis is not None and x.ndim > 1 and x.shape[1] == self.batch_size:
            x = shard_batch(self.mesh, x, 1, self.batch_axis)
        return x

    def take_samples(self, x):
        """This rank's block of a sample-leading ``x`` (one value a
        sequence), where the batch is split; ``x`` as it is elsewhere."""
        if self.batch_axis is None:
            return x
        return shard_batch(self.mesh, x, 0, self.batch_axis)

    def scan(self, s, leaves, reverse=False):
        return sharded_associative_scan(s, tuple(leaves), self.mesh, self.axis, reverse)

    def shift(self, xs, up, edge=None):
        if edge is None:
            edge = tuple(x.new_zeros(x.shape[1:]) for x in xs)
        return _shift(self.mesh, self.axis, tuple(xs), up, tuple(edge))

    def first(self, *xs):
        return tuple(x[:1] if self.holds_first else x[:0] for x in xs)

    def last(self, *xs):
        return tuple(x[-1:] if self.holds_last else x[:0] for x in xs)

    def complete_time(self, *xs):
        """This rank's parts ``xs`` of sums over time, completed over the
        time axis alone (one all_reduce, tagged "reduce"): a value that is
        needed whole per sequence before it is summed over the batch."""
        return self.mesh.all_reduce_many(xs, self.axis, "reduce")

    def once(self, *xs):
        """``xs``, which every rank of the time line holds alike, kept on
        the line's first rank and zeros on the others: summed over the line
        they count once."""
        if self.mesh.coords[self.axis] == 0:
            return xs
        return tuple(torch.zeros_like(x) for x in xs)

    def assemble(self, *xs, time=True):
        """The ``xs`` whole on every rank: time-leading ones over all T rows
        (``time``), and over the batch where it is split (axis 1 of a
        time-leading output, axis 0 of one a sequence)."""
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
        return _gather_leading(self.mesh, self.axis, xs, [e - s for s, e in self.bounds],
                               "gather")


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


def time_sweep(model, y, batch_size, *more):
    """The block of one ``update`` of ``model`` (and the models it drives,
    ``more``) on inputs whose time axis leads ``y`` and that hold
    ``batch_size`` sequences on axis 1 (None: no sample axis): with a
    ``time_mesh`` a time-sharded sweep, yielding this rank's chain
    (``ShardedChain`` over the mesh's "seq" axis, the batch split over its
    other axis where that divides it), which the models read as
    ``_sweep_chunk`` while the block runs and keep as ``time_chunk`` after.
    Per-time state that a model holds whole (built from a state, or made
    whole by ``gather_posterior``) is cut to this rank's rows first.  Every
    ``batch_sum`` in the block is completed over the time axis, and over
    the batch axis where the chain splits the batch, in one all_reduce
    (``api._time_sharded``).  Without a mesh, or inside a sweep of the
    model already, a block yielding None."""
    mesh = model.time_mesh
    if mesh is None or model._sweep_chunk is not None:
        return contextlib.nullcontext()
    chunk = _chain(mesh, "seq", "auto", y.shape[0], batch_size)
    return _time_sweep(mesh, chunk, (model,) + more)


def _chunk_state(model):
    """(owner, attribute, kind) of each entry of ``model.CHUNK_STATE``."""
    for path, kind in model.CHUNK_STATE.items():
        *parents, name = path.split(".")
        owner = model
        for p in parents:
            owner = getattr(owner, p)
        yield owner, name, kind


def _take_whole(chunk, models):
    """Cut the whole per-time state of ``models`` (those holding no chunk)
    to ``chunk``'s rows, each attribute once."""
    seen = set()
    for m in models:
        for owner, name, kind in _chunk_state(m):
            x = getattr(owner, name, None)
            if (kind != "time" or x is None or (id(owner), name) in seen
                    or m.time_chunk is not None):
                continue
            seen.add((id(owner), name))
            if isinstance(x, torch.Tensor):
                x = chunk.take(x) if x.shape[0] == chunk.T else x
            elif x.mu.shape[0] == chunk.T:  # a Gaussian message
                x = dataclasses.replace(x, **{f: chunk.take(getattr(x, f))
                                              for f in _PX_FIELDS})
            setattr(owner, name, x)


@contextlib.contextmanager
def _time_sweep(mesh, chunk, models):
    axes = (chunk.axis,) + (() if chunk.batch_axis is None else (chunk.batch_axis,))
    _take_whole(chunk, models)
    for m in models:
        m.time_chunk = m._sweep_chunk = chunk
    try:
        with _time_sharded(mesh, axes):
            yield chunk
    finally:
        for m in models:
            m._sweep_chunk = None


_PX_FIELDS = ("mu", "Sigma", "invSigmamu", "invSigma")


def gather_posterior(model):
    """The whole per-time state of ``model`` on every rank of its mesh
    (each calls it): after a time-sharded update, the state that the sweep
    left as this rank's (the model's ``CHUNK_STATE``: DMBD px and p (its
    obs_model's); HMM p; dHMM p and SEzz; LDS px and logZ; MixLDS px (its
    LDS's), p and logZ) assembled over all T rows and over the batch where
    the sweep split it (tag "gather").  After ``data_parallel_update`` cut a
    MixLDS's systems over a "model" axis, its px is assembled over the
    systems the same way (its batch stays this rank's block, as every
    data-parallel sweep leaves per-sample state).  The whole state replaces
    the chunk on the model, so the state exporters take it and the next
    sweep cuts it again; a dict of it by name is returned.  A model whose
    state is whole already is returned as it is, with no collective.  No
    sweep calls it."""
    if getattr(model, "system_block", None) is not None:
        model._whole_systems()
    chunk = model.time_chunk
    out = {}
    for owner, name, kind in _chunk_state(model):
        x = getattr(owner, name, None)
        if x is None:
            continue
        if chunk is not None and kind == "time" and not isinstance(x, torch.Tensor):
            fields = chunk.assemble(*(getattr(x, f) for f in _PX_FIELDS))
            x = dataclasses.replace(x, **dict(zip(_PX_FIELDS, fields)))
        elif chunk is not None:
            x, = chunk.assemble(x, time=kind == "time")
        setattr(owner, name, x)
        out[name] = x
    for owner, _, _ in _chunk_state(model):
        if hasattr(owner, "time_chunk"):
            owner.time_chunk = None
    model.time_chunk = None
    return out


def _whole(chain, rows, parts):
    """The whole outputs from this rank's: the time-leading ``rows`` over
    all T rows, the ``parts`` (one value a sequence: parts of sums over
    time, chain-end values on their holder) completed over the time axis in
    one all_reduce; both over the batch where it is split."""
    rows = chain.assemble(*rows)
    parts = chain.assemble(*chain.complete_time(*parts), time=False)
    return rows, parts


def time_sharded_forward_backward(trans_logits, init_logits, obs_logits, mesh,
                                  ptemp=1.0, time_axis="seq", batch_axis="auto"):
    """``ops.parallel_hmm.forward_backward_parallel`` with the time axis
    cut over ``mesh[time_axis]``.  Same returns: (p, SEzz, SEz0, logZ),
    whole on every rank.

    trans_logits: (K, K) (or batch + (K, K)), init_logits: (K,),
    obs_logits: (T,) + batch + (K,); any T works.  ``ptemp`` is a float or
    a 0-d tensor."""
    from ..ops.parallel_hmm import forward_backward_parallel

    chain = _chain(mesh, time_axis, batch_axis, obs_logits.shape[0],
                   obs_logits.shape[1] if obs_logits.ndim > 2 else None)
    p, SEzz, SEz0, logZ = forward_backward_parallel(
        trans_logits, init_logits, chain.take(obs_logits), ptemp, chain=chain)
    (p,), (SEzz, SEz0, logZ) = _whole(chain, (p,), (SEzz, SEz0, logZ))
    return p, SEzz, SEz0, logZ


def time_sharded_driven_forward_backward(trans_logits, init_logits, obs_logits,
                                         mesh, ptemp=1.0, time_axis="seq",
                                         batch_axis="auto"):
    """``ops.parallel_hmm.driven_forward_backward_parallel`` (per-time
    transition logits, per-time SEzz) with the time axis cut over
    ``mesh[time_axis]``.

    trans_logits: (T,) + batch + (K, K), obs_logits: (T,) + batch + (K,)."""
    from ..ops.parallel_hmm import driven_forward_backward_parallel

    chain = _chain(mesh, time_axis, batch_axis, obs_logits.shape[0],
                   obs_logits.shape[1] if obs_logits.ndim > 2 else None)
    p, SEzz, SEz0, logZ = driven_forward_backward_parallel(
        chain.take(trans_logits), init_logits, chain.take(obs_logits), ptemp, chain=chain)
    (p, SEzz), (SEz0, logZ) = _whole(chain, (p, SEzz), (SEz0, logZ))
    return p, SEzz, SEz0, logZ


def time_sharded_kalman_smoother(parms, x0, like, u, mesh, time_axis="seq",
                                 batch_axis="auto"):
    """``ops.parallel_kalman.parallel_kalman_smoother`` with the time axis
    cut over ``mesh[time_axis]``: the same layouts (lane at h <= 3, plane
    at h <= 32, dense above) and the same return contract, whole on every
    rank.  Each rank smooths its rows of ``like`` and ``u``; the x_{-1}
    prior folds into the element of the rank holding row 0."""
    from ..ops.parallel_kalman import element_batch_shape, kalman_smoother_rows

    bshape, _ = element_batch_shape(parms, like)
    chain = _chain(mesh, time_axis, batch_axis, like[0].shape[0],
                   bshape[0] if len(bshape) > 2 else None)
    marginals, Sigma_cross, *ends = kalman_smoother_rows(
        parms, x0, tuple(chain.take(x) for x in like), chain.take(u), chain)
    (*marginals, Sigma_cross), ends = _whole(chain, (*marginals, Sigma_cross), ends)
    return (tuple(marginals), Sigma_cross[1:], Sigma_cross[0], *ends)
