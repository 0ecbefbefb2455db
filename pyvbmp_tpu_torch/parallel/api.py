"""The mesh and data-parallel VB sweeps on ``torch.distributed`` (counterpart
of pyvbmp_tpu/parallel/api.py).

The JAX package runs one program over a ``jax.sharding.Mesh`` and lets XLA
insert the collectives.  Here every rank is a process holding its own
replica of the model and its own part of the data, and every collective is
a call this package makes:

- ``Mesh(ranks, axis_names)``: a 1-D or 2-D array of ranks of the default
  process group, one ``dist.new_group`` per line of each axis.  It makes
  three collectives over one axis (``all_reduce``, ``all_gather`` in list
  form and ``broadcast``) and counts the elements each one moves, by kind
  and by the caller's tag (``"scan"``, ``"halo"``, ``"reduce"``,
  ``"gather"``, ``"systems"``, ``"check"``);
- ``data_parallel_update(model, y, ...)``: each rank takes its block of the
  batch (``shard_batch``) and runs the model's own sweep; every sum over
  the batch that feeds an M-step or the ELBO is completed by one
  ``all_reduce`` over the mesh's ``data`` axis at the point where the model
  forms it (``utils.torchutils.batch_sum``).  The parameters stay
  replicated, because every rank computes the same update from the same
  sums; per-sample state (a DMBD's px, the assignments p) stays local.
  When the call ends one all_gather of the call's ELBOs over the mesh
  (``"check"``) raises ``RuntimeError`` if the ranks' models differ.
  On a ``("data", "model")`` mesh a MixLDS's K systems are also cut over
  ``model`` (``_Systems``, the JAX package's expert-parallel placement):
  each rank smooths and updates its block of the systems, one all_gather
  over ``model`` a sweep completes the responsibilities' softmax, and the
  nodes are whole again when the call ends;
- a model with ``time_mesh`` runs its sweep the same way on its rows of
  the time axis (``seq_parallel.time_sweep``): ``_time_sharded`` completes
  the same ``batch_sum`` sites over the time axis, or over time and batch
  on a 2-D mesh, in one all_reduce, and per-time state stays this rank's
  chunk.

The process group and its backend are the caller's.  NCCL is the backend
on several cards; NCCL refuses two ranks on one device, so several ranks
sharing one card use gloo, with their tensors on the card.  gloo takes CUDA
tensors for all three collectives (PyTorch 2.11 with CUDA 12.8 on an H100),
so the mesh hands every operand to the backend where it lies and stages
nothing through host memory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from ..utils import torchutils

_NO_GROUP = (
    "no default process group: start one first, e.g. "
    "torch.distributed.init_process_group('gloo', init_method='tcp://localhost:PORT', "
    "world_size=W, rank=R) in each of W processes (torchrun or "
    "torch.multiprocessing.spawn start them), or 'nccl' with one card a rank"
)


class Mesh:
    """A 1-D or 2-D array of ranks of the default process group with a name
    for each axis, mirroring the parts of ``jax.sharding.Mesh`` the parallel
    layer reads: ``shape`` (axis name -> size) and ``axis_names``.
    ``ranks`` holds the ranks, ``coords`` this rank's coordinate on each
    axis (None when the mesh does not hold this rank).

    Every rank of the world must build every mesh, in the same order, since
    ``dist.new_group`` is collective over the whole world: the constructor
    makes one group per line of each axis and one for the whole mesh, in
    the same order on every rank."""

    def __init__(self, ranks, axis_names):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(_NO_GROUP)
        ranks = np.asarray(ranks)
        axis_names = tuple(axis_names)
        if ranks.ndim not in (1, 2) or ranks.ndim != len(axis_names):
            raise ValueError(f"a mesh is a 1-D or 2-D array of ranks with a name per axis; "
                             f"got shape {ranks.shape} and names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        flat = [int(r) for r in ranks.reshape(-1)]
        world = dist.get_world_size()
        if len(set(flat)) != len(flat) or not all(0 <= r < world for r in flat):
            raise ValueError(f"mesh ranks {flat} must be distinct ranks of a world of {world}")
        self.ranks = ranks.astype(np.int64)
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, ranks.shape))
        self.rank = dist.get_rank()
        where = np.argwhere(self.ranks == self.rank)
        self.coords = dict(zip(axis_names, where[0].tolist())) if len(where) else None
        self._lines = {}
        for i, name in enumerate(axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines.tolist():
                group = dist.new_group(line) if len(line) > 1 else None
                if self.rank in line:
                    self._lines[name] = (group, line)
        self._all = (dist.new_group(flat) if len(flat) > 1 else None, flat)
        self.counts = Counter()

    def __repr__(self):
        return f"Mesh({self.ranks.tolist()}, {self.axis_names})"

    # -- bookkeeping -------------------------------------------------------------
    def reset_counts(self):
        self.counts.clear()

    def _total(self, what, tag, kind):
        return sum(n for (k, t, w), n in self.counts.items()
                   if w == what and tag in (None, t) and kind in (None, k))

    def elements(self, tag=None, kind=None):
        """Elements moved by the collectives with this tag and kind (any
        where None) since the last ``reset_counts``."""
        return self._total("elements", tag, kind)

    def nbytes(self, tag=None, kind=None):
        """Their bytes."""
        return self._total("bytes", tag, kind)

    def _line(self, axis):
        """(group, ranks) of this rank's line of ``axis``; a tuple of axes
        names one axis, or every axis of the mesh (the whole mesh)."""
        if self.coords is None:
            raise RuntimeError(f"rank {self.rank} is not in {self!r}")
        if isinstance(axis, tuple):
            if len(axis) == 1:
                axis = axis[0]
            elif sorted(axis) == sorted(self.axis_names):
                return self._all
            else:
                raise ValueError(f"{self!r}: a collective runs over one axis or all of "
                                 f"them, not {axis}")
        if axis not in self._lines:
            raise ValueError(f"{self!r} has no axis {axis!r}")
        return self._lines[axis]

    def _count(self, kind, tag, x, lines=1):
        """One collective moving ``lines`` times the elements of ``x``."""
        self.counts[(kind, tag, "elements")] += x.numel() * lines
        self.counts[(kind, tag, "bytes")] += x.numel() * lines * x.element_size()

    # -- the three collectives ----------------------------------------------------
    def all_reduce(self, x, axis, tag):
        """The sum of ``x`` over the ranks of this rank's line of ``axis``
        (a new tensor; ``x`` is left as it was).  ``axis`` may be a tuple of
        every axis: the sum over the whole mesh.  Counts x's elements."""
        group, line = self._line(axis)
        if len(line) == 1:
            return x
        self._count("all_reduce", tag, x)
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    def all_gather(self, x, axis, tag):
        """``x`` of every rank of this rank's line of ``axis``, as a list in
        mesh order (every rank passes the same shape).  Counts the elements
        received, the line's size times x's."""
        group, line = self._line(axis)
        if len(line) == 1:
            return [x]
        self._count("all_gather", tag, x, len(line))
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in line]
        dist.all_gather(out, x, group=group)
        # the group numbers its ranks in ascending order, the mesh may not
        order = sorted(line)
        return [out[order.index(r)] for r in line]

    def broadcast(self, x, axis, src, tag):
        """``x`` of the rank at coordinate ``src`` of this rank's line of
        ``axis``, on every rank of the line.  Counts x's elements."""
        group, line = self._line(axis)
        if len(line) == 1:
            return x
        self._count("broadcast", tag, x)
        out = x.contiguous().clone()
        dist.broadcast(out, src=line[src], group=group)
        return out

    def _broadcast_all(self, x, tag):
        """``x`` of the mesh's first rank on every rank of the mesh."""
        group, flat = self._all
        if len(flat) == 1:
            return x
        self._count("broadcast", tag, x)
        out = x.contiguous().clone()
        dist.broadcast(out, src=flat[0], group=group)
        return out

    # -- packed forms -----------------------------------------------------------
    def all_reduce_many(self, xs, axis, tag):
        """The sums of the tensors ``xs`` over ``axis`` in one all_reduce of
        their flattened concatenation (in their common dtype)."""
        xs = tuple(xs)
        dtype = xs[0].dtype
        for x in xs[1:]:
            dtype = torch.promote_types(dtype, x.dtype)
        flat = torch.cat([x.reshape(-1).to(dtype) for x in xs])
        flat = self.all_reduce(flat, axis, tag)
        out, i = [], 0
        for x in xs:
            out.append(flat[i: i + x.numel()].reshape(x.shape).to(x.dtype))
            i += x.numel()
        return tuple(out)


def _bounds(n, D, d):
    """Rows [start, end) of block d of n rows cut into D (tensor_split)."""
    q, rem = divmod(n, D)
    start = d * q + min(d, rem)
    return start, start + q + (1 if d < rem else 0)


def _flat_cols(xs):
    """Tensors with a common leading axis side by side as (rows, columns)
    in their common dtype."""
    n = xs[0].shape[0]
    dtype = xs[0].dtype
    for x in xs[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.cat([x.reshape(n, math.prod(x.shape[1:])).to(dtype) for x in xs], 1)


def _gather_leading(mesh, axis, xs, sizes, tag):
    """The tensors ``xs``, whose leading axis is this rank's block of an
    axis cut in ``torch.tensor_split`` order over ``axis`` of ``mesh``
    (``sizes``: every block's length, in mesh order), whole on every rank
    of the line: side by side as columns, each block padded to the
    longest, in one all_gather."""
    cols = _flat_cols(xs)
    pad = cols.new_zeros((max(sizes) - cols.shape[0],) + tuple(cols.shape[1:]))
    got = mesh.all_gather(torch.cat([cols, pad], 0), axis, tag)
    full = torch.cat([g[:n] for g, n in zip(got, sizes)], 0)
    out, i = [], 0
    for x in xs:
        w = math.prod(x.shape[1:])
        out.append(full[:, i: i + w].reshape(full.shape[:1] + x.shape[1:]).to(x.dtype))
        i += w
    return tuple(out)


class _Systems:
    """A mixture's K systems cut over ``axis`` of ``mesh`` in
    ``torch.tensor_split`` order: this rank holds systems [start, end),
    ``size`` of them.  Every rank of the line holds at least one."""

    def __init__(self, mesh, axis, K):
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.rank} is not in {mesh!r}")
        M = mesh.shape[axis]
        if M > K:
            raise ValueError(f"a {axis!r} axis of {M} ranks cannot cut {K} systems: a rank "
                             f"would hold none; put at most {K} ranks on it")
        self.mesh, self.axis, self.K = mesh, axis, K
        self.sizes = [e - s for s, e in (_bounds(K, M, m) for m in range(M))]
        self.start, self.end = _bounds(K, M, mesh.coords[axis])
        self.size = self.end - self.start

    def take(self, x, dim=0):
        """This rank's systems of a whole ``x`` whose ``dim`` is the system
        axis."""
        return x.narrow(dim, self.start, self.size)

    def whole(self, *xs, dim=0, tag="systems"):
        """The ``xs``, this rank's systems on ``dim``, with every rank's: all
        K systems on every rank of the line, in one all_gather."""
        xs = _gather_leading(self.mesh, self.axis, tuple(x.movedim(dim, 0) for x in xs),
                             self.sizes, tag)
        return tuple(x.movedim(0, dim) for x in xs)


def _check_mesh(mesh, what="mesh"):
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"{what} must be a pyvbmp_tpu_torch.parallel.Mesh (a mesh of "
            f"torch.distributed ranks), got {type(mesh).__module__}.{type(mesh).__name__}"
        )
    return mesh


def as_time_mesh(time_mesh):
    """A model's ``time_mesh`` argument: None, or a port ``Mesh``; anything
    else (a ``jax.sharding.Mesh`` by mistake) raises ``TypeError``."""
    return None if time_mesh is None else _check_mesh(time_mesh, "time_mesh")


def make_mesh(n_devices=None, axis_name="data"):
    """A 1-D mesh of ranks 0 .. n_devices - 1 (every rank of the default
    process group by default).  Every rank of the world calls it."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(_NO_GROUP)
    n = dist.get_world_size() if n_devices is None else n_devices
    return Mesh(np.arange(n), (axis_name,))


def shard_batch(mesh, x, batch_axis=1, axis_name="data"):
    """This rank's contiguous block of ``x`` along ``batch_axis``, the
    blocks in ``torch.tensor_split`` order over the ``axis_name`` axis."""
    if axis_name not in mesh.shape:
        raise ValueError(f"{mesh!r} has no axis {axis_name!r}")
    if mesh.coords is None:
        raise RuntimeError(f"rank {mesh.rank} is not in {mesh!r}")
    blocks = torch.tensor_split(x, mesh.shape[axis_name], dim=batch_axis)
    return blocks[mesh.coords[axis_name]].contiguous()


def shard_pytree_batch(mesh, tree, batch_axis=1, axis_name="data"):
    """``shard_batch`` of every tensor in nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return shard_batch(mesh, tree, batch_axis, axis_name)
    if isinstance(tree, dict):
        return {k: shard_pytree_batch(mesh, v, batch_axis, axis_name) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_pytree_batch(mesh, v, batch_axis, axis_name) for v in tree)
    return tree


def _broadcast_tensor(mesh, t):
    if t.dtype == torch.bool:  # sent as bytes
        return mesh._broadcast_all(t.to(torch.uint8), "replicate").to(torch.bool)
    return mesh._broadcast_all(t, "replicate")


def replicate(mesh, tree):
    """``tree`` with every tensor replaced by the mesh's first rank's: a
    tensor, a parameter node (every tensor field, sub-nodes included),
    nested tuples, lists and dicts of them, or a model, whose attributes
    are replaced in place (its mesh is not walked).  Every rank of the mesh
    calls it with the same structure."""
    if isinstance(tree, torch.Tensor):
        return _broadcast_tensor(mesh, tree)
    if isinstance(tree, Mesh) or tree is None:
        return tree
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: replicate(mesh, getattr(tree, f.name)) for f in dataclasses.fields(tree)
            if f.init})
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if hasattr(tree, "__dict__") and type(tree).__module__.startswith(__package__.split(".")[0]):
        for k, v in list(vars(tree).items()):
            setattr(tree, k, replicate(mesh, v))
    return tree


# The data-parallel sweep running now: (mesh, axis), or None.
_DATA_PARALLEL = None


def data_parallel_axis(mesh):
    """The axis of ``mesh`` whose batch ``data_parallel_update`` has split
    for the sweep running now, or None."""
    if _DATA_PARALLEL is not None and _DATA_PARALLEL[0] is mesh:
        return _DATA_PARALLEL[1]
    return None


@contextlib.contextmanager
def _data_parallel(mesh, axis):
    """Sums over the batch (``torchutils.batch_sum``) completed over
    ``axis`` for the block."""
    global _DATA_PARALLEL
    saved = _DATA_PARALLEL, torchutils.BATCH_REDUCE
    _DATA_PARALLEL = (mesh, axis)
    torchutils.BATCH_REDUCE = lambda xs: mesh.all_reduce_many(xs, axis, "reduce")
    try:
        yield
    finally:
        _DATA_PARALLEL, torchutils.BATCH_REDUCE = saved


@contextlib.contextmanager
def _time_sharded(mesh, axes):
    """Sums over the samples and time rows (``torchutils.batch_sum``)
    completed over ``axes`` of ``mesh`` (the time axis, and the axis the
    batch is split over when it is) for the block.  Inside
    ``data_parallel_update`` over the same mesh the data axis joins them,
    so that one all_reduce covers both; a data-parallel sweep over another
    mesh completes the sums after, with its own."""
    saved = torchutils.BATCH_REDUCE
    dp = data_parallel_axis(mesh)
    outer = saved if dp is None else None
    axes = tuple(axes) + ((dp,) if dp is not None and dp not in axes else ())

    def reduce(xs):
        xs = mesh.all_reduce_many(xs, axes, "reduce")
        return xs if outer is None else outer(xs)

    torchutils.BATCH_REDUCE = reduce
    try:
        yield
    finally:
        torchutils.BATCH_REDUCE = saved


# The largest relative difference between two ranks' ELBOs that
# data_parallel_update's check lets pass: a sum left incomplete moves the ELBO
# by O(1) relative, ranks that completed theirs agree bit for bit.
AGREEMENT_RTOL = 1e-6


def _check_agreement(mesh, model, elbos, device):
    """One all_gather over the whole mesh (tag ``"check"``) of the ELBOs
    this call appended; ``RuntimeError`` on every rank where any rank's
    differ from the mesh's first rank's by more than ``AGREEMENT_RTOL``
    relative."""
    mine = torch.tensor([float(e) for e in elbos], dtype=torch.float64, device=device)
    rows = torch.stack(mesh.all_gather(mine, mesh.axis_names, "check")).cpu().numpy()
    differ = ~np.isclose(rows, rows[0], rtol=AGREEMENT_RTOL, atol=0.0, equal_nan=True)
    if differ.any():
        rank, sweep = np.argwhere(differ)[0]
        raise RuntimeError(
            f"data_parallel_update left the ranks of {mesh!r} with different models: "
            f"{type(model).__name__}'s ELBO at sweep {sweep + 1} of {len(elbos)} is "
            f"{rows[rank, sweep]!r} on mesh rank {int(mesh.ranks.reshape(-1)[rank])} and "
            f"{rows[0, sweep]!r} on the first; a sum over the batch in its sweep is not "
            f"completed over the ranks (torchutils.batch_sum)")


def data_parallel_update(model, y, u=None, r=None, mesh=None, iters=1, lr=1.0,
                         batch_axis=None):
    """Run the model's sweeps with the trajectory batch split over the
    mesh's ``data`` axis.  Every rank calls it with the whole ``y`` (as a
    JAX caller passes a global array) and the same model.

    Works for LDS, MixLDS, DMBD, HMM, the tensor HMMs (Tensor_HMM, HHMM,
    Factorial_HMM), NLDS, BFA, the ChainedBayesianTransformer and the
    mixtures (GMM, GMM_vector, the Poisson mixture, a ``Mixture`` over a node
    that sums through ``batch_sum``): each rank takes its block of
    ``y`` (``shard_batch``) and runs the model's own sweep, in which every
    sum over the batch that feeds an M-step or the ELBO is completed by one
    all_reduce over ``data`` where it is formed (``torchutils.batch_sum``,
    tagged ``"reduce"``); nothing else crosses the mesh.  The ELBOs and the
    parameters come out the same on every rank; per-sample state (a DMBD's
    px, the assignments p) is this rank's block.  The models must start
    equal on every rank: built from one seed, or put through ``replicate``.
    A model that also has a ``time_mesh`` over the same mesh runs on its
    rows of T as well, and one all_reduce over the whole mesh completes
    each site; its per-time state is then this rank's rows of its block.

    ``batch_axis`` names the sample axis of ``y`` to split: 1 by default
    (time-major ``(T, batch, ...)``: LDS, DMBD, HMM), 0 for sample-major
    data such as GMM's ``(n, d)``.  A model with ``reshape_inputs`` and
    ``_update_reshaped`` (LDS, DMBD) has its inputs reshaped first and each
    of y, u and r split on that axis where it spans the batch.

    A ``("data", "model")`` mesh also cuts a MixLDS's K systems over
    ``model`` (``(1, M)``: the systems alone), as the JAX package places
    them: each rank smooths and updates its block of the systems (every
    field of ``lds.x0``, ``lds.A`` and ``lds.obs_model`` that carries the
    node's batch), the responsibilities' softmax is completed over all K by
    one all_gather over ``model`` a sweep (tag ``"systems"``: each
    sequence's logZ and each system's KL, O(batch x K) elements, whatever
    T), and the sums over the batch are completed over ``data`` alone.
    When the call ends the nodes are whole again on every rank (one
    all_gather, tag ``"gather"``); ``lds.px`` stays this rank's systems of
    its batch block until ``gather_posterior(model)``, and the state
    exporters refuse it until then.  A ``model`` axis longer than K raises
    ``ValueError``; one on another model, or beside a ``time_mesh``, raises
    ``NotImplementedError``.

    Per-sample state that a model's first sweep reads (NLDS's q(s)) enters
    as this rank's block of the whole batch's (``model._shard_samples``):
    a q(s) of the whole batch that is already set is cut, and one that the
    first sweep would draw is drawn at the whole batch's size from the
    model's generator, so the ranks' blocks are the single process's draw.

    The check: when the call ends, one all_gather over the whole mesh
    (tag ``"check"``, the call's ``iters`` ELBOs in float64 from each
    rank), and ``RuntimeError`` on every rank, naming the model's class and
    the first sweep that differs, where a rank's ELBOs differ from the
    first rank's by more than ``AGREEMENT_RTOL`` relative: a model that
    forms a sum over the batch without ``batch_sum`` would leave each rank
    with its own model.  A model with no ``ELBO_save`` is not checked.
    ``y`` must be one tensor: the ARHMMs' tuples of observations raise
    ``NotImplementedError``, as the JAX package's ``shard_batch`` places
    one array.
    """
    if mesh is None:
        mesh = make_mesh()
    _check_mesh(mesh)
    if batch_axis is None:
        batch_axis = 1
    if "data" not in mesh.shape:
        raise ValueError(f"data_parallel_update splits the batch over a 'data' axis; "
                         f"{mesh!r} has none")
    if not isinstance(y, torch.Tensor):
        raise NotImplementedError(
            f"data_parallel_update splits one tensor y along its batch axis; "
            f"{type(model).__name__} was given a {type(y).__name__}, which it cannot split "
            f"(the JAX package's shard_batch places one array too)")
    systems = contextlib.nullcontext()
    if mesh.shape.get("model", 1) > 1:
        if not hasattr(model, "_split_systems"):
            raise NotImplementedError(
                f"a 'model' mesh axis cuts a MixLDS's systems; the JAX package shards no "
                f"other model's components, so {type(model).__name__} has none to cut")
        systems = model._split_systems(_Systems(mesh, "model", model.num_systems))
    elbos = getattr(model, "ELBO_save", None)
    n_elbos = None if elbos is None else len(elbos)
    with _data_parallel(mesh, "data"), systems:
        if hasattr(model, "_update_reshaped") and hasattr(model, "reshape_inputs"):
            y, u, r = model.reshape_inputs(y, u, r)
            n = y.shape[batch_axis]
            y, u, r = (shard_batch(mesh, x, batch_axis) if x.shape[batch_axis] == n else x
                       for x in (y, u, r))
            # the model's own step dispatcher: the code path update() runs
            model._update_reshaped(y, u, r, iters=iters, lr=lr)
        else:
            if hasattr(model, "_shard_samples"):
                model._shard_samples(y, lambda x: shard_batch(mesh, x, batch_axis))
            model.update(shard_batch(mesh, y, batch_axis), iters=iters, lr=lr)
    if n_elbos is not None:
        _check_agreement(mesh, model, model.ELBO_save[n_elbos:], y.device)
    return model
