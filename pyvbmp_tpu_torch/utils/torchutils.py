"""Node plumbing and contraction helpers shared by the distributions,
transforms and models (counterpart of pyvbmp_tpu/utils/jaxutils.py).

Every parameter node is an immutable dataclass of tensors and sub-nodes
(or lists of sub-nodes):
``ss_update`` and friends return a new node (as in the JAX package), and the
model shells re-assign the returned nodes.  ``Node.to`` moves a whole node
tree to a device and a floating dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch

from .linalg import product


def node(cls):
    """Decorate a node class: a frozen dataclass."""
    return dataclasses.dataclass(frozen=True, eq=False)(cls)


class Node:
    """Base of the immutable parameter nodes."""

    def to(self, device=None, dtype=None):
        """The same node with every tensor on ``device``; floating tensors
        also cast to ``dtype``."""
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                changes[f.name] = v.to(
                    device=device, dtype=dtype if v.is_floating_point() else None
                )
            elif isinstance(v, Node):
                changes[f.name] = v.to(device, dtype)
            elif isinstance(v, list):  # a list of sub-nodes
                changes[f.name] = [x.to(device, dtype) for x in v]
        return dataclasses.replace(self, **changes)


def replace(n, **changes):
    """dataclasses.replace for nodes."""
    return dataclasses.replace(n, **changes)


def batch_paths(n):
    """The paths (tuples of field names) of the tensor fields of node ``n``
    and of its sub-nodes that carry the node's batch axes in front (a
    field's leading shape is the node's own ``batch_shape``), in field
    order.  A field held once for the whole batch (a prior broadcast over
    it: 1s or no batch axes in front), a bool mask and anything that is not
    a tensor are left out."""
    out = []
    for f in dataclasses.fields(n):
        v = getattr(n, f.name)
        if isinstance(v, Node):
            out += [(f.name,) + p for p in batch_paths(v)]
        elif (isinstance(v, torch.Tensor) and n.batch_shape and v.dtype != torch.bool
              and tuple(v.shape[:len(n.batch_shape)]) == tuple(n.batch_shape)):
            out.append((f.name,))
    return out


def at_path(n, path):
    """The field of node ``n`` at ``path``."""
    for name in path:
        n = getattr(n, name)
    return n


def with_batch(n, leaves, size):
    """Node ``n`` with the fields at the paths of ``leaves`` (path ->
    tensor) replaced, and the first batch axis of ``n`` and of each sub-node
    on a path ``size`` long."""
    changes = {"batch_shape": (size,) + tuple(n.batch_shape[1:])}
    for name in dict.fromkeys(p[0] for p in leaves):
        sub = {p[1:]: x for p, x in leaves.items() if p[0] == name}
        changes[name] = sub[()] if () in sub else with_batch(getattr(n, name), sub, size)
    return replace(n, **changes)


def damp(new, old, lr):
    """Learning-rate damped natural-parameter blend: lr*new + (1-lr)*old."""
    return lr * new + (1.0 - lr) * old


def sum_leading(x, ndim_keep):
    """Sum over all leading dims so that x.ndim == ndim_keep."""
    if x.ndim > ndim_keep:
        return x.sum(tuple(range(x.ndim - ndim_keep)))
    return x


def tsum(x, dims):
    """``x.sum(dims)`` where an empty ``dims`` sums over every axis (the
    reference's torch idiom, e.g. dists/MVN_ard.py:77)."""
    dims = tuple(dims)
    if len(dims) == 0:
        return x.sum()
    return x.sum(dims)


def _tf32_switches():
    """(API, matmul setting, cuDNN setting) as the caller set them.  PyTorch
    refuses to read its legacy ``allow_tf32`` switches once the newer
    ``fp32_precision`` ones were set, so the reader follows the caller."""
    try:
        return ("allow_tf32", torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    except RuntimeError:
        return ("fp32_precision", torch.backends.cuda.matmul.fp32_precision,
                torch.backends.cudnn.fp32_precision)


def _set_tf32_switches(api, matmul, cudnn):
    setattr(torch.backends.cuda.matmul, api, matmul)
    setattr(torch.backends.cudnn, api, cudnn)


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matmuls and convolutions at full float32 precision (no
    TF32) inside the block, whatever the caller set; the caller's setting
    is restored on exit, through the API the caller used."""
    api, matmul, cudnn = _tf32_switches()
    off = False if api == "allow_tf32" else "ieee"
    _set_tf32_switches(api, off, off)
    try:
        yield
    finally:
        _set_tf32_switches(api, matmul, cudnn)


def highest_precision(fn):
    """Decorate a method to run under ``full_fp32_matmul``.

    The Polya-Gamma fixed point (quadratic forms x'E[bb']x inside tanh) is
    cancellation-sensitive: at reduced matmul precision it collapses the
    posterior to chance-level predictions.  TF32 is the H100's reduced
    precision, so the logistic-regression methods pin it off."""

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with full_fp32_matmul():
            return fn(*a, **k)

    return wrapped


def bcontract_pp(X, W):
    """``(X * W).sum((-1, -2))``: per-component trace contraction of a
    message with a parameter stack W (B..., p, q).  When X carries
    broadcast 1s at every B position (the role and mixture pattern) it is
    one matmul over the flattened p*q channel, so the (samples, B, p, q)
    product is never made."""
    k = W.ndim - 2
    if (
        k < 1
        or X.ndim < W.ndim
        or X.shape[-2:] != W.shape[-2:]
        or any(s != 1 for s in X.shape[-2 - k: -2])
    ):
        return (X * W).sum((-1, -2))
    rows = X.reshape(X.shape[: -2 - k] + (X.shape[-2] * X.shape[-1],))
    out = rows @ W.reshape(-1, W.shape[-2] * W.shape[-1]).T
    return out.reshape(out.shape[:-1] + W.shape[:-2])


def bweighted_sum(X, pv, ns):
    """``(X * pv).sum(range(ns))``: the p-weighted sum over the ``ns``
    leading sample dims of matrix messages X (sample + mid + (a, b)) with
    weights pv (sample + B + (1, 1)).  When every mid dim of X is a
    broadcast 1 it is one (B, samples) @ (samples, a*b) matmul, so the
    (samples, B, a, b) product is never made."""
    sdims = tuple(range(ns))
    mid_x, mid_p = X.shape[ns:-2], pv.shape[ns:-2]
    if (
        X.ndim != pv.ndim
        or tuple(pv.shape[-2:]) != (1, 1)
        or any(s != 1 for s in mid_x)
    ):
        return (X * pv).sum(sdims)
    sample = torch.broadcast_shapes(X.shape[:ns], pv.shape[:ns])
    rows = X.expand(sample + X.shape[ns:]).reshape(-1, X.shape[-2] * X.shape[-1])
    weights = pv.expand(sample + mid_p + (1, 1)).reshape(rows.shape[0], math.prod(mid_p))
    return (weights.T @ rows).reshape(tuple(mid_p) + tuple(X.shape[-2:]))


def brole_avg(M, p):
    """``sum_k p[..., k] * M[..., k, :, :]``: the role average of
    per-role matrix messages, as the product p (..., 1, K) @ M (..., K, a*b)
    (``linalg.product``): one GEMM where M is a parameter broadcast over the
    data's axes, a broadcast product and a sum where M varies along them."""
    avg = product(p.unsqueeze(-2), M.flatten(-2))
    return avg.reshape(avg.shape[:-2] + M.shape[-2:])


def bquad(X, W):
    """Per-component quadratic form ``x^T W_k x``: X is (..., d) with
    broadcast 1s at W's batch positions, W is (B..., d, d).  In that
    pattern it is one (samples, d) @ (d, B*d) matmul and an elementwise
    reduce, with no (samples, B, d, d) intermediate."""
    k = W.ndim - 2
    d = W.shape[-1]
    if (
        k < 1
        or X.ndim < W.ndim - 1
        or X.shape[-1] != d
        or any(s != 1 for s in X.shape[-1 - k: -1])
    ):
        return ((X[..., None] * W).sum(-2) * X).sum(-1)
    lead = X.shape[: -1 - k]
    rows = X.reshape(lead + (d,))
    Wm = W.reshape(-1, d, d).transpose(0, 1).reshape(d, -1)
    Z = (rows @ Wm).reshape(lead + (Wm.shape[-1] // d, d))
    return (Z * rows[..., None, :]).sum(-1).reshape(lead + W.shape[:-2])


SCATTER_CHUNK = 4096  # samples a GEMM of ``_scatter_dot`` reduces over


def _scatter_dot(A, B, ns):
    """``sum over the ns leading dims of A[..., :, None] * B[..., None, :]``
    (A and B broadcast against each other) as batched matmuls over the
    other dims.  The samples are cut into chunks of SCATTER_CHUNK, one GEMM
    a chunk and component, then summed: one GEMM a component reducing all
    the samples into a d x d tile runs on a handful of SMs (GMM-core's
    16 x (8 x 200000) @ (200000 x 8): 6.7 ms on an H100)."""
    shape = torch.broadcast_shapes(A.shape, B.shape)
    rest, d = tuple(shape[ns:-1]), shape[-1]
    R = 1
    for r in rest:
        R *= r
    A = A.expand(shape).reshape(-1, R, d)
    B = B.expand(shape).reshape(-1, R, d)
    S = A.shape[0]
    if S == 0:  # no samples (a rank holding no rows of a time axis)
        return A.new_zeros(rest + (d, d))
    C = -(-S // SCATTER_CHUNK)
    if C > 1:
        pad = C * SCATTER_CHUNK - S
        A = torch.nn.functional.pad(A, (0, 0, 0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
    A = A.reshape(C, -1, R, d).permute(0, 2, 3, 1)  # (C, R, d, chunk)
    B = B.reshape(C, -1, R, d).permute(0, 2, 1, 3)  # (C, R, chunk, d)
    return (A @ B).sum(0).reshape(rest + (d, d))


# Completes a sum over the samples that parallel.data_parallel_update, or a
# time-sharded sweep (parallel.seq_parallel.time_sweep), has split across
# processes: set for the length of their sweeps, None otherwise.
BATCH_REDUCE = None


def batch_sum(*xs):
    """``xs``, sums over the samples this process holds (its rows of time
    and its block of the batch), completed over every process's: inside
    ``parallel.data_parallel_update`` or a time-sharded sweep one
    all_reduce of their flattened concatenation, outside them ``xs`` as
    they are.  Each model calls it once where it forms a site's
    statistics, before an M-step or the ELBO reads them.  A value that
    every process of the time axis holds alike (a chain-end statistic)
    enters it on one process only."""
    global _BATCH_SUMS
    _BATCH_SUMS += 1
    return xs if BATCH_REDUCE is None else BATCH_REDUCE(xs)


_BATCH_SUMS = 0  # batch_sum calls so far


@contextlib.contextmanager
def completes_sums(node):
    """A block that updates ``node`` from sums over the samples.  Where a
    sweep splits the samples across processes (``BATCH_REDUCE`` set), it
    raises ``NotImplementedError`` unless the block formed its sums through
    ``batch_sum``: a node that sums on its own would update each process
    from its own part."""
    before = _BATCH_SUMS
    yield
    if BATCH_REDUCE is not None and _BATCH_SUMS == before:
        raise NotImplementedError(
            f"{type(node).__name__} forms its sums over the samples without batch_sum, so "
            f"a sweep that splits the samples across processes cannot update it")


def centered_scatter(X, pv, sdims):
    """Weighted scatter sums (SExx, SEx, N) in the two-pass centered form
    ``sum_s p_s (x-c)(x-c)^T + N c c^T``, which keeps float32 accurate for
    data with large means; the rank-1 sum is one batched matmul.

    X:  sample + batch + (d,);  pv: weights broadcastable against X, or None;
    sdims: the leading sample axes to reduce over."""
    ns = len(sdims)
    if pv is None:
        SEx = X.sum(sdims)
        nsamp = 1.0
        for d in sdims:
            nsamp = nsamp * X.shape[d]
        c = SEx / nsamp
        Xc = X - c
        SExx = _scatter_dot(Xc, Xc, ns) + nsamp * (c[..., :, None] * c[..., None, :])
        return SExx, SEx, None
    N = pv.sum(sdims)
    SEx = (X * pv).sum(sdims)
    c = SEx / torch.clamp(N, min=1e-20)
    Xc = X - c
    SExx = _scatter_dot(Xc * pv, Xc, ns) + N[..., None] * (c[..., :, None] * c[..., None, :])
    return SExx, SEx, N


class NoCardError(RuntimeError):
    """An entry point was built without a device on a host with no CUDA
    card."""


def default_device(device=None):
    """The device an entry point builds on: ``device`` when given, else the
    card.  With no card and no ``device`` it raises ``NoCardError``: the
    port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoCardError(
            "no CUDA card: the port builds on the card by default; pass "
            "device='cpu' to build on the CPU"
        )
    return torch.device("cuda")


def as_tensor(x, dtype=None, device=None):
    """A floating tensor of ``dtype`` (default: torch's default dtype)."""
    return torch.as_tensor(
        x, dtype=dtype or torch.get_default_dtype(), device=device
    )


def uniform(shape, generator, like):
    """U[0,1) draws from ``generator``, made in float64 on the CPU so a seed
    gives the same numbers on every device, then cast like ``like``."""
    x = torch.rand(tuple(shape), generator=generator, dtype=torch.float64)
    return x.to(dtype=like.dtype, device=like.device)


def normal(shape, generator, like):
    """N(0,1) draws, made like ``uniform``."""
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float64)
    return x.to(dtype=like.dtype, device=like.device)


def require_whole_state(model):
    """Raise ``ValueError`` where ``model`` holds this process's chunk of a
    time-sharded update (``time_chunk`` set) or its block of a MixLDS's
    systems (``system_block`` set): a state exporter would write a part of
    its state as the whole.  ``parallel.gather_posterior(model)``, called on
    every rank, makes the state whole."""
    held = ("chunk of a time-sharded update" if getattr(model, "time_chunk", None) is not None
            else "systems of a split over a 'model' axis"
            if getattr(model, "system_block", None) is not None else None)
    if held is not None:
        raise ValueError(
            f"this {type(model).__name__} holds its rank's {held}; "
            f"call parallel.gather_posterior(model) on every rank first")
