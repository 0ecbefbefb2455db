"""Node plumbing and contraction helpers shared by the distributions,
transforms and models (counterpart of pyvbmp_tpu/utils/jaxutils.py).

Every parameter node is an immutable dataclass of tensors and sub-nodes:
``ss_update`` and friends return a new node (as in the JAX package), and the
model shells re-assign the returned nodes.  ``Node.to`` moves a whole node
tree to a device and a floating dtype.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch


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
        return dataclasses.replace(self, **changes)


def replace(n, **changes):
    """dataclasses.replace for nodes."""
    return dataclasses.replace(n, **changes)


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
    message with a parameter stack."""
    return (X * W).sum((-1, -2))


def brole_avg(M, p):
    """``sum_k p[..., k] * M[..., k, :, :]``: the role average of
    per-role matrix messages."""
    return torch.einsum("...kij,...k->...ij", M, p)


def bquad(X, W):
    """Per-component quadratic form ``x^T W_k x``: X is (..., d) with
    broadcast 1s at W's batch positions, W is (B..., d, d)."""
    return ((X[..., None] * W).sum(-2) * X).sum(-1)


def centered_scatter(X, pv, sdims):
    """Weighted scatter sums (SExx, SEx, N) in the two-pass centered form
    ``sum_s p_s (x-c)(x-c)^T + N c c^T``, which keeps float32 accurate for
    data with large means.

    X:  sample + batch + (d,);  pv: weights broadcastable against X, or None;
    sdims: the sample axes to reduce over."""
    if pv is None:
        SEx = X.sum(sdims)
        nsamp = 1.0
        for d in sdims:
            nsamp = nsamp * X.shape[d]
        c = SEx / nsamp
        Xc = X - c
        SExx = (Xc[..., :, None] * Xc[..., None, :]).sum(sdims) + nsamp * (
            c[..., :, None] * c[..., None, :]
        )
        return SExx, SEx, None
    N = pv.sum(sdims)
    SEx = (X * pv).sum(sdims)
    c = SEx / torch.clamp(N, min=1e-20)
    Xc = X - c
    SExx = ((Xc * pv)[..., :, None] * Xc[..., None, :]).sum(sdims) + N[
        ..., None
    ] * (c[..., :, None] * c[..., None, :])
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
