"""Plane layout for the smoothers' small matrices (counterpart of
pyvbmp_tpu/ops/planemat.py).

A matrix is ONE tensor of shape ``(..., h, w, N)``: each matrix entry is a
plane over the flattened batch N, which is the minor axis.  This is the
layout the scan kernels read (neighbouring threads on neighbouring n), and
the port keeps it at the public functions so it compares like with like
with the JAX package.  The algebra here is plain PyTorch: the plain combines
and the post-scan algebra use it.

Layout conventions (all functions):
  matrix  (..., h, w, N)   - matrix dims on axes -3, -2; lanes on -1
  vector  (..., h, N)
  scalar  (..., N)
"""
from __future__ import annotations

import torch


def bT(A):
    """Matrix transpose in plane layout."""
    return A.transpose(-3, -2)


def bmm(A, B, t_a=False, t_b=False):
    """op(A) @ op(B)."""
    if t_a:
        A = bT(A)
    if t_b:
        B = bT(B)
    return (A[..., :, :, None, :] * B[..., None, :, :, :]).sum(-3)


def bmv(A, x, t_a=False):
    """op(A) @ x for a plane matrix and a plane vector."""
    if t_a:
        A = bT(A)
    return (A * x[..., None, :, :]).sum(-2)


def bvdot(x, y):
    return (x * y).sum(-2)


def bsym(A):
    return 0.5 * (A + bT(A))


def pack(A):
    """(T,) + bshape + (h, w) dense -> contiguous (T, h, w, N)."""
    T, h, w = A.shape[0], A.shape[-2], A.shape[-1]
    return A.reshape(T, -1, h, w).permute(0, 2, 3, 1).contiguous()


def unpack(A, bshape):
    """(T, h, w, N) -> (T,) + bshape + (h, w)."""
    T, h, w = A.shape[0], A.shape[1], A.shape[2]
    return A.permute(0, 3, 1, 2).reshape((T,) + tuple(bshape) + (h, w))


def pack_vec(x):
    """(T,) + bshape + (h, 1) -> contiguous (T, h, N)."""
    T, h = x.shape[0], x.shape[-2]
    return x.reshape(T, -1, h).permute(0, 2, 1).contiguous()


def unpack_vec(x, bshape):
    T, h = x.shape[0], x.shape[1]
    return x.permute(0, 2, 1).reshape((T,) + tuple(bshape) + (h, 1))


def bsym_inv_and_logdet(A):
    """Inverse + logdet of a symmetric PD plane matrix (..., h, h, N), from
    one batched Cholesky factor (the JAX package's Schur split existed to
    suit the TPU's layout).  As in the JAX package, a factorization that
    fails raises no error (``cholesky_ex``), so the card never waits on a
    check."""
    L = torch.linalg.cholesky_ex(A.movedim(-1, -3)).L
    inv = torch.cholesky_inverse(L)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    return inv.movedim(-3, -1), logdet
