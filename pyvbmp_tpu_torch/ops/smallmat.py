"""Component ("lane") form algebra for tiny h <= 3 matrices (counterpart of
pyvbmp_tpu/ops/smallmat.py).

The JAX package holds each matrix entry as a separate ``(T, N)`` array in a
dict; the port packs the entries of one matrix into ONE tensor whose
component axis is -2 and whose flattened batch N is the minor axis:

    symmetric h x h   (..., h(h+1)/2, N)  upper triangle, row-major, in
                                          ``sym_idx`` order
    general h x w     (..., h*w, N)       row-major
    vector h          (..., h, N)         index order

The component order is the order of ``jax.tree_util.tree_leaves`` on the
JAX dicts, so packed leaves and JAX leaves line up one to one.  This is the
layout the lane scan kernel (``csrc/kalman_lane_scan.cu``) reads.

The algebra is straight-line elementwise code over component slices, with
the JAX package's association order.  The symmetric inverse is the
closed-form adjugate (h <= 3), as in the JAX package; the lane form serves
only h <= 3, larger h takes the plane form (``ops/planemat.py``).
"""
from __future__ import annotations

import math

import torch


def sym_idx(h):
    """Pairs (i, j), i<=j, in row-major upper-triangle order."""
    return [(i, j) for i in range(h) for j in range(i, h)]


def sym_pos(h, i, j):
    """Position of entry (i, j) (either triangle) in the packed order."""
    if i > j:
        i, j = j, i
    return i * h - i * (i - 1) // 2 + (j - i)


def _entry(A, h, i, j, sym, t):
    if t:
        i, j = j, i
    k = sym_pos(h, i, j) if sym else i * h + j
    return A[..., k, :]


# ------------------------------------------------------------- pack / unpack
def _pack(A, idx):
    """(T,) + bshape + (h, w) dense -> contiguous (T, len(idx), N)."""
    T, h, w = A.shape[0], A.shape[-2], A.shape[-1]
    flat = A.reshape(T, math.prod(A.shape[1:-2]), h * w)[..., idx]
    return flat.permute(0, 2, 1).contiguous()


def _unpack(A, idx, bshape, h, w):
    """(..., C, N) packed -> (...,) + bshape + (h, w) dense."""
    full = A[..., idx, :].movedim(-1, -2)
    return full.reshape(tuple(A.shape[:-2]) + tuple(bshape) + (h, w))


def sym_pack(A):
    h = A.shape[-1]
    return _pack(A, [i * h + j for i, j in sym_idx(h)])


def sym_unpack(A, h, bshape):
    idx = [sym_pos(h, i, j) for i in range(h) for j in range(h)]
    return _unpack(A, idx, bshape, h, h)


def gen_pack(A):
    return _pack(A, list(range(A.shape[-2] * A.shape[-1])))


def gen_unpack(A, h, bshape):
    return _unpack(A, list(range(h * h)), bshape, h, h)


def vec_pack(v):
    """(T,) + bshape + (h, 1) -> contiguous (T, h, N)."""
    return _pack(v, list(range(v.shape[-2])))


def vec_unpack(v, bshape):
    return _unpack(v, list(range(v.shape[-2])), bshape, v.shape[-2], 1)


# ------------------------------------------------------------------ algebra
def mm(h, A, B, sym_a=False, sym_b=False, t_a=False, t_b=False, sym_out=False):
    """C = op(A) @ op(B) for h x h component matrices.

    ``sym_out=True`` computes only the upper triangle (the caller asserts
    the product is symmetric) and returns it packed symmetric."""
    out = []
    for i in range(h):
        for j in range(i if sym_out else 0, h):
            out.append(sum(
                _entry(A, h, i, m, sym_a, t_a) * _entry(B, h, m, j, sym_b, t_b)
                for m in range(h)
            ))
    return torch.stack(out, -2)


def mv(h, A, x, sym_a=False, t_a=False):
    """op(A) @ x for a component matrix and a component vector."""
    return torch.stack([
        sum(_entry(A, h, i, m, sym_a, t_a) * x[..., m, :] for m in range(h))
        for i in range(h)
    ], -2)


def vdot(x, y):
    return sum(x[..., k, :] * y[..., k, :] for k in range(x.shape[-2]))


def sym_add(A, B):
    return A + B


def sym_sub(A, B):
    return A - B


def sym_inv_and_logdet(h, A):
    """Inverse + logdet of a symmetric PD component matrix: the closed-form
    adjugate, as pyvbmp_tpu/ops/smallmat.py computes it for h <= 3."""
    c = [A[..., k, :] for k in range(A.shape[-2])]
    if h == 1:
        det = c[0]
        return (1.0 / det)[..., None, :], torch.log(det)
    if h == 2:
        a, b, d = c
        det = a * d - b * b
        return torch.stack([d / det, -b / det, a / det], -2), torch.log(det)
    if h == 3:
        a, b, cc, e, f, i = c
        A11 = e * i - f * f
        A12 = -(b * i - cc * f)
        A13 = b * f - cc * e
        A22 = a * i - cc * cc
        A23 = -(a * f - cc * b)
        A33 = a * e - b * b
        det = a * A11 + b * A12 + cc * A13
        inv = [A11 / det, A12 / det, A13 / det, A22 / det, A23 / det, A33 / det]
        return torch.stack(inv, -2), torch.log(det)
    raise ValueError(f"the lane form serves h <= 3, got h={h}")
