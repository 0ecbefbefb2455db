"""Batched dense linear algebra (counterpart of pyvbmp_tpu/utils/linalg.py).

Every PSD operation goes through one batched Cholesky factor, taken with
``cholesky_ex``: as in the JAX package, a factorization that fails raises no
error, and the card never waits on a check.  The inverses go through
``ops/spd_inverse.py`` (on the card, one kernel for n <= 32).  The JAX
package's straight-line Schur inverses (``sym_*``) and their matmul-precision
pins were TPU workarounds; the port has only the Cholesky path.
"""
from __future__ import annotations

import torch

from ..config import PSD_JITTER


def mT(A):
    return A.transpose(-1, -2)


def _sym(A):
    return 0.5 * (A + mT(A))


def chol(A):
    """Batched Cholesky of a PSD matrix with optional jitter."""
    if PSD_JITTER:
        A = A + PSD_JITTER * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky_ex(_sym(A)).L


def _bcast(A, B):
    """Broadcast batch dims of A (...,m,m) and B (...,m,k)."""
    bshape = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    return A.expand(bshape + A.shape[-2:]), B.expand(bshape + B.shape[-2:])


def _logdet_from_chol(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def psd_solve(A, B):
    """Solve A X = B for symmetric PD A (batch-broadcasting)."""
    A, B = _bcast(A, B)
    return torch.cholesky_solve(B, chol(A))


def psd_solve_and_logdet(A, B):
    """Solve A X = B and logdet A off one Cholesky factor."""
    A, B = _bcast(A, B)
    L = chol(A)
    return torch.cholesky_solve(B, L), _logdet_from_chol(L)


def psd_inv(A):
    from ..ops.spd_inverse import spd_inverse  # ops imports this module

    return spd_inverse(A, symmetrize=True)[0]


def psd_logdet(A):
    return _logdet_from_chol(chol(A))


def psd_inv_and_logdet(A):
    """Inverse + logdet off one Cholesky factor."""
    from ..ops.spd_inverse import spd_inverse

    return spd_inverse(A, symmetrize=True, logdet=True)


def block_diag_matrix_builder(A, B):
    """[[A,0],[0,B]]."""
    n1, n2 = A.shape[-1], B.shape[-1]
    t_shape = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = A.expand(t_shape + A.shape[-2:])
    B = B.expand(t_shape + B.shape[-2:])
    top = torch.cat([A, A.new_zeros(t_shape + (A.shape[-2], n2))], -1)
    bot = torch.cat([B.new_zeros(t_shape + (B.shape[-2], n1)), B], -1)
    return torch.cat([top, bot], -2)


def block_precision_marginalizer(A, B, C, D):
    """Schur-complement precisions without the final inverse: returns
    (A - B invD C, -B invD, -C invA, D - C invA B)."""
    invA = psd_inv(A)
    invD = psd_inv(D)
    A_prec = A - B @ invD @ C
    D_prec = D - C @ invA @ B
    return A_prec, -B @ invD, -C @ invA, D_prec
