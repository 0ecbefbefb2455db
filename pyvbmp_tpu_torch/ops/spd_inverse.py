"""Batched inverse and log-determinant of small symmetric positive-definite
matrices: one CUDA kernel and its plain PyTorch version.  No TPU kernel
stands behind it; in the JAX package these inverses are XLA's.

``spd_inverse(A, ...)`` dispatches on what A shows.  A CUDA float32 tensor
with 1 <= n <= 32 launches ``csrc/spd_inverse.cu``: one launch, no
allocation beyond its outputs, no host sync.  Any other CUDA tensor (n > 32,
another dtype) takes the library route, ``cholesky_ex`` then
``cholesky_inverse``, which is also the plain version every non-CUDA tensor
takes.  There is no fallback from one to the other.

Two layouts: dense ``(..., n, n)`` and plane ``(..., n, n, N)`` (lanes on
the minor axis, ``ops/planemat.py``).  The kernel reads either in place from
its strides and writes its result as the library route lays it out
(``output``), so the callers' reshapes stay views.
"""
from __future__ import annotations

import math

import torch

from ..utils import linalg
from ._cuda import load_library

MAX_N = 32  # the largest n the kernel takes (csrc/spd_inverse.cu)


def spd_inverse_plain(A, plane=False, symmetrize=False, logdet=False):
    """(inverse, log-determinant or None) from one Cholesky factor and
    ``cholesky_inverse``: with ``symmetrize`` ``linalg.chol``'s, of (A +
    A^T) / 2 plus its jitter; else ``cholesky_ex``'s of A's lower triangle."""
    if plane:
        A = A.movedim(-1, -3)
    L = linalg.chol(A) if symmetrize else torch.linalg.cholesky_ex(A).L
    inv = torch.cholesky_inverse(L)
    ld = linalg._logdet_from_chol(L) if logdet else None
    return (inv.movedim(-3, -1) if plane else inv), ld


def output(A, plane):
    """The inverse's tensor for A, laid out as the library route returns it:
    dense contiguous; plane a (..., n, n, N) view of (..., N, n, n), each
    matrix contiguous."""
    if plane:
        shape = A.shape[:-3] + A.shape[-1:] + A.shape[-3:-1]
        return torch.empty(shape, dtype=A.dtype, device=A.device).movedim(-3, -1)
    return torch.empty(A.shape, dtype=A.dtype, device=A.device)


def _coalesce(sizes, strides_in, strides_out):
    """The batch dims as few (size, in stride, out stride) as address the
    same entries: size-1 dims dropped, neighbours merged where both tensors
    step over them as over one."""
    dims = [d for d in zip(sizes, strides_in, strides_out) if d[0] != 1]
    merged = []
    for size, si, so in dims:
        if merged:
            psize, psi, pso = merged[-1]
            if psi == si * size and pso == so * size:
                merged[-1] = (psize * size, si, so)
                continue
        merged.append((size, si, so))
    return merged


def _batch_dims(A, out, plane):
    """(sizes, input strides, output strides) of the batch: the leading dims,
    and in the plane layout the lanes after the matrix dims."""
    def pick(x):
        s = x.stride()
        return s[:-3] + s[-1:] if plane else s[:-2]

    sizes = A.shape[:-3] + A.shape[-1:] if plane else A.shape[:-2]
    return sizes, pick(A), pick(out)


def batch_args(A, out, plane):
    """(A, (lanes, in strides b, l, row, column), (out strides b, l, row,
    column)): the kernel's view of the batch as matrix g = b * lanes + l,
    in the row-major order of the batch dims.  A comes back as a contiguous
    copy where its batch does not merge into two dims."""
    rows, cols = (-3, -2) if plane else (-2, -1)
    dims = _coalesce(*_batch_dims(A, out, plane))
    if len(dims) > 2:  # a contiguous copy's batch merges to (outer, lanes)
        A = A.contiguous()
        dims = _coalesce(*_batch_dims(A, out, plane))
    (_, sb, ob), (lanes, sl, ol) = ([(1, 0, 0)] * 2 + dims)[-2:]
    return (A, (lanes, sb, sl, A.stride(rows), A.stride(cols)),
            (ob, ol, out.stride(rows), out.stride(cols)))


class SPDInverse:
    """The kernel, its plain version and their counts: ``launches`` counts
    kernel launches, ``plain_calls`` runs of the plain version on a non-CUDA
    tensor, ``library_calls`` CUDA calls that take the library route
    (n > 32 or a dtype other than float32)."""

    name = "spd_inverse"
    symbol = "spd_inverse_f32"
    source = "pyvbmp_tpu_torch/csrc/spd_inverse.cu"
    replaces = "none (XLA's Cholesky and triangular solves in pyvbmp_tpu)"

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0
        self.library_calls = 0

    def __call__(self, A, plane=False, symmetrize=False, logdet=False):
        if A.device.type != "cuda":
            self.plain_calls += 1
            return spd_inverse_plain(A, plane, symmetrize, logdet)
        if A.dtype != torch.float32 or not 1 <= A.shape[-2] <= MAX_N:
            self.library_calls += 1
            return spd_inverse_plain(A, plane, symmetrize, logdet)
        return self.kernel(A, plane, symmetrize, logdet)

    def kernel(self, A, plane=False, symmetrize=False, logdet=False):
        """One launch on a CUDA float32 A (``__call__`` routes only those
        here; the C entry point refuses n outside 1..32)."""
        rows, cols = (-3, -2) if plane else (-2, -1)
        if A.ndim < (3 if plane else 2) or A.shape[rows] != A.shape[cols]:
            raise ValueError(
                f"{self.name}: want square {'(..., n, n, N)' if plane else '(..., n, n)'} "
                f"matrices, got {tuple(A.shape)}"
            )
        n = A.shape[rows]
        jitter = linalg.PSD_JITTER if symmetrize else 0.0
        out = output(A, plane)
        sizes, _, _ = _batch_dims(A, out, plane)
        ld = torch.empty(sizes, dtype=torch.float32, device=A.device) if logdet else None
        count = math.prod(sizes)
        if count == 0:
            return out, ld
        A, a_args, out_args = batch_args(A, out, plane)
        lib = load_library()
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream(A.device).cuda_stream
            rc = getattr(lib, self.symbol)(
                A.data_ptr(), out.data_ptr(), None if ld is None else ld.data_ptr(),
                n, count, *a_args, *out_args, int(symmetrize), jitter, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        self.launches += 1
        return out, ld


SPD_INVERSE = SPDInverse()


def spd_inverse(A, plane=False, symmetrize=False, logdet=False):
    """(A^-1, log det A or None) for a batch of SPD matrices, dense (...,
    n, n) or, with ``plane``, (..., n, n, N).  ``symmetrize`` inverts what
    ``utils/linalg.py:chol`` factors, (A + A^T) / 2 + PSD_JITTER I;
    otherwise A's lower triangle is read, as ``cholesky_ex`` reads it.  A
    factorization that fails raises nothing."""
    return SPD_INVERSE(A, plane, symmetrize, logdet)
