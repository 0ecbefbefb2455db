"""Batched dense linear algebra (counterpart of pyvbmp_tpu/utils/linalg.py).

Every PSD operation goes through one batched Cholesky factor, taken with
``cholesky_ex``: as in the JAX package, a factorization that fails raises no
error, and the card never waits on a check.  The inverses go through
``ops/spd_inverse.py`` (on the card, one kernel for n <= 32).  The JAX
package's straight-line Schur inverses (``sym_*``) and their matmul-precision
pins were TPU workarounds; the port has only the Cholesky path.
"""
from __future__ import annotations

import functools
import math

import torch

from ..config import PSD_JITTER


def mT(A):
    return A.transpose(-1, -2)


def _sym(A):
    return 0.5 * (A + mT(A))


def matvec(M, v):
    """``M @ v`` for matrices M (..., a, b) and columns v (..., b, 1) as a
    broadcast product and a sum.  ``torch.matmul`` sends a stack that
    broadcasts a parameter over the data's axes to cuBLAS's batched GEMM as
    one tiny problem an entry: a MixLDS sweep's 6.4 million (T x batch x
    systems) 2 x 1 by 1 x 1 products took ~6 ms a call on one H100."""
    return (M * mT(v)).sum(-1, keepdim=True)


def bilinear(u, M, v):
    """``(mT(u) @ M @ v)[..., 0, 0]`` for columns u (..., a, 1), v (..., b,
    1) and matrices M (..., a, b), as a broadcast product and a sum
    (``matvec``)."""
    return (u * M * mT(v)).sum((-1, -2))


class ProductRoutes:
    """``product``'s calls by the route each took: ``broadcast`` (a
    broadcast product and a sum), ``folded_gemm`` (one GEMM a parameter
    batch, the data's axes folded into its rows or columns) and ``matmul``
    (``torch.matmul``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.broadcast = self.folded_gemm = self.matmul = 0

    def counts(self):
        return {"broadcast": self.broadcast, "folded_gemm": self.folded_gemm,
                "matmul": self.matmul}


PRODUCTS = ProductRoutes()

# A batch of at most this many problems has no data axes: a parameter
# batch, as in the M-step's products.
MATMUL_MAX_BATCH = 64
# A broadcast product may hold at most this many times the elements of its
# operands and its result.
BROADCAST_MAX_RATIO = 4


def product(A, B):
    """``A @ B`` for stacks of small matrices whose batch may be the data's
    axes (time, batch, objects, roles).  ``torch.matmul`` hands such a stack
    to cuBLAS's batched GEMM as one tiny problem an entry: DMBD's 2 x 2 by
    2 x 1 products over 4.8 million (time, batch, object, role) entries took
    ~4 ms a call on one H100.  The route is read from the operands' shapes
    and strides alone (``_route``):

    - a batch of at most MATMUL_MAX_BATCH problems, a parameter batch:
      ``torch.matmul``;
    - an outer product (one contracted term): the broadcast product, bit
      for bit the matmul's;
    - operands that vary together over at most MATMUL_MAX_BATCH entries, so
      that one of them is constant over the data's axes: one GEMM a shared
      entry, the data's axes folded into its rows or columns (``_folded``);
    - operands that vary together over the data's axes: a broadcast product
      and a sum, unless it would hold more than BROADCAST_MAX_RATIO times
      the elements of its operands and result, which then take
      ``torch.matmul``."""
    route, plan = _route(A.shape, A.stride(), B.shape, B.stride())
    setattr(PRODUCTS, route, getattr(PRODUCTS, route) + 1)
    if route == "matmul":
        return A @ B
    if route == "folded_gemm":
        return _folded(A, B, plan)
    if plan == "outer":
        return A * B
    if plan == "matvec":
        return matvec(A, B)
    if plan == "row":
        return (mT(A) * B).sum(-2, keepdim=True)
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def outer(u, v):
    """``u @ mT(v)`` for columns u (..., a, 1) and v (..., b, 1)
    (``product``)."""
    return product(u, mT(v))


def _varies(shape, stride, ndim):
    """Per batch dim of a tensor, counted from the left of ``ndim`` batch
    dims: whether it holds more than one value along it (size > 1, stride
    != 0)."""
    pad = ndim - (len(shape) - 2)
    return (False,) * pad + tuple(s > 1 and st != 0 for s, st in zip(shape[:-2], stride[:-2]))


@functools.lru_cache(maxsize=1024)
def _route(a_shape, a_stride, b_shape, b_stride):
    """(route, plan) of ``product`` for operands of these shapes and
    strides: the route's name (a ``ProductRoutes`` count) and what it
    computes, the broadcast product's form or ``_fold_plan``'s plan."""
    a, b = a_shape[:-2], b_shape[:-2]
    L = max(len(a), len(b))
    a, b = (1,) * (L - len(a)) + tuple(a), (1,) * (L - len(b)) + tuple(b)
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        raise ValueError(f"product: batch shapes {a} and {b} do not broadcast")
    S = tuple(y if x == 1 else x for x, y in zip(a, b))
    m, k, n = a_shape[-2], a_shape[-1], b_shape[-1]
    N = math.prod(S)
    if N <= MATMUL_MAX_BATCH:
        return "matmul", None
    if k == 1:
        return "broadcast", "outer"
    va, vb = _varies(a_shape, a_stride, L), _varies(b_shape, b_stride, L)
    if math.prod(s for s, x, y in zip(S, va, vb) if x and y) <= MATMUL_MAX_BATCH:
        return "folded_gemm", _fold_plan(S, va, vb, a_shape, b_shape)
    held = (math.prod(s for s, x in zip(S, va) if x) * m * k
            + math.prod(s for s, y in zip(S, vb) if y) * k * n + N * m * n)
    if N * m * k * n > BROADCAST_MAX_RATIO * held:
        return "matmul", None
    return "broadcast", "matvec" if n == 1 else "row" if m == 1 else "full"


def _fold_plan(S, va, vb, a_shape, b_shape):
    """How ``_folded`` lays out ``A @ B``: the batch dims both operands
    vary along (g) index the GEMMs, those only A varies along (pa) join its
    rows, those only B varies along (pb) its columns.  The GEMM writes into
    the result's own layout (batch dims in order, then m, n) where that is
    a view of its (G, rows, columns) output, else into its own, permuted
    back; either way the result is expanded over the dims neither varies
    along."""
    L = len(S)
    m, k, n = a_shape[-2], a_shape[-1], b_shape[-1]
    g = [d for d in range(L) if va[d] and vb[d]]
    pa = [d for d in range(L) if va[d] and not vb[d]]
    pb = [d for d in range(L) if vb[d] and not va[d]]
    ones = [d for d in range(L) if not (va[d] or vb[d])]
    G, Pa, Pb = (math.prod(S[d] for d in dims) for dims in (g, pa, pb))
    gemm = (G, Pa * m, Pb * n)
    order = ones + g + pa + [L] + pb + [L + 1]
    shape = tuple(1 if d in ones else S[d] for d in range(L)) + (m, n)
    try:  # is the GEMM's output a view of the result's layout?
        torch.empty(shape, device="meta").permute(order).view(gemm)
    except RuntimeError:
        shape = None
    return dict(
        a=_cut(a_shape, va), a_perm=[d for d in range(L) if not va[d]] + g + pa + [L, L + 1],
        a_gemm=(G, Pa * m, k),
        b=_cut(b_shape, vb), b_perm=[d for d in range(L) if not vb[d]] + g + [L] + pb + [L + 1],
        b_gemm=(G, k, Pb * n),
        gemm=gemm, shape=shape, order=order, perm=[order.index(d) for d in range(L + 2)],
        unpermuted=[1] * len(ones) + [S[d] for d in g + pa] + [m] + [S[d] for d in pb] + [n],
        S=tuple(S) + (m, n))


def _cut(shape, varies):
    """(leading dims to add, dims to cut to size 1) that give an operand of
    this shape all ``len(varies)`` batch dims, with one value along each
    dim it does not vary along."""
    pad = len(varies) + 2 - len(shape)
    full = (1,) * pad + tuple(shape)
    return pad, [d for d, v in enumerate(varies) if not v and full[d] > 1]


def _folded(A, B, plan):
    """``A @ B`` as one GEMM for each entry of the batch dims along which
    both vary (``_fold_plan``); A and B are read once where they do not
    vary."""
    ops = []
    for x, (pad, cut), perm, gemm in ((A, plan["a"], plan["a_perm"], plan["a_gemm"]),
                                      (B, plan["b"], plan["b_perm"], plan["b_gemm"])):
        if pad:
            x = x[(None,) * pad]
        for d in cut:
            x = x.narrow(d, 0, 1)
        ops.append(x.permute(perm).reshape(gemm))
    if plan["shape"] is not None:
        out = A.new_empty(plan["shape"])
        torch.matmul(*ops, out=out.permute(plan["order"]).view(plan["gemm"]))
    else:
        out = (ops[0] @ ops[1]).view(plan["unpermuted"]).permute(plan["perm"])
    return out.expand(plan["S"])


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
