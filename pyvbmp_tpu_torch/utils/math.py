"""Numerics helpers (counterpart of pyvbmp_tpu/utils/math.py)."""
from __future__ import annotations

import math

import torch

LOG2PI = 1.8378770664093453  # log(2*pi)
LOG2 = 0.6931471805599453


def stable_logsumexp(x, dims, keepdim=False):
    """logsumexp over (possibly multiple) axes with max-shift stabilization;
    an all -inf slice gives -inf, not NaN."""
    if isinstance(dims, int):
        dims = (dims,)
    dims = tuple(dims)
    xmax = x.amax(dim=dims, keepdim=True)
    xmax = torch.where(torch.isfinite(xmax), xmax, torch.zeros_like(xmax))
    out = xmax + torch.log(torch.exp(x - xmax).sum(dim=dims, keepdim=True))
    if not keepdim:
        nd = x.ndim
        for d in sorted((d % nd for d in dims), reverse=True):
            out = out.squeeze(d)
    return out


def mvgammaln(nu, dim):
    """Multivariate log-gamma."""
    i = torch.arange(dim, dtype=nu.dtype, device=nu.device) / 2.0
    return torch.lgamma(nu[..., None] - i).sum(-1) + (
        dim * (dim - 1) / 4.0
    ) * math.log(math.pi)


def mvdigamma(nu, dim):
    """Multivariate digamma."""
    i = torch.arange(dim, dtype=nu.dtype, device=nu.device) / 2.0
    return torch.digamma(nu[..., None] - i).sum(-1)


# Masked lgamma/digamma for the Dirichlet KL, where alpha may hold zeros from
# transition masks.  The masks are written as where()s on the argument, as the
# JAX package writes them, so neither library's value at 0 is relied on
# (torch's digamma(0) is -inf, JAX's is NaN).

def lgamma_masked(x):
    out = torch.lgamma(x)
    return torch.where(torch.isinf(out), torch.zeros_like(out), out)


def digamma_masked(x):
    out = torch.digamma(x)
    return torch.where(x > 0, out, torch.zeros_like(out))


def stable_softmax(x, dims):
    """log-softmax over ``dims`` (the reference's name notwithstanding)."""
    return x - stable_logsumexp(x, dims, keepdim=True)


def mvpolygamma1(nu, dim):
    """Sum of trigammas: d/dnu mvdigamma (WishartUnitDet's Newton step)."""
    i = torch.arange(dim, dtype=nu.dtype, device=nu.device) / 2.0
    return torch.polygamma(1, nu[..., None] - i).sum(-1)
