"""Scan-based HMM smoother in plane layout (counterpart of
pyvbmp_tpu/ops/parallel_hmm.py, plane form).

The forward-backward is one prefix and one suffix scan of the (log,+) matrix
semiring over the per-step elements M_t[i, j] = trans[i, j] + obs_t[j], laid
out as (T, K, K, N) with the flattened batch N minor.  The scans go through
``ops.scan.logsemiring_scan``: the CUDA kernel for tensors on the card, the
plain fold of ``_logmatmul_plane`` on the CPU.  The input-driven smoother
(``driven_forward_backward_parallel``) runs the same core on per-time
transition logits, M_t[i, j] = trans_t[i, j] + obs_t[j].
"""
from __future__ import annotations

import torch

from ..utils import math as um
from . import scan


def _logmatmul_plane(a, b):
    """(log,+) matmul in plane layout (..., K, K, N) with the -inf guard:
    an all -inf sum stays -inf."""
    terms = a[..., :, :, None, :] + b[..., None, :, :, :]  # (..., i, m, j, N)
    m = terms.amax(-3)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(terms - m[..., :, None, :, :]).sum(-3)
    return m + torch.log(s)


def _hmm_plane_core(M, init_logits, ptemp):
    """Returns (p, xi (T,)+b+(K,K), SEz0, logZ) given the semiring elements
    M (T,)+bshape+(K,K)."""
    T, K = M.shape[0], M.shape[-1]
    bshape = M.shape[1:-2]

    Mp = M.reshape(T, -1, K, K).permute(0, 2, 3, 1).contiguous()  # (T, K, K, N)
    N = Mp.shape[-1]
    ivec = init_logits.expand(bshape + (K,)).reshape(N, K).T  # (K, N)

    prefix = scan.logsemiring_scan(Mp)
    suffix = scan.logsemiring_scan(Mp, reverse=True)

    alpha = um.stable_logsumexp(ivec[None, :, None, :] + prefix, -3)  # (T, K, N)
    logZ = um.stable_logsumexp(alpha[-1], 0)  # (N,)
    alpha = alpha - logZ

    beta = um.stable_logsumexp(suffix, -2)  # (T, K, N)
    beta_t = torch.cat([beta[1:], torch.zeros_like(beta[:1])], 0)

    smoothed = alpha + beta_t
    smoothed = smoothed - um.stable_logsumexp(smoothed, -2, keepdim=True)

    alpha_prev = torch.cat([ivec[None], alpha[:-1]], 0)
    xi = alpha_prev[..., :, None, :] + Mp + beta_t[..., None, :, :]
    xin = um.stable_logsumexp(xi.reshape(T, K * K, N), -2)  # (T, N)
    xi = torch.exp(xi - xin[..., None, None, :])

    mx = smoothed.amax(-2, keepdim=True)
    p = torch.exp((smoothed - mx) / ptemp)
    p = p / p.sum(-2, keepdim=True)

    p_d = p.permute(0, 2, 1).reshape((T,) + bshape + (K,))
    xi_d = xi.permute(0, 3, 1, 2).reshape((T,) + bshape + (K, K))
    SEz0 = xi_d[0].sum(-1)
    logZ_d = logZ.reshape(bshape)
    return p_d, xi_d, SEz0, logZ_d


def forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp=1.0):
    """Same contract as pyvbmp_tpu.ops.parallel_hmm.forward_backward_parallel.

    trans_logits: batch + (K, K)
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p (T,)+sample+batch+(K,), SEzz sample+batch+(K,K),
    SEz0 sample+batch+(K,), logZ sample+batch).
    """
    M = trans_logits + obs_logits[..., None, :]
    p, xi, SEz0, logZ = _hmm_plane_core(M, init_logits, ptemp)
    return p, xi.sum(0), SEz0, logZ


def driven_forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp=1.0):
    """Same contract as
    pyvbmp_tpu.ops.parallel_hmm.driven_forward_backward_parallel (plane form):
    the input-driven smoother, with per-time transition logits.

    trans_logits: (T,) + sample + batch + (K, K)
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p (T,)+sample+batch+(K,), SEzz (T,)+sample+batch+(K,K),
    SEz0 sample+batch+(K,), logZ sample+batch).  The pairwise statistics
    stay per time step: the MNLR transition's M-step needs SEzz[t].
    """
    M = trans_logits + obs_logits[..., None, :]
    return _hmm_plane_core(M, init_logits, ptemp)
