"""Scan-based HMM smoother in plane layout (counterpart of
pyvbmp_tpu/ops/parallel_hmm.py, plane form).

The forward-backward is one prefix and one suffix scan of the (log,+) matrix
semiring over the per-step elements M_t[i, j] = trans[i, j] + obs_t[j], laid
out as (T, K, K, N) with the flattened batch N minor.  The scans go through
``ops.scan.logsemiring_scan``: the CUDA kernel for tensors on the card, the
plain fold of ``_logmatmul_plane`` on the CPU.  The input-driven smoother
(``driven_forward_backward_parallel``) runs the same core on per-time
transition logits, M_t[i, j] = trans_t[i, j] + obs_t[j].  Both take the
steps across time from a ``chain`` (``ops.scan.Chain``): the whole time axis
by default, a time axis cut across processes from
``parallel/seq_parallel.py``.
"""
from __future__ import annotations

import math

import torch

from ..utils import math as um
from ..utils.trace import span
from . import scan


def _logmatmul_plane(a, b):
    """(log,+) matmul in plane layout (..., K, K, N) with the -inf guard:
    an all -inf sum stays -inf."""
    terms = a[..., :, :, None, :] + b[..., None, :, :, :]  # (..., i, m, j, N)
    m = terms.amax(-3)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(terms - m[..., :, None, :, :]).sum(-3)
    return m + torch.log(s)


def _finite_max(x, dim):
    """x's max over ``dim`` (kept), 0 where it is not finite."""
    m = x.amax(dim, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _shift_obs(obs_logits):
    """The observation logits shifted by each step's largest (per lane), and
    the shifts summed over time in float64 (logZ's offset).  Logits of a
    sharp emission run to -1e4 a step: unshifted, float32 rounds the
    transition logits added to them at ~1e-3, and the scanned products grow
    like the log-likelihood, where float32 keeps no O(1) differences (the
    posteriors).  The posteriors do not change."""
    c = _finite_max(obs_logits, -1)
    return obs_logits - c, c[..., 0].sum(0, dtype=torch.float64)


def _hmm_plane_core(M, init_logits, ptemp, offset, chain=scan.CHAIN):
    """Returns (p, xi (T,)+b+(K,K), SEz0, logZ) given the semiring elements
    M (T,)+bshape+(K,K); ``offset`` (bshape, float64) is added to logZ.
    ``chain`` holds the steps across time (``scan.Chain``); on a time axis
    cut across processes M holds this process's rows and ``offset`` their
    part of the time sum."""
    T, K = M.shape[0], M.shape[-1]
    bshape = M.shape[1:-2]
    N = math.prod(bshape)

    Mp = M.reshape(T, N, K, K).permute(0, 2, 3, 1)  # (T, K, K, N)
    ivec = init_logits.expand(bshape + (K,)).reshape(N, K).T  # (K, N)
    # each step's element shifted by its largest entry c_t (per lane): the
    # scanned products then grow like log K a step, not like the
    # transitions' logits; logZ gets sum_t c_t back, in float64
    c = _finite_max(Mp.reshape(T, K * K, N), -2)  # (T, 1, N)
    Mp = (Mp - c[:, None]).contiguous()

    prefix, = chain.scan(scan.LOGSEMIRING, (Mp,))
    suffix, = chain.scan(scan.LOGSEMIRING, (Mp,), reverse=True)

    alpha = um.stable_logsumexp(ivec[None, :, None, :] + prefix, -3)  # (T, K, N)
    logZ = chain.held(um.stable_logsumexp(chain.last(alpha)[0], -2))  # (N,)
    offset = c[:, 0].sum(0, dtype=torch.float64) + offset.reshape(-1)
    logZ = (logZ.double() + offset).to(logZ.dtype)

    beta = um.stable_logsumexp(suffix, -2)  # (T, K, N)
    beta_t, = chain.shift((beta,), up=True)

    # The messages grow like the log-likelihood of the steps behind or
    # ahead; each step's is shifted to a maximum of 0 over the states (the
    # posteriors below are normalized per step and lane, so they do not
    # change), which keeps their O(1) differences in float32, and xi is
    # normalized by its sum rather than by a log-sum rounded at that size.
    alpha = alpha - _finite_max(alpha, -2)
    beta_t = beta_t - _finite_max(beta_t, -2)
    smoothed = alpha + beta_t
    smoothed = smoothed - um.stable_logsumexp(smoothed, -2, keepdim=True)

    alpha_prev, = chain.shift((alpha,), up=False, edge=(ivec,))
    xi = alpha_prev[..., :, None, :] + Mp + beta_t[..., None, :, :]
    xi = torch.exp(xi - _finite_max(xi.reshape(T, K * K, N), -2)[:, None])
    xi = xi / xi.sum((-3, -2), keepdim=True)

    mx = smoothed.amax(-2, keepdim=True)
    p = torch.exp((smoothed - mx) / ptemp)
    p = p / p.sum(-2, keepdim=True)

    p_d = p.permute(0, 2, 1).reshape((T,) + bshape + (K,))
    xi_d = xi.permute(0, 3, 1, 2).reshape((T,) + bshape + (K, K))
    SEz0 = chain.held(chain.first(xi_d)[0].sum(-1))
    logZ_d = logZ.reshape(bshape)
    return p_d, xi_d, SEz0, logZ_d


def _forward_backward(trans_logits, init_logits, obs_logits, ptemp, driven, chain):
    """The two smoothers below on ``chain``'s rows (a ``ShardedChain``'s:
    this process's rows in, its rows and parts out)."""
    with span("hmm.forward_backward"):
        obs_logits, offset = _shift_obs(obs_logits)
        M = trans_logits + obs_logits[..., None, :]
        p, xi, SEz0, logZ = _hmm_plane_core(M, init_logits, ptemp,
                                            offset.expand(M.shape[1:-2]), chain)
        return p, (xi if driven else xi.sum(0)), SEz0, logZ


def forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp=1.0,
                              chain=scan.CHAIN):
    """Same contract as pyvbmp_tpu.ops.parallel_hmm.forward_backward_parallel.

    trans_logits: batch + (K, K)
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p (T,)+sample+batch+(K,), SEzz sample+batch+(K,K),
    SEz0 sample+batch+(K,), logZ sample+batch).

    chain: the whole time axis by default; a ``ShardedChain``
    (``parallel/seq_parallel.py``) takes this process's rows of obs_logits
    and returns its rows of p, its part of SEzz and logZ (sums over its
    rows) and SEz0 where it holds row 0, zeros elsewhere: one all_reduce
    over the time axis completes all three.
    """
    return _forward_backward(trans_logits, init_logits, obs_logits, ptemp, False, chain)


def driven_forward_backward_parallel(trans_logits, init_logits, obs_logits, ptemp=1.0,
                                     chain=scan.CHAIN):
    """Same contract as
    pyvbmp_tpu.ops.parallel_hmm.driven_forward_backward_parallel (plane form):
    the input-driven smoother, with per-time transition logits.

    trans_logits: (T,) + sample + batch + (K, K)
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p (T,)+sample+batch+(K,), SEzz (T,)+sample+batch+(K,K),
    SEz0 sample+batch+(K,), logZ sample+batch).  The pairwise statistics
    stay per time step: the MNLR transition's M-step needs SEzz[t].  With a
    ``ShardedChain`` (as for ``forward_backward_parallel``) trans_logits
    are this process's rows too, and SEzz is its rows.
    """
    return _forward_backward(trans_logits, init_logits, obs_logits, ptemp, True, chain)
