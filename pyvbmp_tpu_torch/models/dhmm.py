"""Input-driven HMM: the transition p(z' | z, x) is a multinomial logistic
regression on the input x, one per source state (counterpart of
pyvbmp_tpu/models/dhmm.py).

Its smoother is the input-driven forward-backward, with per-time transition
logits and per-time pairwise statistics: the sequential
``driven_forward_backward`` below (two Python loops over T, no kernel), or
with ``parallel_scan=True`` ``ops.parallel_hmm.driven_forward_backward_parallel``
(the logsemiring scan pair, the CUDA kernel for tensors on the card).
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists import Dirichlet
from ..transforms.mnlr import MultiNomialLogisticRegression
from ..utils import math as um
from ..utils.torchutils import default_device, replace, sum_leading


def driven_forward_backward(trans_logits, init_logits, obs_logits, ptemp=1.0):
    """HMM smoother with per-time transition logits; keeps per-time SEzz.

    trans_logits: (T,) + sample + batch + (K, K)
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p (T,)+sample+batch+(K,), SEzz (T,)+sample+batch+(K,K),
    SEz0 sample+batch+(K,), logZ sample+batch).  The first step folds
    ``init_logits`` into ``trans_logits[0]``, as the scan form does through
    its first element.
    """
    lse = um.stable_logsumexp
    T = obs_logits.shape[0]
    fw = [lse(obs_logits[0][..., None, :] + init_logits[..., :, None] + trans_logits[0], -2)]
    for t in range(1, T):
        fw.append(lse(fw[-1][..., :, None] + obs_logits[t][..., None, :] + trans_logits[t], -2))
    fw_logits = torch.stack(fw)
    logZ = lse(fw_logits[-1], -1, keepdim=True)
    fw_logits = fw_logits - logZ
    logZ = logZ[..., 0]

    def pair(left, trans, right):
        """(log marginal of the left state, normalized pairwise stats)."""
        temp = left[..., :, None] + trans
        xi = (temp - lse(temp, -2, keepdim=True)) + right[..., None, :]
        return lse(xi, -1), torch.exp(xi - lse(xi, (-1, -2), keepdim=True))

    smoothed = [None] * T
    SEzz = [None] * T
    smoothed[-1] = fw_logits[-1]
    for t in range(T - 2, -1, -1):
        smoothed[t], SEzz[t + 1] = pair(fw_logits[t], trans_logits[t + 1], smoothed[t + 1])
    smoothed = torch.stack(smoothed)

    SEz0, SEzz[0] = pair(init_logits, trans_logits[0], smoothed[0])
    SEz0 = torch.exp(SEz0 - lse(SEz0, -1, keepdim=True))
    SEzz = torch.stack(SEzz)

    p = torch.exp((smoothed - smoothed.amax(-1, keepdim=True)) / ptemp)
    p = p / p.sum(-1, keepdim=True)
    return p, SEzz, SEz0, logZ


class dHMM:
    """Stateful shell: an observation model batched over the states, an MNLR
    transition batched over source states and a Dirichlet initial state
    pinned to its prior."""

    def __init__(self, obs_dist, p, transition_mask=None, ptemp=1.0,
                 parallel_scan=False, time_mesh=None, *, generator=None, dtype=None,
                 device=None):
        """The JAX package's signature (``transition_mask`` is accepted and
        unused, as there); ``generator``, ``dtype`` and ``device`` are
        keyword-only.  The model goes to ``device``, the card unless the
        caller asks for another."""
        if time_mesh is not None:
            raise NotImplementedError("time_mesh (the time-sharded smoother) is not ported")
        obs_dist = obs_dist.to(default_device(device), dtype)
        like = obs_dist.mu
        self.obs_dist = obs_dist
        n = obs_dist.batch_shape[-1]
        self.hidden_dim = n
        self.event_dim = 1
        self.event_shape = (n,)
        self.batch_shape = tuple(obs_dist.batch_shape[:-1])
        self.batch_dim = len(self.batch_shape)
        self.transition_mask = transition_mask
        self.ptemp = ptemp
        self.parallel_scan = parallel_scan
        self.time_mesh = None
        self.transition = MultiNomialLogisticRegression(
            n, p, batch_shape=self.batch_shape + (n,), pad_X=True, generator=generator,
            dtype=like.dtype, device=like.device,
        )
        initial = Dirichlet.create((n,), self.batch_shape, generator=generator,
                                   dtype=like.dtype, device=like.device)
        self.initial = replace(initial, alpha=initial.alpha_0)
        self.p = None
        self.sumlogZ = torch.full((), -float("inf"), dtype=like.dtype, device=like.device)
        self.logZ = self.sumlogZ
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the shell's nodes and state in place; returns self."""
        self.obs_dist = self.obs_dist.to(device, dtype)
        self.transition.to(device, dtype)
        self.initial = self.initial.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device=device, dtype=dtype)
        self.sumlogZ = self.sumlogZ.to(device=device, dtype=dtype)
        self.logZ = self.logZ.to(device=device, dtype=dtype)
        return self

    def obs_logits(self, Y):
        return self.obs_dist.Elog_like(Y)

    def transition_logits(self, X):
        return self.transition.log_predict(X)

    def _fb(self):
        from .hmm import smoother_dispatch

        return smoother_dispatch(self, driven=True)

    def raw_update_states(self, X, Y):
        self.p, self.SEzz, SEz0, self.logZ = self._fb()(
            self.transition_logits(X), self.initial.loggeomean(), self.obs_logits(Y),
            self.ptemp,
        )
        keep = self.batch_dim + self.event_dim
        self.SEz0 = sum_leading(SEz0, keep)
        self.NA = sum_leading(self.p.sum(0), keep)
        self.sumlogZ = sum_leading(self.logZ, self.batch_dim)

    def raw_update_markov_parms(self, X, lr=1.0):
        self.transition.raw_update(X, self.SEzz, iters=4, lr=lr)
        self.initial = self.initial.ss_update(self.SEz0, lr)

    def raw_update_obs_parms(self, Y, lr=1.0):
        self.obs_dist = self.obs_dist.raw_update(Y, self.p, lr)

    def _vb_step(self, X, Y, lr):
        """One VB sweep: E-step, the three M-steps, and the sweep's ELBO
        (the E-step's logZ with the post-M-step KL, as in the JAX package)."""
        self.raw_update_states(X, Y)
        self.raw_update_markov_parms(X, lr)
        self.raw_update_obs_parms(Y, lr)
        # KLqprior() has the MNLR's (states,) shape, so the sum counts
        # sumlogZ once per state: the JAX package's ELBO, kept for parity
        return (self.sumlogZ - self.KLqprior()).sum()

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        """``iters`` VB sweeps on inputs X (T,) + sample + batch + (p,) and
        observations Y (T,) + sample + batch + event."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        Y = Y[..., None, :]
        X = X[..., None, :]
        ELBOs = torch.stack([self._vb_step(X, Y, lr) for _ in range(iters)])
        self.logZ = self.sumlogZ
        ELBO_last = -np.inf
        for ELBO in ELBOs.cpu().numpy():  # one host fetch for the whole trajectory
            if verbose:
                print("Percent Change in ELBO = %f"
                      % float((ELBO - ELBO_last) / np.abs(ELBO_last) * 100))
            ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO))

    update = raw_update

    def KLqprior(self):
        KL = (
            self.obs_dist.KLqprior().sum(-1)
            + self.transition.KLqprior()
            + self.initial.KLqprior()
        )
        for _ in range(self.event_dim - 1):
            KL = KL.sum(-1)
        return KL

    def ELBO(self):
        return self.sumlogZ - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)
