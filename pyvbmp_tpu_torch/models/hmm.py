"""Discrete HMM with a pluggable exponential-family observation model
(counterpart of pyvbmp_tpu/models/hmm.py).

Two smoothers, picked by ``smoother_dispatch`` from the model's
``parallel_scan``:

- ``forward_backward``: the sequential filter and smoother, two Python loops
  over T in plain PyTorch (the JAX package's two ``lax.scan``s); it runs no
  kernel on either device;
- ``ops.parallel_hmm.forward_backward_parallel``: one prefix and one suffix
  scan of the (log,+) matrix semiring, the logsemiring CUDA kernel for
  tensors on the card.

With ``driven=True`` the dispatch gives the input-driven forms of the two
(``models/dhmm.py:driven_forward_backward`` and
``ops.parallel_hmm.driven_forward_backward_parallel``).  A ``time_mesh`` (a
``parallel.Mesh`` with a "seq" axis) comes first: the scan smoother with
its time axis cut across the mesh's ranks (``parallel/seq_parallel.py``).
``HMM.update`` then runs the sweep on this rank's rows of T: p is its rows,
and the E-step's ``batch_sum`` and the observation node's complete the
sums.  The node's update must form its sums through ``batch_sum``, as the
port's nodes do; one that does not raises in such a sweep
(``torchutils.completes_sums``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..dists import Dirichlet
from ..ops.parallel_hmm import driven_forward_backward_parallel, forward_backward_parallel
from ..parallel.seq_parallel import (
    time_sharded_driven_forward_backward,
    time_sharded_forward_backward,
    time_sweep,
)
from ..utils import math as um
from ..utils.torchutils import batch_sum, completes_sums, default_device, sum_leading


def forward_backward(trans_logits, init_logits, obs_logits, ptemp=1.0):
    """Batched HMM smoother (the JAX package's ``forward_backward``).

    trans_logits: batch + (K, K)   <log p(z'|z)>
    init_logits:  batch + (K,)
    obs_logits:   (T,) + sample + batch + (K,)
    Returns (p, SEzz, SEz0, logZ):
      p    (T,)+sample+batch+(K,)  smoothed posteriors (ptemp-sharpened)
      SEzz sample+batch+(K,K)      summed two-slice stats
      SEz0 sample+batch+(K,)
      logZ sample+batch
    """
    lse = um.stable_logsumexp
    T = obs_logits.shape[0]
    fw = [lse(init_logits[..., :, None] + trans_logits + obs_logits[0][..., None, :], -2)]
    for t in range(1, T):
        fw.append(lse(fw[-1][..., :, None] + trans_logits + obs_logits[t][..., None, :], -2))
    fw_logits = torch.stack(fw)

    logZ = lse(fw_logits[-1], -1, keepdim=True)
    fw_logits = fw_logits - logZ
    logZ = logZ[..., 0]

    K = trans_logits.shape[-1]
    sm_next = fw_logits[-1]
    SEzz = fw_logits.new_zeros(fw_logits.shape[1:] + (K,))
    smoothed = [None] * T
    smoothed[-1] = sm_next
    for t in range(T - 2, -1, -1):
        temp = fw_logits[t][..., :, None] + trans_logits
        xi = (temp - lse(temp, -2, keepdim=True)) + sm_next[..., None, :]
        sm_next = lse(xi, -1)
        SEzz = SEzz + torch.exp(xi - lse(xi, (-1, -2), keepdim=True))
        smoothed[t] = sm_next
    smoothed = torch.stack(smoothed)

    # initial step (t = -1 -> 0)
    temp = init_logits[..., :, None] + trans_logits
    xi = (temp - lse(temp, -2, keepdim=True)) + smoothed[0][..., None, :]
    SEz0 = lse(xi, -1)
    SEz0 = torch.exp(SEz0 - lse(SEz0, -1, keepdim=True))
    SEzz = SEzz + torch.exp(xi - lse(xi, (-1, -2), keepdim=True))

    p = torch.exp((smoothed - smoothed.amax(-1, keepdim=True)) / ptemp)
    p = p / p.sum(-1, keepdim=True)
    return p, SEzz, SEz0, logZ


def smoother_dispatch(model, driven=False):
    """The forward-backward that ``model`` asks for, in the JAX package's
    order: time-sharded over ``model.time_mesh`` when it is set, else the
    scan-based smoother when ``model.parallel_scan`` is set, else the
    sequential one; with ``driven`` their input-driven forms (per-time
    transition logits, per-time SEzz).  Returns ``fb(trans_logits,
    init_logits, obs_logits, ptemp)``.  In a time-sharded sweep of the
    model (``seq_parallel.time_sweep``) it is the scan-based smoother on
    the sweep's chain: this rank's rows in, its rows and parts out."""
    mesh = getattr(model, "time_mesh", None)
    chunk = getattr(model, "_sweep_chunk", None)
    if mesh is not None and chunk is None:
        sharded = (time_sharded_driven_forward_backward if driven
                   else time_sharded_forward_backward)

        def fb(trans, init, obs, ptemp):
            return sharded(trans, init, obs, mesh, ptemp=ptemp)

        return fb
    if chunk is not None or getattr(model, "parallel_scan", False):
        fb = driven_forward_backward_parallel if driven else forward_backward_parallel
        return fb if chunk is None else functools.partial(fb, chain=chunk)
    if driven:
        from .dhmm import driven_forward_backward

        return driven_forward_backward
    return forward_backward


class HMM:
    """Stateful shell around immutable parameter nodes."""

    CHUNK_STATE = {"p": "time"}

    def __init__(self, obs_dist, transition_mask=None, ptemp=1.0, parallel_scan=False,
                 time_mesh=None, *, generator=None, dtype=None, device=None):
        """The JAX package's signature; ``generator`` (for the Dirichlets'
        initial draws), ``dtype`` and ``device`` are keyword-only.  The
        model (``obs_dist`` with it) goes to ``device``, the card unless the
        caller asks for another.  ``time_mesh`` is None or a
        ``parallel.Mesh`` (anything else raises ``TypeError``)."""
        from ..parallel.api import as_time_mesh

        self.time_mesh = as_time_mesh(time_mesh)
        self.time_chunk = self._sweep_chunk = None
        obs_dist = obs_dist.to(default_device(device), dtype)
        like = obs_dist.mu
        self.obs_dist = obs_dist
        self.event_dim = 1
        self.dim = obs_dist.batch_shape[-1]
        self.event_shape = tuple(obs_dist.batch_shape[-1:])
        self.batch_shape = tuple(obs_dist.batch_shape[:-1])
        self.batch_dim = len(self.batch_shape)
        self.transition_mask = transition_mask

        alpha = torch.eye(self.dim, dtype=like.dtype, device=like.device) + 0.5
        if transition_mask is not None:
            alpha = alpha * torch.as_tensor(transition_mask, device=like.device)
        self.transition = Dirichlet.create(
            self.event_shape,
            self.batch_shape + self.event_shape,
            prior_parms={"alpha": alpha},
            generator=generator,
            dtype=like.dtype,
            device=like.device,
        )
        self.initial = Dirichlet.create(
            self.event_shape, self.batch_shape, generator=generator,
            dtype=like.dtype, device=like.device,
        )
        self.p = None
        self.ptemp = ptemp
        self.parallel_scan = parallel_scan
        self.logZ = torch.full((), -float("inf"), dtype=like.dtype, device=like.device)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the shell's nodes and state in place; returns self."""
        self.obs_dist = self.obs_dist.to(device, dtype)
        self.transition = self.transition.to(device, dtype)
        self.initial = self.initial.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device=device, dtype=dtype)
        self.logZ = self.logZ.to(device=device, dtype=dtype)
        if isinstance(self.transition_mask, torch.Tensor):
            self.transition_mask = self.transition_mask.to(device=device)
        return self

    # -- observation-model hooks (overridden by the ARHMM variants) ------------
    def _obs_logits(self, obs_dist, X):
        return obs_dist.Elog_like(X.unsqueeze(-1 - obs_dist.event_dim))

    def _obs_update(self, obs_dist, X, p, lr, beta):
        return obs_dist.raw_update(X.unsqueeze(-1 - obs_dist.event_dim), p=p, lr=lr, beta=beta)

    def _obs_KL(self, obs_dist):
        return obs_dist.KLqprior().sum(-1)

    # -- E-step and one VB step --------------------------------------------------
    def _estep(self, transition, initial, obs_dist, X):
        logits = self._obs_logits(obs_dist, X)
        fb = smoother_dispatch(self)
        p, SEzz, SEz0, logZ = fb(
            transition.loggeomean(), initial.loggeomean(), logits, self.ptemp
        )
        NA = p.sum(0)
        keep = self.batch_dim + self.event_dim
        NA = sum_leading(NA, keep)
        SEzz = sum_leading(SEzz, keep + 1)
        SEz0 = sum_leading(SEz0, keep)
        logZ = sum_leading(logZ, self.batch_dim)
        # the E-step's sums over the batch, for the M-steps and the ELBO
        NA, SEzz, SEz0, logZ = batch_sum(NA, SEzz, SEz0, logZ)
        return p, SEzz, SEz0, NA, logZ

    def _vb_step(self, transition, initial, obs_dist, X, lr, beta):
        p, SEzz, SEz0, NA, logZ = self._estep(transition, initial, obs_dist, X)
        transition = transition.ss_update(SEzz, lr=lr, beta=beta)
        initial = initial.ss_update(SEz0, lr=lr, beta=beta)
        with completes_sums(obs_dist):
            obs_dist = self._obs_update(obs_dist, X, p, lr, beta)
        # the ELBO pairs the post-M-step KL with the E-step logZ, as the JAX
        # package and the reference do
        KL = self._obs_KL(obs_dist) + transition.KLqprior().sum(-1) + initial.KLqprior()
        return transition, initial, obs_dist, p, NA, logZ, logZ - KL

    # -- reference API -------------------------------------------------------------
    def obs_logits(self, X):
        return self._obs_logits(self.obs_dist, X)

    def update_states(self, X, T=None):
        self.p, SEzz, SEz0, NA, logZ = self._estep(
            self.transition, self.initial, self.obs_dist, X
        )
        self.time_chunk = None  # p is whole (a time_mesh's whole-output smoother)
        self.NA = NA
        self.logZ = logZ
        return SEzz, SEz0, NA, logZ

    def update_markov_parms(self, SEzz, SEz0, lr=1.0, beta=None):
        self.transition = self.transition.ss_update(SEzz, lr=lr, beta=beta)
        self.initial = self.initial.ss_update(SEz0, lr=lr, beta=beta)

    def update_obs_parms(self, X, lr=1.0, beta=None):
        self.obs_dist = self._obs_update(self.obs_dist, X, self.p, lr, beta)

    def update(self, X, iters=1, T=None, lr=1.0, beta=None, verbose=False):
        """``iters`` VB-EM sweeps on X: (T,) + sample + batch + event; with
        a ``time_mesh``, on this rank's rows of T."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        ELBOs = []
        n_seq = (X.shape[1] if self.time_mesh is not None
                 and X.ndim > 1 + self.batch_dim + self.obs_dist.event_dim else None)
        with time_sweep(self, X, n_seq) as chunk:
            if chunk is not None:
                X = chunk.take(X)
            for _ in range(iters):
                (self.transition, self.initial, self.obs_dist, self.p, self.NA, self.logZ,
                 ELBO) = self._vb_step(self.transition, self.initial, self.obs_dist, X, lr,
                                       beta)
                ELBOs.append(ELBO)
        # one host fetch for the whole trajectory
        for ELBO in torch.stack(ELBOs).cpu().numpy():
            if verbose:
                print(
                    "Percent Change in ELBO = ",
                    (ELBO - self.ELBO_last) / np.abs(self.ELBO_last) * 100,
                )
            self.ELBO_last = ELBO
            self.ELBO_save.append(float(np.sum(ELBO)))

    def KLqprior(self):
        return (
            self._obs_KL(self.obs_dist)
            + self.transition.KLqprior().sum(-1)
            + self.initial.KLqprior()
        )

    def ELBO(self):
        return self.logZ - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)

    # -- expectation averaging (reference HMM.py:160-178) --------------------------
    def average(self, A, keepdim=False):
        return (A * self.p).sum(-1, keepdim=keepdim)

    def event_average(self, A, keepdim=False):
        de = self.obs_dist.event_dim
        out = (A * self.p.reshape(self.p.shape + (1,) * de)).sum(-de - 1, keepdim=keepdim)
        for _ in range(self.event_dim - 1):
            out = out.sum(-de - 1, keepdim=keepdim)
        return out

    def event_average_f(self, fname, keepdim=False):
        return self.event_average(getattr(self.obs_dist, fname)(), keepdim)

    def average_f(self, fname, keepdim=False):
        return self.average(getattr(self.obs_dist, fname)(), keepdim)
