"""Discrete HMM shell with a pluggable observation model (counterpart of
pyvbmp_tpu/models/hmm.py).

The port carries what DMBD's role chain uses: the shell's state (transition
and initial Dirichlets, observation model, assignments) and the assignment
readers.  Its smoother is
``ops.parallel_hmm.forward_backward_parallel``; the sequential
``forward_backward``, ``smoother_dispatch`` and the HMM's own ``update`` are
not ported yet.
"""
from __future__ import annotations

import torch

from ..dists import Dirichlet


class HMM:
    """Stateful shell around immutable parameter nodes."""

    def __init__(self, obs_dist, transition_mask=None, ptemp=1.0,
                 generator=None):
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

    def to(self, device=None, dtype=None):
        """Move the shell's nodes and assignments in place; returns self."""
        self.obs_dist = self.obs_dist.to(device, dtype)
        self.transition = self.transition.to(device, dtype)
        self.initial = self.initial.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device=device, dtype=dtype)
        return self

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)
