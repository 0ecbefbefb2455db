"""Dirichlet conjugate node: role transitions and the initial role
(counterpart of pyvbmp_tpu/dists/dirichlet.py)."""
from __future__ import annotations

import torch

from ..utils import math as um
from ..utils.torchutils import Node, as_tensor, batch_sum, node, replace, sum_leading, uniform


@node
class Dirichlet(Node):
    alpha_0: torch.Tensor
    alpha: torch.Tensor
    NA: torch.Tensor  # accumulated sufficient statistics (minibatch decay)
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None,
               generator=None, dtype=None, device=None):
        alpha_0 = as_tensor(
            0.5 if prior_parms is None else prior_parms["alpha"], dtype, device
        )
        alpha_0 = alpha_0.expand(tuple(batch_shape) + tuple(event_shape)).clone()
        alpha = alpha_0 * (1.0 + uniform(alpha_0.shape, generator, alpha_0))
        return cls(
            alpha_0=alpha_0,
            alpha=alpha,
            NA=torch.zeros_like(alpha_0),
            event_shape=tuple(event_shape),
            batch_shape=tuple(batch_shape),
        )

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    def to_event(self, n):
        if n == 0:
            return self
        return replace(self, event_shape=self.batch_shape[-n:] + self.event_shape,
                       batch_shape=self.batch_shape[:-n])

    def _edims(self):
        return tuple(range(-self.event_dim, 0))

    def ss_update(self, NA, lr=1.0, beta=None):
        if beta is not None:
            NA = beta * self.NA + NA
        alpha = lr * (NA + self.alpha_0) + (1 - lr) * self.alpha
        return replace(self, alpha=alpha, NA=NA)

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        """Update from counts X (sample + batch + event), weighted by p
        (sample + batch) when given; the sum over the samples is completed
        over processes that split them (``batch_sum``)."""
        if p is not None:
            X = X * p.reshape(p.shape + (1,) * self.event_dim)
        NA, = batch_sum(sum_leading(X, self.batch_dim + self.event_dim))
        return self.ss_update(NA, lr, beta)

    update = raw_update

    def mean(self):
        return self.alpha / self.alpha.sum(self._edims(), keepdim=True)

    def loggeomean(self):
        # masked transitions (alpha == 0) must give -inf logits: written as an
        # explicit where() so no library's digamma(0) convention is relied on
        dg = torch.where(
            self.alpha > 0,
            torch.digamma(self.alpha),
            torch.full_like(self.alpha, -float("inf")),
        )
        return dg - torch.digamma(self.alpha.sum(self._edims(), keepdim=True))

    ElogX = loggeomean

    def var(self):
        alpha_sum = self.alpha.sum(self._edims(), keepdim=True)
        mean = self.mean()
        return mean * (1 - mean) / (alpha_sum + 1)

    def Elog_like(self, X):
        """Multinomial log likelihood of counts X."""
        ed = self._edims()
        return ((X * self.loggeomean()).sum(ed) + torch.lgamma(1 + X.sum(ed))
                - torch.lgamma(1 + X).sum(ed))

    def logZ(self):
        ed = self._edims()
        return torch.lgamma(self.alpha).sum(ed) - torch.lgamma(self.alpha.sum(ed))

    def KLqprior(self):
        # Evaluated in float64 whatever the node's dtype: with counts ~1e4
        # its lgamma terms are ~1e5 and cancel to ~1e2, which would leave
        # float32 ~1e-4 of the KL.  Float64 results are unchanged.
        ed = self._edims()
        alpha, alpha_0 = self.alpha.to(torch.float64), self.alpha_0.to(torch.float64)
        alpha_sum = alpha.sum(ed)
        alpha_0_sum = alpha_0.sum(ed)
        KL = torch.lgamma(alpha_sum) - um.lgamma_masked(alpha).sum(ed)
        KL = KL - torch.lgamma(alpha_0_sum) + um.lgamma_masked(alpha_0).sum(ed)
        KL = KL + (
            (alpha - alpha_0)
            * (
                um.digamma_masked(alpha)
                - torch.digamma(alpha_sum).reshape(
                    alpha_sum.shape + (1,) * self.event_dim
                )
            )
        ).sum(ed)
        while KL.ndim > self.batch_dim:
            KL = KL.sum(-1)
        return KL.to(self.alpha.dtype)
