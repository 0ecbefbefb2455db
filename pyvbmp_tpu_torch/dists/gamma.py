"""Gamma conjugate node: the per-row precisions of MatrixNormalGamma and
NormalGamma, and the Poisson rates of PoissonMixtureModel (counterpart of
pyvbmp_tpu/dists/gamma.py)."""
from __future__ import annotations

import torch

from ..utils.torchutils import Node, as_tensor, batch_sum, node, replace, uniform


@node
class Gamma(Node):
    alpha_0: torch.Tensor
    beta_0: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    SEx: torch.Tensor
    SElogx: torch.Tensor
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape=(), batch_shape=(), prior_parms=None,
               generator=None, dtype=None, device=None):
        pp = {"alpha": 1.0, "beta": 1.0}
        if prior_parms is not None:
            pp.update(prior_parms)
        shape = tuple(batch_shape) + tuple(event_shape)
        alpha_0 = as_tensor(pp["alpha"], dtype, device).expand(shape).clone()
        beta_0 = as_tensor(pp["beta"], dtype, device).expand(shape).clone()
        return cls(
            alpha_0=alpha_0,
            beta_0=beta_0,
            alpha=alpha_0 + uniform(shape, generator, alpha_0),
            beta=beta_0 + uniform(shape, generator, beta_0),
            SEx=torch.zeros_like(alpha_0),
            SElogx=torch.zeros_like(alpha_0),
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
        return replace(
            self,
            event_shape=self.batch_shape[-n:] + self.event_shape,
            batch_shape=self.batch_shape[:-n],
        )

    def ss_update(self, SElogx, SEx, lr=1.0, beta=None):
        """alpha <- alpha_0 + SElogx ; beta <- beta_0 + SEx (with lr damping);
        the first statistic feeds alpha, the second beta."""
        store_SEx, store_SElogx = self.SEx, self.SElogx
        if beta is not None:
            store_SEx = beta * self.SEx + SEx
            store_SElogx = beta * self.SElogx + SElogx
            SEx, SElogx = store_SEx, store_SElogx
        alpha = (self.alpha_0 + SElogx) * lr + self.alpha * (1 - lr)
        beta_p = (self.beta_0 + SEx) * lr + self.beta * (1 - lr)
        return replace(self, alpha=alpha, beta=beta_p, SEx=store_SEx,
                       SElogx=store_SElogx)

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        """Poisson-rate update from counts X (sample + batch + event),
        weighted by the assignments p (sample + batch) when given."""
        nd = self.event_dim + self.batch_dim
        sdims = tuple(range(X.ndim - nd))
        shape = self.batch_shape + self.event_shape
        if p is None:
            nsamp = 1
            for d in sdims:
                nsamp *= X.shape[d]
            N = X.new_full(shape, float(nsamp))
            SEx = X.sum(sdims)
        else:
            pv = p.reshape(p.shape + (1,) * self.event_dim)
            SEx = (X * pv).sum(sdims)
            N = pv.sum(sdims).expand(shape)
        SEx, N = batch_sum(SEx, N)
        return self.ss_update(SEx, N, lr=lr, beta=beta)

    def Elog_like(self, X):
        """Poisson observation model."""
        out = X * self.loggeomean() - torch.lgamma(X + 1) - self.mean()
        return out.sum(tuple(range(-self.event_dim, 0))) if self.event_dim else out

    def mean(self):
        return self.alpha / self.beta

    def var(self):
        return self.alpha / self.beta**2

    def meaninv(self):
        return self.beta / (self.alpha - 1)

    def ElogX(self):
        return torch.digamma(self.alpha) - torch.log(self.beta)

    def loggeomean(self):
        # log(alpha) - log(beta), as the JAX package and its reference have it
        return torch.log(self.alpha) - torch.log(self.beta)

    def entropy(self):
        return (torch.log(self.alpha) - torch.log(self.beta) + torch.lgamma(self.alpha)
                + (1 - self.alpha) * torch.digamma(self.alpha))

    def logZ(self):
        return -self.alpha * torch.log(self.beta) + torch.lgamma(self.alpha)

    def logZprior(self):
        return -self.alpha_0 * torch.log(self.beta_0) + torch.lgamma(self.alpha_0)

    def KLqprior(self):
        # Evaluated in float64 whatever the node's dtype, as the Dirichlet's
        # KL is: a Gamma that has seen ~1e5 samples (TensorNormalWishart's
        # scale) has terms ~1e6 that cancel to ~1e2.  Float64 results are
        # unchanged.
        f = torch.float64
        alpha, alpha_0 = self.alpha.to(f), self.alpha_0.to(f)
        beta, beta_0 = self.beta.to(f), self.beta_0.to(f)
        KL = (
            (alpha - alpha_0) * torch.digamma(alpha)
            - torch.lgamma(alpha)
            + torch.lgamma(alpha_0)
            + alpha_0 * (torch.log(beta) - torch.log(beta_0))
            + alpha * (beta_0 / beta - 1)
        )
        KL = KL.sum(tuple(range(-self.event_dim, 0))) if self.event_dim else KL
        return KL.to(self.alpha.dtype)
