"""Diagonal Wishart = vector of Gammas (counterpart of
pyvbmp_tpu/dists/diagonal_wishart.py): MatrixNormalGamma's row precisions,
and ``DiagonalWishartUnitTrace``, whose expected precisions sum to the
dimension."""
from __future__ import annotations

import torch

from .gamma import Gamma
from ..utils.torchutils import Node, node, replace


@node
class DiagonalWishart(Node):
    gamma: Gamma
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, scale=1.0,
               generator=None, dtype=None, device=None):
        pp = {"nu": 2.0, "U": 0.5}
        if prior_parms is not None:
            pp.update(prior_parms)
        gamma = Gamma.create(
            event_shape,
            batch_shape,
            prior_parms={"alpha": pp["nu"], "beta": scale**2 / pp["U"]},
            generator=generator,
            dtype=dtype,
            device=device,
        )
        return cls(gamma=gamma, event_shape=tuple(event_shape),
                   batch_shape=tuple(batch_shape))

    @property
    def dim(self):
        return self.event_shape[-1]

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
                       batch_shape=self.batch_shape[:-n], gamma=self.gamma.to_event(n))

    def ss_update(self, SExx, N, lr=1.0, beta=None):
        """SExx is the diagonal of a scatter matrix."""
        return replace(self, gamma=self.gamma.ss_update(N / 2.0, SExx / 2.0, lr, beta))

    def KLqprior(self):
        return self.gamma.KLqprior()

    def logZ(self):
        return self.gamma.logZ()

    @staticmethod
    def tensor_diag(A):
        return torch.diag_embed(A)

    def ESigma(self):
        return self.tensor_diag(self.gamma.meaninv())

    def EinvSigma(self):
        return self.tensor_diag(self.gamma.mean())

    def ElogdetinvSigma(self):
        return self.gamma.loggeomean().sum(-1)

    def mean(self):
        return self.tensor_diag(self.gamma.mean())

    def logdetEinvSigma(self):
        return torch.log(self.gamma.mean()).sum(-1)

    def invEinvSigma(self):
        return self.tensor_diag(1.0 / self.gamma.mean())


class DiagonalWishartUnitTrace(DiagonalWishart):
    """Diagonal Wishart with Tr(<Sigma^-1>) = dim: a Newton solve on a shift
    of the Gamma rates shared by a matrix's diagonal."""

    def ss_update(self, SExx, N, lr=1.0, beta=None, iters=10):
        new = DiagonalWishart.ss_update(self, SExx, N, lr=lr, beta=beta)
        g = new.gamma
        # solved in float64 whatever the node's dtype, as WishartUnitTrace's
        # shift is: a row that lands on its floor keeps a rate ~1e-4 made of
        # O(1) numbers.  Float64 results are unchanged.
        alpha, beta_ = g.alpha.to(torch.float64), g.beta.to(torch.float64)
        x = beta_.new_zeros(beta_.shape[:-1] + (1,))
        bmin = beta_.amin(-1, keepdim=True)
        for _ in range(iters):
            f = (alpha / (beta_ + x)).sum(-1, keepdim=True)
            fprime = -(alpha / (beta_ + x) ** 2).sum(-1, keepdim=True)
            x = x + (new.dim - f) / fprime
            x = torch.where(x < -bmin, -bmin + 1e-4, x)
        return replace(new, gamma=replace(g, beta=(beta_ + x).to(g.beta.dtype)))
