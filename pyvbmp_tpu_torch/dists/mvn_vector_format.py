"""The Gaussian message type: MVN over (dim, 1) column vectors with dual
moment / natural parameterization and lazy conversion (counterpart of
pyvbmp_tpu/dists/mvn_vector_format.py).

Any of (mu, Sigma) / (invSigmamu, invSigma) may be given; a missing half is
computed on first access and cached on the (otherwise immutable) node.
"""
from __future__ import annotations

import torch

from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_logdet, psd_solve
from ..utils.torchutils import Node, node


@node
class MultivariateNormal_vector_format(Node):
    mu: torch.Tensor = None
    Sigma: torch.Tensor = None
    invSigmamu: torch.Tensor = None
    invSigma: torch.Tensor = None
    logdetinvSigma: torch.Tensor = None
    event_dim: int = 2

    def _cache(self, name, value):
        object.__setattr__(self, name, value)
        return value

    def _ref(self):
        for x in (self.mu, self.invSigmamu, self.Sigma, self.invSigma):
            if x is not None:
                return x
        raise ValueError("MVN_vector_format: no parameters set")

    @property
    def dim(self):
        return self._ref().shape[-2]

    @property
    def shape(self):
        r = self._ref()
        if r is self.Sigma or r is self.invSigma:
            return tuple(r.shape[:-1]) + (1,)
        return tuple(r.shape)

    def unsqueeze(self, dim):
        """Insert a batch dim."""
        if dim + self.event_dim >= 0:
            raise ValueError(f"unsqueeze({dim}) would land inside the event")

        def uns(x):
            return None if x is None else x.unsqueeze(dim)

        return MultivariateNormal_vector_format(
            mu=uns(self.mu),
            Sigma=uns(self.Sigma),
            invSigmamu=uns(self.invSigmamu),
            invSigma=uns(self.invSigma),
            event_dim=self.event_dim,
        )

    # -- lazy dual-parameter access --------------------------------------------
    def mean(self):
        if self.mu is None:
            return self._cache("mu", psd_solve(self.invSigma, self.invSigmamu))
        return self.mu

    def ESigma(self):
        if self.Sigma is None:
            return self._cache("Sigma", psd_inv(self.invSigma))
        return self.Sigma

    def EinvSigma(self):
        if self.invSigma is None:
            return self._cache("invSigma", psd_inv(self.Sigma))
        return self.invSigma

    def EinvSigmamu(self):
        if self.invSigmamu is None:
            return self._cache("invSigmamu", self.EinvSigma() @ self.mean())
        return self.invSigmamu

    def ElogdetinvSigma(self):
        if self.logdetinvSigma is None:
            return self._cache("logdetinvSigma", psd_logdet(self.EinvSigma()))
        return self.logdetinvSigma

    def EX(self):
        return self.mean()

    def EXXT(self):
        return self.ESigma() + self.mean() @ mT(self.mean())

    def Res(self):
        """-0.5 mu' Lambda mu + 0.5 logdet Lambda - d/2 log 2pi."""
        return (
            -0.5 * (self.mean() * self.EinvSigmamu()).sum((-1, -2))
            + 0.5 * self.ElogdetinvSigma()
            - 0.5 * self.dim * um.LOG2PI
        )
