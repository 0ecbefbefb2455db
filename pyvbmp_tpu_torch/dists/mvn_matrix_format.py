"""MVN over (dim,) events in the "matrix layout" (counterpart of
pyvbmp_tpu/dists/mvn_matrix_format.py).

Either (mu, Sigma) or (invSigmamu, invSigma) may be given; a missing half is
computed on first access and cached on the (otherwise immutable) node.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import math as um
from ..utils.linalg import psd_inv, psd_logdet
from ..utils.torchutils import Node, node, replace, sum_leading


@node
class MultivariateNormal(Node):
    mu: torch.Tensor = None
    Sigma: torch.Tensor = None
    invSigmamu: torch.Tensor = None
    invSigma: torch.Tensor = None
    event_dim: int = 1

    def _cache(self, name, value):
        object.__setattr__(self, name, value)
        return value

    def _ref(self):
        for x in (self.mu, self.invSigmamu):
            if x is not None:
                return x
        raise ValueError("MultivariateNormal: mu and invSigmamu are both None")

    @property
    def dim(self):
        return self._ref().shape[-1]

    @property
    def shape(self):
        return tuple(self._ref().shape)

    @property
    def event_shape(self):
        return self.shape[-self.event_dim:]

    @property
    def batch_shape(self):
        return self.shape[: len(self.shape) - self.event_dim]

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    def to_event(self, n):
        if n == 0:
            return self
        return replace(self, event_dim=self.event_dim + n)

    def mean(self):
        if self.mu is None:
            return self._cache(
                "mu", (psd_inv(self.invSigma) * self.invSigmamu[..., None, :]).sum(-1))
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
            return self._cache(
                "invSigmamu", (self.EinvSigma() * self.mean()[..., None, :]).sum(-1))
        return self.invSigmamu

    def ElogdetinvSigma(self):
        if self.Sigma is None:
            return psd_logdet(self.invSigma)
        return -psd_logdet(self.Sigma)

    def EX(self):
        return self.mean()

    def EXXT(self):
        return self.ESigma() + self.mean()[..., :, None] * self.mean()[..., None, :]

    def EXTX(self):
        return self.EXXT().sum((-1, -2))

    def ss_update(self, SExx, SEx, n, lr=1.0):
        mu = SEx / n[..., None]
        Sigma = SExx / n[..., None, None] - mu[..., :, None] * mu[..., None, :]
        return MultivariateNormal(mu=mu, Sigma=Sigma, event_dim=self.event_dim)

    def raw_update(self, X, p=None, lr=1.0):
        nd = self.event_dim + self.batch_dim
        SExx = X[..., :, None] * X[..., None, :]
        if p is None:
            sample_shape = X.shape[: X.ndim - nd]
            n = X.new_full(self.batch_shape + self.event_shape[:-1],
                           float(np.prod(sample_shape, dtype=np.float64)))
            return self.ss_update(sum_leading(SExx, nd + 1), sum_leading(X, nd), n, lr)
        pv = p.reshape(p.shape + (1,) * self.event_dim)
        n = sum_leading(pv, nd)[..., 0]
        return self.ss_update(sum_leading(SExx * pv[..., None], nd + 1),
                              sum_leading(X * pv, nd), n, lr)

    def Elog_like(self, X):
        d = X - self.mean()
        out = -0.5 * (d[..., :, None] * d[..., None, :] * self.EinvSigma()).sum((-1, -2))
        out = out - 0.5 * self.dim * um.LOG2PI + 0.5 * self.ElogdetinvSigma()
        for _ in range(self.event_dim - 2):
            out = out.sum(-1)
        return out

    def KLqprior(self):
        return self._ref().new_zeros(())
