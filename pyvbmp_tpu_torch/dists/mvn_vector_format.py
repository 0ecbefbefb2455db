"""The Gaussian message type: MVN over (dim, 1) column vectors with dual
moment / natural parameterization and lazy conversion (counterpart of
pyvbmp_tpu/dists/mvn_vector_format.py).

Any of (mu, Sigma) / (invSigmamu, invSigma) may be given; a missing half is
computed on first access and cached on the (otherwise immutable) node.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_logdet, psd_solve
from ..utils.torchutils import Node, node, replace, sum_leading


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

    def EXTX(self):
        return self.ESigma().sum((-1, -2)) + (mT(self.mean()) @ self.mean())[..., 0, 0]

    # -- message fusion ---------------------------------------------------------
    def combiner(self, other):
        """Precision-add fusion of two messages; returns a new node."""
        return self.nat_combiner(other.EinvSigma(), other.EinvSigmamu())

    def nat_combiner(self, invSigma, invSigmamu):
        return MultivariateNormal_vector_format(
            invSigma=self.EinvSigma() + invSigma,
            invSigmamu=self.EinvSigmamu() + invSigmamu,
            event_dim=self.event_dim,
        )

    # -- updates ------------------------------------------------------------------
    def ss_update(self, SExx, SEx, n, lr=1.0):
        """Moment matching (the JAX package's, whose reference defines a
        natural-parameter ``ss_update`` first and shadows it with this one)."""
        n = n[..., None, None]
        mu = SEx / n
        return MultivariateNormal_vector_format(mu=mu, Sigma=SExx / n - mu @ mT(mu),
                                                event_dim=self.event_dim)

    def raw_update(self, X, p=None, lr=1.0):
        nd = self.event_dim + self.batch_dim
        if p is None:
            sample_shape = X.shape[: X.ndim - nd]
            n = X.new_full(self.batch_shape + self.event_shape[:-2],
                           float(np.prod(sample_shape, dtype=np.float64)))
            return self.ss_update(sum_leading(X @ mT(X), nd), sum_leading(X, nd), n, lr)
        pv = p.reshape(p.shape + (1,) * self.event_dim)
        n = sum_leading(pv, nd)[..., 0, 0]
        return self.ss_update(sum_leading(X @ mT(X) * pv, nd), sum_leading(X * pv, nd), n, lr)

    def Elog_like(self, X):
        d = X - self.mean()
        out = -0.5 * (mT(d) @ self.EinvSigma() @ d)[..., 0, 0]
        out = out - 0.5 * self.dim * um.LOG2PI + 0.5 * self.ElogdetinvSigma()
        for _ in range(self.event_dim - 2):
            out = out.sum(-1)
        return out

    def KLqprior(self):
        return self._ref().new_zeros(())
