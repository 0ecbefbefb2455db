"""Kronecker-factored tensor normal: a precision that is a product of one
unit-determinant Wishart per mode and a global Gamma scale (counterpart of
pyvbmp_tpu/dists/tensor_normal_wishart.py)."""
from __future__ import annotations

import math

import torch

from .gamma import Gamma
from .wishart import WishartUnitDet
from ..utils import math as um
from ..utils.torchutils import Node, node, normal, replace


@node
class TensorNormalWishart(Node):
    mu_0: torch.Tensor
    mu: torch.Tensor
    lambda_mu_0: torch.Tensor
    lambda_mu: torch.Tensor
    invU: list  # one WishartUnitDet per mode
    alpha: Gamma
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), generator=None, dtype=None, device=None):
        dims = tuple(event_shape)
        batch_shape = tuple(batch_shape)
        mu_0 = torch.zeros(batch_shape + dims, dtype=dtype or torch.get_default_dtype(),
                           device=device)
        mu = normal(mu_0.shape, generator, mu_0) / math.sqrt(float(math.prod(dims)))
        kw = dict(generator=generator, dtype=mu_0.dtype, device=device)
        invU = [WishartUnitDet.create((d, d), batch_shape, **kw) for d in dims]
        alpha = Gamma.create((), batch_shape, **kw)
        ones = mu_0.new_ones(batch_shape)
        return cls(mu_0=mu_0, mu=mu, lambda_mu_0=ones, lambda_mu=ones, invU=invU,
                   alpha=alpha, event_shape=dims, batch_shape=batch_shape)

    @property
    def dims(self):
        return self.event_shape

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    def _kron(self, mats, scale, dims):
        """The Kronecker product of the modes ``dims``' matrices times the
        scale, as a broadcastable batch + event + event tensor."""
        K = self.event_dim
        if dims is None:
            dims = list(range(K))

        def view(i, M):
            e = i * (1,) + (self.event_shape[i],) + (K - i - 1) * (1,)
            return M.reshape(self.batch_shape + 2 * e)

        out = view(dims[0], mats[dims[0]]) * scale.reshape(self.batch_shape + 2 * K * (1,))
        for i in dims[1:]:
            out = out * view(i, mats[i])
        return out

    def EinvSigma(self, dims=None):
        """The expected precision restricted to the modes ``dims``."""
        return self._kron([w.EinvSigma() for w in self.invU], self.alpha.mean(), dims)

    def ESigma(self, dims=None):
        return self._kron([w.ESigma() for w in self.invU], self.alpha.meaninv(), dims)

    def raw_update(self, X, iters=1, lr=1.0, beta=None):
        new = self
        for _ in range(iters):
            new = new._raw_update(X, lr=lr, beta=beta)
        return new

    def _raw_update(self, X, lr=1.0, beta=None):
        if beta is None:
            beta = 1.0 - lr
        K = self.event_dim
        sample_shape = tuple(X.shape[: X.ndim - K - self.batch_dim])
        sdims = tuple(range(len(sample_shape)))
        nsamp = float(math.prod(sample_shape))
        N = nsamp * X.new_ones(self.batch_shape)
        lambda_mu = self.lambda_mu_0 + N
        ev = self.batch_shape + K * (1,)
        mu = (X.sum(sdims) + self.mu_0 * self.lambda_mu_0.reshape(ev)) / lambda_mu.reshape(ev)
        Xc = X - mu

        # Gauss-Seidel over the modes, as the JAX package (and the reference's
        # in-place mutation) has it: mode i's scatter uses the already
        # updated modes j < i
        cur = self
        for i in range(K):
            idx = [j for j in range(K) if j != i]
            sidx1 = tuple(x for x in range(-2 * K, -K) if x != -2 * K + i)
            sidx2 = tuple(x for x in range(-K, 0) if x != -K + i)
            temp = cur.EinvSigma(idx) * Xc.reshape(Xc.shape + K * (1,))
            temp = (temp.sum(sidx1) * Xc.unsqueeze(-K - 1)).sum(sidx2).sum(sdims)
            invU = list(cur.invU)
            invU[i] = invU[i].ss_update(temp, N, lr=lr, beta=beta)
            cur = replace(cur, invU=invU)

        quad = (
            cur.EinvSigma()
            * Xc.reshape(sample_shape + self.batch_shape + self.event_shape + K * (1,))
            * Xc.reshape(sample_shape + self.batch_shape + K * (1,) + self.event_shape)
        ).sum(sdims)
        quad = quad.sum(tuple(range(self.batch_dim, self.batch_dim + 2 * K))) / self.alpha.mean()
        n_half = (float(math.prod(self.event_shape)) * nsamp / 2.0) * X.new_ones(self.batch_shape)
        alpha = self.alpha.ss_update(n_half, quad / 2.0, lr=lr, beta=beta)
        return replace(self, mu=lr * mu + beta * self.mu,
                       lambda_mu=lr * lambda_mu + beta * self.lambda_mu,
                       invU=list(cur.invU), alpha=alpha)

    def KLqprior(self):
        K = self.event_dim
        d = self.mu - self.mu_0
        KL = (
            d.reshape(self.batch_shape + self.event_shape + K * (1,))
            * self.EinvSigma()
            * d.reshape(self.batch_shape + K * (1,) + self.event_shape)
        ).sum(tuple(range(-2 * K, 0)))
        KL = 0.5 * self.lambda_mu_0 * KL + 0.5 * (
            self.lambda_mu_0 / self.lambda_mu - 1
            + torch.log(self.lambda_mu / self.lambda_mu_0)
        ) * float(math.prod(self.event_shape))
        for w in self.invU:
            KL = KL + w.KLqprior()
        return KL + self.alpha.KLqprior()

    def Elog_like(self, X):
        K = self.event_dim
        Xc = X - self.mu
        ELL = -0.5 * (
            self.EinvSigma()
            * Xc.reshape(Xc.shape + K * (1,))
            * Xc.reshape(Xc.shape[:-K] + K * (1,) + Xc.shape[-K:])
        ).sum(tuple(range(-2 * K, 0)))
        return (ELL - 0.5 * float(math.prod(self.event_shape)) * um.LOG2PI
                + 0.5 * self.ElogdetinvSigma())

    def mean(self):
        return self.mu

    def ElogdetinvSigmas(self):
        return torch.stack([w.ElogdetinvSigma() for w in self.invU], -1)

    def ElogdetinvSigma(self):
        res = float(math.prod(self.event_shape)) * self.alpha.loggeomean()
        for w in self.invU:
            res = res + w.ElogdetinvSigma()
        return res
