"""Diagonal-precision Normal-Gamma node, with no matrix inversions: the
isotropic GaussianMixtureModel's components (counterpart of
pyvbmp_tpu/dists/normal_gamma.py)."""
from __future__ import annotations

import torch

from .gamma import Gamma
from ..utils import math as um
from ..utils.torchutils import Node, as_tensor, node, normal, replace, uniform


@node
class NormalGamma(Node):
    lambda_mu_0: torch.Tensor
    lambda_mu: torch.Tensor
    mu_0: torch.Tensor
    mu: torch.Tensor
    gamma: Gamma
    SExx: torch.Tensor
    SEx: torch.Tensor
    N: torch.Tensor
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, prior_parms=None,
               generator=None, dtype=None, device=None):
        pp = {"lambda_mu": 1.0, "mu": 0.0, "alpha": 2.0, "beta": 2.0}
        if prior_parms is not None:
            pp.update(prior_parms)
        shape = tuple(batch_shape) + tuple(event_shape)
        lambda_mu_0 = as_tensor(pp["lambda_mu"], dtype, device).expand(
            tuple(batch_shape) + tuple(event_shape[:-1])
        ).clone()
        lambda_mu = lambda_mu_0 + uniform(lambda_mu_0.shape, generator, lambda_mu_0)
        mu_0 = as_tensor(pp["mu"], dtype, device).expand(shape).clone()
        gamma = Gamma.create(
            event_shape,
            batch_shape,
            prior_parms={
                "alpha": as_tensor(pp["alpha"], dtype, device),
                "beta": as_tensor(pp["beta"], dtype, device)
                * as_tensor(scale, dtype, device) ** 2,
            },
            generator=generator,
            dtype=dtype,
            device=device,
        )
        mu = mu_0 + normal(shape, generator, mu_0) / torch.sqrt(gamma.mean())
        return cls(
            lambda_mu_0=lambda_mu_0,
            lambda_mu=lambda_mu,
            mu_0=mu_0,
            mu=mu,
            gamma=gamma,
            SExx=mu_0.new_zeros(shape),
            SEx=mu_0.new_zeros(shape),
            N=mu_0.new_zeros(lambda_mu_0.shape),
            event_shape=tuple(event_shape),
            batch_shape=tuple(batch_shape),
        )

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
        return replace(
            self,
            event_shape=self.batch_shape[-n:] + self.event_shape,
            batch_shape=self.batch_shape[:-n],
            gamma=self.gamma.to_event(n),
        )

    def ss_update(self, SExx, SEx, N, lr=1.0, beta=None):
        store = (self.SExx, self.SEx, self.N)
        if beta is not None:
            store = (SExx + beta * self.SExx, SEx + beta * self.SEx, N + beta * self.N)
            SExx, SEx, N = store
        lambda_mu = self.lambda_mu_0 + N
        mu = (self.lambda_mu_0[..., None] * self.mu_0 + SEx) / lambda_mu[..., None]
        SExx_c = (
            SExx
            + self.lambda_mu_0[..., None] * self.mu_0 ** 2
            - lambda_mu[..., None] * mu ** 2
        )
        return replace(
            self,
            lambda_mu=lr * lambda_mu + (1 - lr) * self.lambda_mu,
            mu=lr * mu + (1 - lr) * self.mu,
            gamma=self.gamma.ss_update(0.5 * N[..., None], 0.5 * SExx_c, lr, beta),
            SExx=store[0],
            SEx=store[1],
            N=store[2],
        )

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        nd = self.event_dim + self.batch_dim
        sdims = tuple(range(X.ndim - nd))
        shape = self.batch_shape + self.event_shape[:-1]
        if p is None:
            SEx = X.sum(sdims)
            SExx = (X ** 2).sum(sdims)
            nsamp = 1
            for d in sdims:
                nsamp *= X.shape[d]
            N = X.new_full(shape, float(nsamp))
        else:
            N = p.sum(sdims)
            pv = p.reshape(p.shape + (1,) * self.event_dim)
            SEx = (X * pv).sum(sdims)
            SExx = (X ** 2 * pv).sum(sdims)
            N = N.reshape(N.shape + (1,) * (self.event_dim - 1)).expand(shape)
        return self.ss_update(SExx, SEx, N, lr, beta)

    def Elog_like(self, X):
        # the JAX package (and its reference) leave out the -d/2 log 2pi term
        out = -0.5 * ((X - self.mu) ** 2 * self.gamma.mean()).sum(-1) + 0.5 * (
            self.gamma.loggeomean().sum(-1)
        )
        for _ in range(self.event_dim - 1):
            out = out.sum(-1)
        return out

    def KLqprior(self):
        out = self.lambda_mu_0 / 2.0 * (
            (self.mu - self.mu_0) ** 2 * self.gamma.mean()
        ).sum(-1)
        out = out + self.dim / 2.0 * (
            self.lambda_mu_0 / self.lambda_mu
            - torch.log(self.lambda_mu_0 / self.lambda_mu)
            - 1
        )
        for _ in range(self.event_dim - 1):
            out = out.sum(-1)
        # the gamma KL summed over its batch dim and added to every batch
        # entry, as in the JAX package (and its reference)
        gkl = self.gamma.KLqprior()
        if gkl.ndim > 0:
            gkl = gkl.sum(-1)
        return out + gkl

    def mean(self):
        return self.mu

    def Emumu(self):
        return (
            self.mu[..., None, :] * self.mu[..., :, None]
            + self.ESigma() / self.lambda_mu[..., None, None]
        )

    def ElogdetinvSigma(self):
        return self.gamma.loggeomean().sum(-1)

    def EmuTinvSigmamu(self):
        return (self.mu ** 2 * self.gamma.mean()).sum(-1) + self.dim / self.lambda_mu

    def EXTinvUX(self):
        return self.EmuTinvSigmamu()

    def _eye(self):
        return torch.eye(self.dim, dtype=self.mu.dtype, device=self.mu.device)

    def EinvSigma(self):
        return self.gamma.mean()[..., None] * self._eye()

    def ESigma(self):
        return self.gamma.meaninv()[..., None] * self._eye()

    def Res(self):
        return (
            -0.5 * self.EXTinvUX()
            + 0.5 * self.ElogdetinvSigma()
            - 0.5 * self.dim * um.LOG2PI
        )

    def EinvSigmamu(self):
        return self.gamma.mean() * self.mu
