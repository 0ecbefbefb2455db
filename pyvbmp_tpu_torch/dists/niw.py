"""Normal-Inverse-Wishart conjugate prior for (mu, Sigma) of an MVN: the LDS
initial state x0 (counterpart of pyvbmp_tpu/dists/niw.py)."""
from __future__ import annotations

import torch

from .wishart import Wishart
from ..utils import math as um
from ..utils.torchutils import (
    Node, as_tensor, bquad, centered_scatter, node, normal, replace,
)


@node
class NormalInverseWishart(Node):
    lambda_mu_0: torch.Tensor
    lambda_mu: torch.Tensor
    mu_0: torch.Tensor
    mu: torch.Tensor
    invU: Wishart
    SExx: torch.Tensor
    SEx: torch.Tensor
    N: torch.Tensor
    event_shape: tuple
    batch_shape: tuple
    fixed_precision: bool

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0,
               fixed_precision=False, prior_parms=None, generator=None,
               dtype=None, device=None):
        pp = {"lambda_mu": 1.0, "mu": 0.0, "nu": None, "invU": None}
        if prior_parms is not None:
            pp.update(prior_parms)
        dim = event_shape[-1]
        event_dim = len(event_shape)
        shape = tuple(batch_shape) + tuple(event_shape)
        lambda_mu_0 = as_tensor(pp["lambda_mu"], dtype, device).expand(
            tuple(batch_shape) + (event_dim - 1) * (1,)
        ).clone()
        mu_0 = as_tensor(pp["mu"], dtype, device).expand(shape).clone()
        mu = mu_0 + normal(shape, generator, mu_0)
        invU = Wishart.create(
            tuple(event_shape) + (dim,), batch_shape, scale=scale,
            invU_0=pp["invU"], nu_0=pp["nu"], dtype=dtype, device=device,
        )
        return cls(
            lambda_mu_0=lambda_mu_0,
            lambda_mu=lambda_mu_0,
            mu_0=mu_0,
            mu=mu,
            invU=invU,
            SExx=mu_0.new_zeros(shape + (dim,)),
            SEx=torch.zeros_like(mu_0),
            N=mu_0.new_zeros(tuple(batch_shape) + tuple(event_shape[:-1])),
            event_shape=tuple(event_shape),
            batch_shape=tuple(batch_shape),
            fixed_precision=fixed_precision,
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

    def ss_update(self, SExx, SEx, N, lr=1.0, beta=0.0):
        store = (self.SExx, self.SEx, self.N)
        if beta is not None:
            store = (
                beta * self.SExx + SExx,
                beta * self.SEx + SEx,
                beta * self.N + N,
            )
            SExx, SEx, N = store
        lambda_mu = self.lambda_mu_0 + N
        mu = (self.lambda_mu_0[..., None] * self.mu_0 + SEx) / lambda_mu[..., None]
        invU_stat = (
            SExx
            + self.lambda_mu_0[..., None, None]
            * self.mu_0[..., :, None]
            * self.mu_0[..., None, :]
            - lambda_mu[..., None, None] * mu[..., :, None] * mu[..., None, :]
        )
        new_lambda_mu = lr * lambda_mu + (1 - lr) * self.lambda_mu
        new_mu = lr * mu + (1 - lr) * self.mu
        invU = self.invU
        if not self.fixed_precision:
            invU = invU.ss_update(invU_stat, N, lr)
        return replace(
            self,
            lambda_mu=new_lambda_mu,
            mu=new_mu,
            invU=invU,
            SExx=store[0],
            SEx=store[1],
            N=store[2],
        )

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        nd = self.event_dim + self.batch_dim
        sample_shape = X.shape[: X.ndim - nd]
        sdims = tuple(range(len(sample_shape)))
        if p is None:
            SExx, SEx, _ = centered_scatter(X, None, sdims)
            nsamp = 1
            for s in sample_shape:
                nsamp *= s
            N = X.new_full(self.batch_shape + self.event_shape[:-1], float(nsamp))
        else:
            pv = p.reshape(p.shape + (1,) * self.event_dim)
            SExx, SEx, _ = centered_scatter(X, pv, sdims)
            N = p.sum(sdims)
            N = N.reshape(N.shape + (1,) * (self.event_dim - 1))
        return self.ss_update(SExx, SEx, N, lr, beta)

    def Elog_like(self, X):
        out = (
            -0.5 * bquad(X, self.EinvSigma())
            + (X * self.EinvSigmamu()).sum(-1)
            - 0.5 * self.EXTinvUX()
        )
        out = out + 0.5 * self.ElogdetinvSigma() - 0.5 * self.dim * um.LOG2PI
        for _ in range(self.event_dim - 1):
            out = out.sum(-1)
        return out

    def KLqprior(self):
        KL = (
            0.5
            * (
                self.lambda_mu_0 / self.lambda_mu
                - 1
                + torch.log(self.lambda_mu / self.lambda_mu_0)
            )
            * self.dim
        )
        d = self.mu - self.mu_0
        KL = KL + 0.5 * self.lambda_mu_0 * (
            d[..., :, None] * d[..., None, :] * self.invU.mean()
        ).sum((-1, -2))
        for _ in range(self.event_dim - 1):
            KL = KL.sum(-1)
        return KL + self.invU.KLqprior()

    # -- expectations -----------------------------------------------------------
    def mean(self):
        return self.mu

    def ElogdetinvSigma(self):
        return self.invU.ElogdetinvSigma()

    def EinvSigmamu(self):
        return (self.invU.EinvSigma() * self.mu[..., None, :]).sum(-1)

    def EinvSigma(self):
        return self.invU.EinvSigma()

    def EXTinvUX(self):
        return (
            self.mu[..., :, None] * self.invU.EinvSigma() * self.mu[..., None, :]
        ).sum((-1, -2)) + self.dim / self.lambda_mu
