"""Wishart precision-matrix node (counterpart of pyvbmp_tpu/dists/wishart.py,
class Wishart only)."""
from __future__ import annotations

import math

import torch

from ..utils import math as um
from ..utils.linalg import psd_inv_and_logdet
from ..utils.torchutils import Node, as_tensor, node, replace


@node
class Wishart(Node):
    """q(Lambda) = Wishart(nu, U) stored as (invU, nu) with cached U, logdet.

    Natural-parameter update: invU <- invU_0 + SExx ; nu <- nu_0 + N.
    """

    invU_0: torch.Tensor
    nu_0: torch.Tensor
    logdet_invU_0: torch.Tensor
    invU: torch.Tensor
    U: torch.Tensor
    nu: torch.Tensor
    logdet_invU: torch.Tensor
    SExx: torch.Tensor
    N: torch.Tensor
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, invU_0=None,
               nu_0=None, dtype=None, device=None):
        if event_shape[-1] != event_shape[-2]:
            raise ValueError(f"Wishart needs a square event, got {event_shape}")
        dim = event_shape[-1]
        shape = tuple(batch_shape) + tuple(event_shape)
        if invU_0 is None:
            invU_0 = scale**2 * torch.eye(
                dim, dtype=dtype or torch.get_default_dtype(), device=device
            )
        invU_0 = as_tensor(invU_0, dtype, device).expand(shape).clone()
        nu_0 = as_tensor(dim + 2.0 if nu_0 is None else nu_0, dtype, device)
        nu_0 = nu_0.expand(shape[:-2]).clone()
        U, logdet_invU = psd_inv_and_logdet(invU_0)
        return cls(
            invU_0=invU_0,
            nu_0=nu_0,
            logdet_invU_0=logdet_invU,
            invU=invU_0,
            U=U,
            nu=nu_0,
            logdet_invU=logdet_invU,
            SExx=torch.zeros_like(invU_0),
            N=torch.zeros_like(nu_0),
            event_shape=tuple(event_shape),
            batch_shape=tuple(batch_shape),
        )

    @property
    def dim(self):
        return self.event_shape[-1]

    @property
    def event_dim(self):
        return len(self.event_shape)

    def log_mvgamma(self, nu):
        # the reference's log_mvgamma omits the pi constant
        return um.mvgammaln(nu, self.dim) - (
            self.dim * (self.dim - 1) / 4.0
        ) * math.log(math.pi)

    def log_mvdigamma(self, nu):
        return um.mvdigamma(nu, self.dim)

    def ss_update(self, SExx, N, lr=1.0, beta=None):
        store_SExx, store_N = self.SExx, self.N
        if beta is not None:
            store_SExx = SExx + beta * self.SExx
            store_N = N + beta * self.N
            SExx, N = store_SExx, store_N
        invU = lr * (self.invU_0 + SExx) + (1.0 - lr) * self.invU
        nu = lr * (self.nu_0 + N) + (1.0 - lr) * self.nu
        U, logdet_invU = psd_inv_and_logdet(invU)
        return replace(
            self, invU=invU, nu=nu, U=U, logdet_invU=logdet_invU,
            SExx=store_SExx, N=store_N,
        )

    def _nu(self):
        return self.nu.reshape(self.nu.shape + (1, 1))

    def mean(self):
        return self.U * self._nu()

    def meaninv(self):
        return self.invU / (self._nu() - self.dim - 1)

    def ESigma(self):
        return self.meaninv()

    def invEinvSigma(self):
        return self.invU / self._nu()

    def EinvSigma(self):
        return self.mean()

    def ElogdetinvSigma(self):
        return self.dim * um.LOG2 - self.logdet_invU + self.log_mvdigamma(self.nu / 2.0)

    def KLqprior(self):
        out = (
            self.nu_0 / 2.0 * (self.logdet_invU - self.logdet_invU_0)
            + self.nu / 2.0 * (self.invU_0 * self.U).sum((-1, -2))
            - self.nu * self.dim / 2.0
        )
        out = out + (
            self.log_mvgamma(self.nu_0 / 2.0)
            - self.log_mvgamma(self.nu / 2.0)
            + (self.nu - self.nu_0) / 2.0 * self.log_mvdigamma(self.nu / 2.0)
        )
        for _ in range(self.event_dim - 2):
            out = out.sum(-1)
        return out
