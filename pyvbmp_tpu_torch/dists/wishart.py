"""Wishart precision-matrix nodes (counterpart of
pyvbmp_tpu/dists/wishart.py): ``Wishart``, stored as (invU, nu) with its
inverse and logdet cached, and ``WishartEigh``, stored as the
eigendecomposition invU = v diag(d) v^T, with its two constrained variants
``WishartUnitDet`` and ``WishartUnitTrace``.

Eigenvectors are unique only up to sign, and arbitrary inside a repeated
eigenvalue (``create`` starts every eigenvalue equal), so two eigh nodes
that hold the same matrix may differ in ``v``: compare ``d``, ``invU``,
``U`` and the expectations, never ``v``.
"""
from __future__ import annotations

import math

import torch

from ..utils import math as um
from ..utils.linalg import mT, psd_inv_and_logdet
from ..utils.torchutils import Node, as_tensor, node, replace, uniform


class _WishartMoments:
    """What both storages share: the shapes and the expectations, read off
    ``U``, ``invU``, ``logdet_invU`` and ``nu``."""

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
                       batch_shape=self.batch_shape[:-n])

    def log_mvgamma(self, nu):
        # the reference's log_mvgamma omits the pi constant
        return um.mvgammaln(nu, self.dim) - (
            self.dim * (self.dim - 1) / 4.0
        ) * math.log(math.pi)

    def log_mvdigamma(self, nu):
        return um.mvdigamma(nu, self.dim)

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

    def logdetEinvSigma(self):
        return -self.logdet_invU + torch.log(self.nu)

    def KLqprior(self):
        # Evaluated in float64 whatever the node's dtype: at nu ~ 1e4 (a
        # component that has seen many samples) its terms are ~nu dim / 2
        # and cancel to ~1e-3 of that, which would leave float32 ~2e-4 of
        # the KL.  The same arithmetic in a wider type: float64 results are
        # unchanged.
        f = torch.float64
        nu, nu_0 = self.nu.to(f), self.nu_0.to(f)
        out = (
            nu_0 / 2.0 * (self.logdet_invU.to(f) - self.logdet_invU_0.to(f))
            + nu / 2.0 * (self.invU_0.to(f) * self.U.to(f)).sum((-1, -2))
            - nu * self.dim / 2.0
        )
        out = out + (
            self.log_mvgamma(nu_0 / 2.0)
            - self.log_mvgamma(nu / 2.0)
            + (nu - nu_0) / 2.0 * self.log_mvdigamma(nu / 2.0)
        )
        for _ in range(self.event_dim - 2):
            out = out.sum(-1)
        return out.to(self.nu.dtype)

    def logZ(self):
        return (
            self.log_mvgamma(self.nu / 2.0)
            + 0.5 * self.nu * self.dim * um.LOG2
            - 0.5 * self.nu * self.logdet_invU
        )


@node
class Wishart(_WishartMoments, Node):
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


@node
class WishartEigh(_WishartMoments, Node):
    """Wishart stored as the eigendecomposition invU = v diag(d) v^T; the
    base of the UnitDet and UnitTrace variants.  ``create`` draws the
    initial nu from ``generator``, as the JAX package draws it from its
    key."""

    invU_0: torch.Tensor
    nu_0: torch.Tensor
    logdet_invU_0: torch.Tensor
    d: torch.Tensor
    v: torch.Tensor
    nu: torch.Tensor
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, generator=None, dtype=None,
               device=None):
        if event_shape[-1] != event_shape[-2]:
            raise ValueError(f"Wishart needs a square event, got {event_shape}")
        dim = event_shape[-1]
        shape = tuple(batch_shape) + tuple(event_shape)
        eye = torch.eye(dim, dtype=dtype or torch.get_default_dtype(), device=device)
        invU_0 = (scale**2 * eye).expand(shape).clone()
        d, v = torch.linalg.eigh(invU_0)
        nu_0 = as_tensor(dim + 2.0, dtype, device).expand(shape[:-2]).clone()
        nu = nu_0 * (1.0 + uniform(nu_0.shape, generator, nu_0))
        return cls(invU_0=invU_0, nu_0=nu_0, logdet_invU_0=torch.log(d).sum(-1), d=d, v=v,
                   nu=nu, event_shape=tuple(event_shape), batch_shape=tuple(batch_shape))

    @property
    def U(self):
        return self.v @ ((1.0 / self.d)[..., None] * mT(self.v))

    @property
    def invU(self):
        return self.v @ (self.d[..., None] * mT(self.v))

    @property
    def logdet_invU(self):
        return torch.log(self.d).sum(-1)

    def log_mvdigamma_prime(self, nu):
        return um.mvpolygamma1(nu, self.dim)

    def _base_ss_update(self, SExx, N, lr=1.0, beta=None):
        if beta is None:
            beta = 1.0 - lr
        SExx = SExx * (N > 1)[..., None, None]
        invU = (self.invU_0 + SExx) * lr + beta * self.invU
        nu = (self.nu_0 + N) * lr + beta * self.nu
        return self.nat_update(nu, invU)

    def ss_update(self, SExx, N, lr=1.0, beta=None):
        return self._base_ss_update(SExx, N, lr=lr, beta=beta)

    def nat_update(self, nu, invU):
        d, v = torch.linalg.eigh(0.5 * (invU + mT(invU)))
        return replace(self, d=d, v=v, nu=nu)

    def ETraceinvSigma(self):
        return self.nu * (1.0 / self.d).sum(-1)

    def ETraceSigma(self):
        return self.d.sum(-1) / (self.nu - self.dim - 1)


class WishartUnitDet(WishartEigh):
    """Wishart constrained so that <logdet Sigma^-1> = 0: a Newton solve on
    log nu after each natural-parameter update."""

    def ss_update(self, SExx, N, lr=1.0, beta=None, iters=4):
        new = self._base_ss_update(SExx, N, lr=lr, beta=beta)
        target = -new.dim * um.LOG2 + new.logdet_invU
        lognu = target / new.dim
        for _ in range(iters):
            nu = torch.exp(lognu)
            lognu = lognu + (target - new.log_mvdigamma(nu)) / (
                new.log_mvdigamma_prime(nu) * nu
            )
        return replace(new, nu=2.0 * torch.exp(lognu))


class WishartUnitTrace(WishartEigh):
    """Wishart with Tr(<Sigma^-1>) = dim: a Newton solve on a shift shared by
    a matrix's eigenvalues."""

    def ss_update(self, SExx, N, lr=1.0, beta=None, iters=8):
        new = self._base_ss_update(SExx, N, lr=lr, beta=beta)
        # solved in float64 whatever the node's dtype: a matrix whose Newton
        # step lands on the floor restarts 1e-6 above -dmin and leaves its
        # smallest eigenvalue ~1e-4 after 8 steps, a difference of O(1)
        # numbers that float32 gets ~1% wrong.  Float64 results are unchanged.
        d, nu, dim = new.d.to(torch.float64), new.nu.to(torch.float64), new.dim
        x = d.mean(-1)
        # the floor is the smallest eigenvalue of the whole batch, not of
        # each matrix: the JAX package's (and its reference's) choice, kept
        dmin = d.min()
        for _ in range(iters):
            f = nu * (1.0 / (d + x[..., None])).sum(-1)
            fprime = -nu * (1.0 / (d + x[..., None]) ** 2).sum(-1)
            x = x + (dim - f) / fprime
            x = torch.where(x < -dmin, -dmin + 1e-6, x)
        return replace(new, d=(d + x[..., None]).to(new.d.dtype))
