"""Normal-inverse-Wishart nodes over (dim, 1) column vectors (counterpart of
pyvbmp_tpu/dists/niw_vector_format.py):

- ``NormalInverseWishart_vector_format`` in natural parameters
  (lmbda, lmbda_mu, nu_star = nu - dim, xi = invU + lmbda mu mu^T);
- ``NormalInverseWishart_vector_format_invSigma``, which owns a full
  ``Wishart`` node for Sigma^-1 in place of xi;
- ``GMM_vector``, a ``Mixture`` of the first.
"""
from __future__ import annotations

import numpy as np
import torch

from .mixture import Mixture
from .wishart import Wishart
from ..utils import math as um
from ..utils.linalg import mT, psd_inv_and_logdet
from ..utils.torchutils import (
    Node, as_tensor, bquad, bweighted_sum, default_device, node, replace,
)


def _count(X, sample_shape, shape):
    """The number of samples as a tensor of ``shape``, like X."""
    return X.new_full(shape, float(np.prod(sample_shape, dtype=np.float64)))


def _moment_stats(node_, X, XXT, p):
    """(SExx, SEx, N) of samples X with second moments XXT (sample + batch +
    event), weighted by p (sample + batch) when given.  The weighted sums
    are ``bweighted_sum``s: a mixture's (samples, components, dim, dim)
    product is never made."""
    nd = node_.event_dim + node_.batch_dim
    sample_shape = X.shape[: X.ndim - nd]
    ns = len(sample_shape)
    sdims = tuple(range(ns))
    if p is None:
        N = _count(X, sample_shape, node_.batch_shape + node_.event_shape[:-2] + (1, 1))
        return XXT.sum(sdims), X.sum(sdims), N
    pv = p.reshape(p.shape + (1,) * node_.event_dim)
    return bweighted_sum(XXT, pv, ns), bweighted_sum(X, pv, ns), pv.sum(sdims)


class _NIWvfMoments:
    """Shapes and the expectations both NIW nodes read off mu, lmbda and
    their Sigma^-1 moments."""

    @property
    def dim(self):
        return self.event_shape[-2]

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    @property
    def mu(self):
        return self.lmbda_mu / self.lmbda

    @property
    def mu_0(self):
        return self.lmbda_mu_0 / self.lmbda_0

    def to_event(self, n):
        if n == 0:
            return self
        return replace(self, event_shape=self.batch_shape[-n:] + self.event_shape,
                       batch_shape=self.batch_shape[:-n])

    def raw_update(self, X, p=None, lr=1.0, beta=0.0):
        return self.ss_update(*_moment_stats(self, X, X @ mT(X), p), lr, beta)

    def update(self, pX, p=None, lr=1.0, beta=0.0):
        return self.ss_update(*_moment_stats(self, pX.mean(), pX.EXXT(), p), lr, beta)

    def Elog_like(self, X):
        # x' <Sigma^-1> x as one matmul over the samples (bquad) where X
        # broadcasts over the components, not a batched (1, d) @ (d, d) @
        # (d, 1) product a sample and component
        out = (
            -0.5 * bquad(X[..., 0], self.EinvSigma())[..., None, None]
            + (X * self.EinvSigmamu()).sum(-2, keepdim=True)
            - 0.5 * self.EXTinvUX()
        )
        out = out + 0.5 * self.ElogdetinvSigma() - 0.5 * self.dim * um.LOG2PI
        return out.sum(tuple(range(-self.event_dim, 0)))

    def _KL_mean(self):
        KL = 0.5 * (self.lmbda_0 / self.lmbda - 1 + torch.log(self.lmbda / self.lmbda_0)) \
            * self.dim
        d = self.mu - self.mu_0
        return KL + 0.5 * self.lmbda_0 * (mT(d) @ self.EinvSigma() @ d)

    def mean(self):
        return self.mu

    def EX(self):
        return self.mu

    def EXXT(self):
        return self.mu @ mT(self.mu) + self.ESigma() / self.lmbda

    def EinvSigmamu(self):
        return self.EinvSigma() @ self.mu

    def EinvUX(self):
        return self.EinvSigma() @ self.mu

    def EXTinvUX(self):
        return mT(self.mu) @ self.EinvSigma() @ self.mu + self.dim / self.lmbda

    def EXmMUTinvUXmMU(self):
        return self.dim / self.lmbda


@node
class NormalInverseWishart_vector_format(_NIWvfMoments, Node):
    lmbda_0: torch.Tensor
    lmbda_mu_0: torch.Tensor
    nu_star_0: torch.Tensor
    xi_0: torch.Tensor
    lmbda: torch.Tensor
    lmbda_mu: torch.Tensor
    nu_star: torch.Tensor
    xi: torch.Tensor
    U: torch.Tensor
    logdet_invU: torch.Tensor
    event_shape: tuple
    batch_shape: tuple
    fixed_precision: bool

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, fixed_precision=False,
               prior_parms=None, parms=None, dtype=None, device=None):
        dim = event_shape[-2]
        bshape = tuple(batch_shape) + tuple(event_shape[:-2])

        def build(pp):
            pp = pp or {}
            lmbda = as_tensor(pp.get("lambda", 1.0), dtype, device).expand(bshape + (1, 1))
            lmbda_mu = as_tensor(pp.get("lambda_mu", 0.0), dtype, device).expand(
                tuple(batch_shape) + tuple(event_shape))
            if pp.get("nu") is None:
                nu_star = as_tensor(1.0, dtype, device).expand(bshape + (1, 1))
                xi = scale**2 * torch.eye(dim, dtype=lmbda.dtype, device=device)
            else:
                nu_star = as_tensor(pp["nu"], dtype, device).expand(bshape + (1, 1)) - dim
                xi = as_tensor(pp["invU"], dtype, device)
            xi = lmbda_mu @ mT(lmbda_mu) / lmbda + xi.expand(bshape + (dim, dim))
            return lmbda.clone(), lmbda_mu.clone(), nu_star.clone(), xi

        lmbda_0, lmbda_mu_0, nu_star_0, xi_0 = build(prior_parms)
        lmbda, lmbda_mu, nu_star, xi = build(parms if parms is not None else prior_parms)
        new = cls(lmbda_0=lmbda_0, lmbda_mu_0=lmbda_mu_0, nu_star_0=nu_star_0, xi_0=xi_0,
                  lmbda=lmbda, lmbda_mu=lmbda_mu, nu_star=nu_star, xi=xi, U=None,
                  logdet_invU=None, event_shape=tuple(event_shape),
                  batch_shape=tuple(batch_shape), fixed_precision=fixed_precision)
        return new._with_expectations()

    @property
    def invU(self):
        return (self.xi - self.lmbda_mu @ mT(self.lmbda_mu) / self.lmbda
                + self.lmbda_mu_0 @ mT(self.lmbda_mu_0) / self.lmbda_0)

    @property
    def invU_0(self):
        return self.xi_0 - self.lmbda_mu_0 @ mT(self.lmbda_mu_0) / self.lmbda_0

    @property
    def nu(self):
        return self.nu_star + self.dim

    @property
    def nu_0(self):
        return self.nu_star_0 + self.dim

    def _with_expectations(self):
        U, logdet = psd_inv_and_logdet(self.invU)
        return replace(self, U=U, logdet_invU=logdet[..., None, None])

    def ss_update(self, SExx, SEx, N, lr=1.0, beta=0.0):
        """The natural-parameter blend."""
        keep, prior = 1 - lr * (1 - beta), lr * (1 - beta)
        xi, nu_star = self.xi, self.nu_star
        if not self.fixed_precision:
            xi = keep * self.xi + prior * self.xi_0 + lr * SExx
            nu_star = keep * self.nu_star + prior * self.nu_star_0 + lr * N
        lmbda = keep * self.lmbda + prior * self.lmbda_0 + lr * N
        lmbda_mu = keep * self.lmbda_mu + prior * self.lmbda_mu_0 + lr * SEx
        return replace(self, xi=xi, nu_star=nu_star, lmbda=lmbda,
                       lmbda_mu=lmbda_mu)._with_expectations()

    def KLqprior_Wishart(self):
        # evaluated in float64, as Wishart.KLqprior is: its terms cancel
        f = torch.float64
        nu = self.nu[..., 0, 0].to(f)
        nu_0 = self.nu_0[..., 0, 0].to(f)
        _, logdet_0 = psd_inv_and_logdet(self.invU_0)
        KL = nu_0 / 2.0 * (self.logdet_invU[..., 0, 0].to(f) - logdet_0.to(f))
        KL = KL + nu / 2.0 * (self.invU_0 * self.U).sum((-2, -1)).to(f) - nu * self.dim / 2.0
        KL = (KL + um.mvgammaln(nu_0 / 2.0, self.dim) - um.mvgammaln(nu / 2.0, self.dim)
              + (nu - nu_0) / 2.0 * um.mvdigamma(nu / 2.0, self.dim))
        return KL[..., None, None].to(self.nu_star.dtype)

    def KLqprior(self):
        KL = self._KL_mean() + self.KLqprior_Wishart()
        return KL.sum(tuple(range(-self.event_dim, 0)))

    def EinvSigma(self):
        return self.U * self.nu

    def ESigma(self):
        return self.invU / (self.nu - self.dim - 1)

    def ElogdetinvSigma(self):
        return (self.dim * um.LOG2 - self.logdet_invU
                + um.mvdigamma(self.nu[..., 0, 0] / 2.0, self.dim)[..., None, None])

    def logdetEinvSigma(self):
        return -self.logdet_invU + torch.log(self.nu)

    def logZ(self):
        out = -0.5 * self.dim * torch.log(self.lmbda) + 0.5 * self.dim * um.LOG2PI
        out = out + 0.5 * self.nu * self.dim * um.LOG2 - 0.5 * self.nu * self.logdet_invU
        out = out + um.mvgammaln(self.nu[..., 0, 0] / 2.0, self.dim)[..., None, None]
        return out.sum(tuple(range(-self.event_dim, 0)))


@node
class NormalInverseWishart_vector_format_invSigma(_NIWvfMoments, Node):
    """The NIW node that owns a full Wishart node for Sigma^-1."""

    lmbda_0: torch.Tensor
    lmbda_mu_0: torch.Tensor
    lmbda: torch.Tensor
    lmbda_mu: torch.Tensor
    invSigma: Wishart
    event_shape: tuple
    batch_shape: tuple
    fixed_precision: bool

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, fixed_precision=False,
               prior_parms=None, dtype=None, device=None):
        pp = prior_parms or {}
        dim = event_shape[-2]
        bshape = tuple(batch_shape) + tuple(event_shape[:-2])
        lmbda_0 = as_tensor(pp.get("lambda", 1.0), dtype, device).expand(
            bshape + (1, 1)).clone()
        lmbda_mu_0 = as_tensor(pp.get("lambda_mu", 0.0), dtype, device).expand(
            tuple(batch_shape) + tuple(event_shape)).clone()
        invSigma = Wishart.create(tuple(event_shape[:-1]) + (dim,), batch_shape, scale=scale,
                                  dtype=lmbda_0.dtype, device=device)
        return cls(lmbda_0=lmbda_0, lmbda_mu_0=lmbda_mu_0, lmbda=lmbda_0, lmbda_mu=lmbda_mu_0,
                   invSigma=invSigma, event_shape=tuple(event_shape),
                   batch_shape=tuple(batch_shape), fixed_precision=fixed_precision)

    def ss_update(self, SExx, SEx, N, lr=1.0, beta=0.0):
        if beta > 0.0:
            SEx = SEx + beta * (self.lmbda_mu - self.lmbda_mu_0)
            N = N + beta * (self.lmbda - self.lmbda_0)
            if not self.fixed_precision:
                SExx = SExx + beta * (
                    self.invSigma.invU - self.invSigma.invU_0
                    + self.lmbda_mu @ mT(self.mu) - self.lmbda_mu_0 @ mT(self.mu_0)
                )
        lmbda = (1 - lr) * self.lmbda + lr * (self.lmbda_0 + N)
        lmbda_mu = (1 - lr) * self.lmbda_mu + lr * (self.lmbda_mu_0 + SEx)
        new = replace(self, lmbda=lmbda, lmbda_mu=lmbda_mu)
        if not self.fixed_precision:
            SExx = SExx - lmbda_mu @ mT(new.mu) + self.lmbda_mu_0 @ mT(self.mu_0)
            new = replace(new, invSigma=self.invSigma.ss_update(SExx, N[..., 0, 0], lr=lr))
        return new

    def KLqprior(self):
        KL = self._KL_mean().sum(tuple(range(-self.event_dim, 0)))
        return KL + self.invSigma.KLqprior()

    def EinvSigma(self):
        return self.invSigma.EinvSigma()

    def ESigma(self):
        return self.invSigma.ESigma()

    def ElogdetinvSigma(self):
        return self.invSigma.ElogdetinvSigma()[..., None, None]


class GMM_vector(Mixture):
    """A Gaussian mixture over vector-format NIW components (the JAX
    package's working form of its reference's, which cannot be built).
    Data are (n, dim, 1)."""

    def __init__(self, nc, dim, *, generator=None, dtype=None, device=None):
        device = default_device(device)
        eye = torch.eye(dim, dtype=dtype or torch.get_default_dtype())
        dist = NormalInverseWishart_vector_format.create(
            (dim, 1), batch_shape=(nc,),
            prior_parms={"lambda": 1.0, "lambda_mu": 0.0, "nu": 2.0 + dim, "invU": eye},
            dtype=dtype, device=device,
        )
        super().__init__(dist, (nc,), generator=generator)

    def initialize(self, data, generator=None):
        """Seed the component means with random rows of ``data``, keeping
        invU = xi - lmbda_mu lmbda_mu^T / lmbda (+ the prior's term) as it
        was (the reference's initialize moves the mean alone, which leaves xi
        inconsistent)."""
        d = self.dist
        idx = torch.randint(0, data.shape[0], d.batch_shape, generator=generator)
        lmbda_mu = data[idx.to(data.device)] * d.lmbda
        xi = d.xi - d.lmbda_mu @ mT(d.lmbda_mu) / d.lmbda + lmbda_mu @ mT(lmbda_mu) / d.lmbda
        self.dist = replace(d, lmbda_mu=lmbda_mu, xi=xi)._with_expectations()
