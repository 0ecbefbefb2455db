"""Nonlinear regression family (counterpart of
pyvbmp_tpu/transforms/nl_regression.py).  The port carries
``NLRegression_Multinomial`` only."""
from __future__ import annotations

import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils.linalg import mT
from ..utils.torchutils import default_device
from ._fused import fused_fit, record_elbos
from .matrix_normal_wishart import MatrixNormalWishart
from .mnlr import MultiNomialLogisticRegression


class NLRegression_Multinomial:
    """z ~ MNLR(x); y|z,x ~ MNW (reference NLRegression_Multinomial, which
    calls itself superseded by dMixtureofLinearTransforms)."""

    def __init__(self, n, p, mixture_dim, batch_shape=(), generator=None,
                 dtype=None, device=None):
        device = default_device(device)
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_dim = 2
        self.n, self.p, self.mixture_dim = n, p, mixture_dim
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.A = MatrixNormalWishart.create(
            (n, p), tuple(batch_shape) + (mixture_dim,),
            scale=1.0 / mixture_dim ** (1.0 / n), pad_X=True,
            generator=generator, dtype=dtype, device=device,
        )
        self.Z = MultiNomialLogisticRegression(
            mixture_dim, p, batch_shape=tuple(batch_shape), pad_X=True,
            generator=generator, dtype=dtype, device=device,
        )
        self.logZ = self.p = self.NA = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place; returns self."""
        self.A = self.A.to(device, dtype)
        self.Z.to(device, dtype)
        return self

    def _vb_step(self, nodes, X, AX, AY, lr):
        """One VB sweep of (A, Z.beta) (reference
        NLRegression_Multinomial.raw_update:25-45 body)."""
        A, zbeta = nodes
        Z = self.Z.with_beta(zbeta)
        log_p = A.Elog_like(AX, AY) + Z.log_predict(X)
        shift = log_p.max(-1, keepdim=True).values
        logZ = shift[..., 0] + torch.logsumexp(log_p - shift, -1)
        p = torch.exp(log_p - shift)
        p = p / p.sum(-1, keepdim=True)
        NA = p.sum(0)
        ELBO = torch.sum(logZ.sum() - (A.KLqprior().sum(-1) + Z.KLqprior()))
        A = A.raw_update(AX, AY, p=p, lr=lr)
        zbeta = Z.raw_update_beta(zbeta, X, p, lr=lr)
        return (A, zbeta), (ELBO, logZ, p, NA)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        lead = (self.batch_dim + 1) * (1,)
        AX = X[..., None].reshape(X.shape[:-1] + lead + (X.shape[-1], 1))
        AY = Y[..., None].reshape(Y.shape[:-1] + lead + (Y.shape[-1], 1))
        (self.A, zbeta), (self.logZ, self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step, (self.A, self.Z.beta), int(iters), X, AX, AY,
            lr=lr,
        )
        self.Z.beta = zbeta
        record_elbos(self, ELBOs, verbose)

    def predict(self, X):
        p = self.Z.predict(X)
        pv = p[..., None, None]
        pY = self.A.predict(X[..., None, :, None])[0]
        mu = (pY.mean() * pv).sum(-3)
        Sigma = (pY.EXXT() * pv).sum(-3) - mu @ mT(mu)
        return MVN_vf(mu=mu, Sigma=Sigma), p

    def ELBO(self):
        return self.logZ - self.KLqprior()

    def KLqprior(self):
        return self.A.KLqprior().sum(-1) + self.Z.KLqprior()
