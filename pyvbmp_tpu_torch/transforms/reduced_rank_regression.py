"""Bayesian CCA / reduced-rank regression: y = A u, x = B u, u ~ N(0, I)
(counterpart of pyvbmp_tpu/transforms/reduced_rank_regression.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..dists.delta import Delta
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..dists.normal_gamma import NormalGamma
from ..utils import math as um
from ..utils.linalg import psd_inv, psd_logdet
from ..utils.torchutils import default_device
from ._fused import fused_fit
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart


class ReducedRankRegression:
    def __init__(self, n, p, dim, batch_shape=(), pad_X=False, independent=False,
                 generator=None, dtype=None, device=None):
        device = default_device(device)
        self.n, self.p, self.dim = n, p, dim
        self.event_dim = 2
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_shape = (dim, 1)
        cls = MatrixNormalGamma if independent else MatrixNormalWishart
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.A = cls.create((n, dim), self.batch_shape, pad_X=pad_X, **kw)
        self.B = cls.create((p, dim), self.batch_shape, pad_X=pad_X, **kw)
        self.U = NormalGamma.create((dim,), self.batch_shape, **kw)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.pu = None
        self.logZ = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the last q(u) is dropped); returns self."""
        self.A = self.A.to(device, dtype)
        self.B = self.B.to(device, dtype)
        self.U = self.U.to(device, dtype)
        self.pu = self.logZ = None
        return self

    def _joint_u_posterior(self, X, Y, nodes=None):
        A, B, U = nodes if nodes is not None else (self.A, self.B, self.U)
        invSigma, invSigmamu, Residual = B.Elog_like_X(X)
        invSigma_bw, invSigmamu_bw, Residual_bw = A.Elog_like_X(Y)
        invSigma = invSigma_bw + invSigma + U.EinvSigma()
        invSigmamu = invSigmamu_bw + invSigmamu + U.EinvSigmamu()[..., None]
        Residual = (Residual + Residual_bw + 0.5 * U.ElogdetinvSigma()
                    - 0.5 * self.dim * um.LOG2PI)
        Sigma = psd_inv(invSigma)
        mu = Sigma @ invSigmamu
        Residual_u = (-0.5 * (mu * invSigmamu).sum((-1, -2)) + 0.5 * psd_logdet(invSigma)
                      - 0.5 * self.dim * um.LOG2PI)
        pu = MVN_vf(mu=mu, Sigma=Sigma, invSigma=invSigma, invSigmamu=invSigmamu)
        return pu, Residual - Residual_u

    def _vb_step(self, nodes, X, Y, lr):
        """One VB sweep of (A, B, U) (reference
        ReducedRankRegression.raw_update:43-81 body)."""
        A, B, U = nodes
        pu, Residual = self._joint_u_posterior(X, Y, nodes=nodes)
        logZ = Residual.sum(0)
        ELBO = torch.sum(logZ.sum() - (A.KLqprior() + B.KLqprior() + U.KLqprior()))
        A = A.update(pu, Delta(Y), lr=lr)
        B = B.update(pu, Delta(X), lr=lr)
        SExx, SEx = pu.EXXT(), pu.EX()
        while SExx.ndim > self.event_dim + self.batch_dim:
            SExx = SExx.sum(0)
            SEx = SEx.sum(0)
        nsamp = float(np.prod(X.shape[: X.ndim - 2 - self.batch_dim], dtype=np.float64))
        N = SEx.new_full(self.U.batch_shape, nsamp)
        U = U.ss_update(torch.diagonal(SExx, dim1=-1, dim2=-2), SEx[..., 0], N, lr=lr)
        return (A, B, U), (ELBO, logZ, pu)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        (self.A, self.B, self.U), (self.logZ, self.pu), ELBOs = fused_fit(
            self, self._vb_step, (self.A, self.B, self.U), int(iters),
            X[..., None], Y[..., None], lr=lr,
        )
        # the JAX package (and its reference) record the trajectory only
        # under verbose; kept
        if verbose:
            for e in ELBOs.detach().to("cpu", torch.float64).tolist():
                print("Percent change in ELBO = ",
                      (e - self.ELBO_last) / abs(self.ELBO_last) * 100)
                self.ELBO_last = float(e)
                self.ELBO_save.append(float(e))

    def Elog_like(self, X, Y):
        pu, Residual = self._joint_u_posterior(X[..., None], Y[..., None])
        self.pu = pu
        self.logZ = Residual.sum(0)
        return Residual

    def KLqprior(self):
        return self.A.KLqprior() + self.B.KLqprior() + self.U.KLqprior()

    def EW(self):
        """The effective regression coefficients <A> <B>^+ (the JAX package's
        reading of the reference's expression, which does not type-check)."""
        return self.A.mean() @ torch.linalg.pinv(self.B.mean())

    def predict(self, X):
        X = X[..., None] if X.shape[-1] != 1 else X
        invSigma, invSigmamu, _ = self.B.Elog_like_X(X)
        invSigma = invSigma + self.U.EinvSigma()
        invSigmamu = invSigmamu + self.U.EinvSigmamu()[..., None]
        return self.A.predict_given_pX(MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu))

    def forward(self, pX):
        raise NotImplementedError

    def backward(self, pY):
        raise NotImplementedError
