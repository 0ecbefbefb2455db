"""MatrixNormal with diagonal row noise via DiagonalWishart: the LDS dynamics
A, and an LDS observation model (counterpart of
pyvbmp_tpu/transforms/matrix_normal_gamma.py).  ``MatrixNormalGamma_UnitTrace``
takes its row precisions from ``DiagonalWishartUnitTrace``."""
from __future__ import annotations

import dataclasses

import torch

from ..dists.diagonal_wishart import DiagonalWishart, DiagonalWishartUnitTrace
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils.linalg import block_precision_marginalizer, mT
from ..utils.torchutils import node, replace
from .matrix_normal_wishart import MatrixNormalWishart


@node
class MatrixNormalGamma(MatrixNormalWishart):
    uniform_precision: bool = False
    _noise_cls = DiagonalWishart

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, scale=1.0,
               uniform_precision=False, mask=None, X_mask=None, pad_X=False,
               fixed_precision=False, generator=None, dtype=None, device=None):
        base = MatrixNormalWishart.create(
            event_shape, batch_shape, prior_parms=prior_parms, scale=scale,
            mask=mask, X_mask=X_mask, pad_X=pad_X, fixed_precision=fixed_precision,
            generator=generator, dtype=dtype, device=device,
        )
        invU = cls._noise_cls.create(
            base.event_shape[:-1], batch_shape, scale=scale,
            generator=generator, dtype=base.mu.dtype, device=device,
        )
        kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
        kw["invU"] = invU
        kw["uniform_precision"] = uniform_precision
        return cls(**kw)

    def _noise_update(self, invU, SEyy_c, N, lr):
        invU = invU.ss_update(
            torch.diagonal(SEyy_c, dim1=-2, dim2=-1), N[..., None], lr=lr
        )
        if self.uniform_precision:
            # the reference's "HACK" summing the gamma alphas
            g = invU.gamma
            invU = replace(invU, gamma=replace(g, alpha=g.alpha.sum(-1, keepdim=True)))
        return invU

    def _quad_mu(self):
        d = self.mu - self.mu_0
        return mT(d) @ (self.invU.gamma.mean()[..., None] * d)

    def _KL_noise(self, KL):
        n = self.n
        KL = KL + (self.invU.KLqprior() / n if self.uniform_precision
                   else self.invU.KLqprior())
        for _ in range(self.event_dim - 2):
            if KL.ndim > 0:
                KL = KL.sum(-1)
        return KL

    def forward(self, pX):
        """The message to Y given the message pX, in natural parameters;
        returns (pY, None): this path computes no residual."""
        if self.pad_X:
            EinvUX = self.EinvUX()
            EXTinvUX = self.EXTinvUX()
            PJ_y_x = -EinvUX[..., :, :-1]
            PJ_x_x = EXTinvUX[..., :-1, :-1] + pX.EinvSigma()
            PmuJ_y = EinvUX[..., :, -1:]
            PmuJ_x = pX.EinvSigmamu() - EXTinvUX[..., :-1, -1:]
        else:
            PJ_y_x = -self.EinvUX()
            PJ_x_x = self.EXTinvUX() + pX.EinvSigma()
            PmuJ_y = 0.0
            PmuJ_x = pX.EinvSigmamu()
        invSigma_y_y, negBinvD = block_precision_marginalizer(
            self.EinvSigma(), PJ_y_x, mT(PJ_y_x), PJ_x_x
        )[0:2]
        return MVN_vf(invSigma=invSigma_y_y, invSigmamu=PmuJ_y + negBinvD @ PmuJ_x), None

    # -- expectations that differ from MNW ---------------------------------------
    def EinvUX(self):
        return self.invU.gamma.mean()[..., None] * self.mu

    def _trace_noise(self, A):
        """sum_i <Sigma>_ii A_ii, batch-shaped with two trailing 1s."""
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        return (self.invU.gamma.meaninv() * diag).sum(-1)[..., None, None]

    def EXTAX(self, A):
        return self.V * self._trace_noise(A) + mT(self.mu) @ A @ self.mu

    def EXmMUTAXmMU(self, A):
        return self.V * self._trace_noise(A)

    def EXTX(self):
        return self.V * self.invU.gamma.meaninv().sum(-1)[..., None, None] \
            + mT(self.mu) @ self.mu

    def EXXT(self):
        trV = torch.diagonal(self.V, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        return trV * self.invU.ESigma() + self.mu @ mT(self.mu)

    def ElogdetinvU(self):
        return self.invU.gamma.loggeomean().sum(-1)

    def EXTinvUX(self):
        return self.n * self.V + mT(self.mu) @ (
            self.invU.gamma.mean()[..., None] * self.mu
        )

    def ElogdetinvSigma(self):
        return self.invU.gamma.loggeomean().sum(-1)

    def EinvSigma(self):
        return self.invU.mean()

    def ESigma(self):
        return self.invU.ESigma()

    def invEinvSigma(self):
        return self.invU.invEinvSigma()


@node
class MatrixNormalGamma_UnitTrace(MatrixNormalGamma):
    """MatrixNormalGamma with trace-constrained diagonal noise."""

    _noise_cls = DiagonalWishartUnitTrace
