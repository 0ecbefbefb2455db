"""MatrixNormal with diagonal row noise via DiagonalWishart: the LDS dynamics
A (counterpart of pyvbmp_tpu/transforms/matrix_normal_gamma.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..dists.diagonal_wishart import DiagonalWishart
from ..utils.linalg import mT
from ..utils.torchutils import node, replace
from .matrix_normal_wishart import MatrixNormalWishart


@node
class MatrixNormalGamma(MatrixNormalWishart):
    uniform_precision: bool = False

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, scale=1.0,
               uniform_precision=False, mask=None, X_mask=None,
               fixed_precision=False, generator=None, dtype=None, device=None):
        base = MatrixNormalWishart.create(
            event_shape, batch_shape, prior_parms=prior_parms, scale=scale,
            mask=mask, X_mask=X_mask, fixed_precision=fixed_precision,
            generator=generator, dtype=dtype, device=device,
        )
        invU = DiagonalWishart.create(
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

    # -- expectations that differ from MNW ---------------------------------------
    def EinvUX(self):
        return self.invU.gamma.mean()[..., None] * self.mu

    def EXTinvUX(self):
        return self.n * self.V + mT(self.mu) @ (
            self.invU.gamma.mean()[..., None] * self.mu
        )

    def ElogdetinvSigma(self):
        return self.invU.gamma.loggeomean().sum(-1)

    def EinvSigma(self):
        return self.invU.mean()
