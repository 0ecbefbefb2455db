"""MVN with a per-dimension ARD Gamma precision prior: the weight prior of
the logistic regressions (counterpart of pyvbmp_tpu/dists/mvn_ard.py)."""
from __future__ import annotations

import torch

from .gamma import Gamma
from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_logdet
from ..utils.torchutils import Node, node, normal, replace, tsum


@node
class MVN_ard(Node):
    mu: torch.Tensor
    invSigma: torch.Tensor
    Sigma: torch.Tensor
    logdetinvSigma: torch.Tensor
    invSigmamu: torch.Tensor
    alpha: Gamma
    SEx: torch.Tensor
    SExx: torch.Tensor
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), scale=1.0, generator=None,
               dtype=None, device=None):
        if event_shape[-1] != 1:
            raise ValueError(f"MVN_ard needs a (..., dim, 1) event, got {event_shape}")
        dim = event_shape[-2]
        alpha = Gamma.create(
            event_shape, batch_shape,
            prior_parms={"alpha": 0.5, "beta": 0.5 * float(scale) ** 2},
            generator=generator, dtype=dtype, device=device,
        )
        like = alpha.alpha_0
        mu = normal(tuple(batch_shape) + tuple(event_shape), generator, like) * scale
        eye = torch.eye(dim, dtype=like.dtype, device=like.device) / scale**2
        invSigma = eye.expand(
            tuple(batch_shape) + tuple(event_shape[:-1]) + (dim,)
        ).clone()
        return cls(
            mu=mu,
            invSigma=invSigma,
            Sigma=invSigma,  # the reference sets Sigma = invSigma (MVN_ard.py:35)
            logdetinvSigma=psd_logdet(invSigma),
            invSigmamu=invSigma @ mu,
            alpha=alpha,
            SEx=torch.zeros_like(mu),
            SExx=torch.zeros_like(invSigma),
            event_shape=tuple(event_shape),
            batch_shape=tuple(batch_shape),
        )

    @property
    def dim(self):
        return self.event_shape[-2]

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
        )

    def ss_update(self, SExx, SEx, iters=2, lr=1.0, beta=None):
        """The inner ARD fixed point (reference dists/MVN_ard.py:50-73)."""
        store = (self.SExx, self.SEx)
        if beta is not None:
            store = (self.SExx * beta + SExx, self.SEx * beta + SEx)
            SExx, SEx = store
        eye = torch.eye(self.dim, dtype=SExx.dtype, device=SExx.device)
        invSigmamu = SEx
        invSigma = SExx + self.alpha.mean() * eye + 1e-6 * eye
        Sigma = psd_inv(invSigma)
        # the reference's first fixed-point step uses the stale
        # self.invSigmamu (MVN_ard.py:59); reproduced on purpose
        mu = Sigma @ self.invSigmamu
        alpha = self.alpha
        half = torch.full(alpha.alpha.shape, 0.5, dtype=SExx.dtype, device=SExx.device)
        for _ in range(iters):
            EXXT = torch.diagonal(Sigma, dim1=-1, dim2=-2)[..., None] + mu**2
            alpha = alpha.ss_update(half, 0.5 * EXXT, lr=lr, beta=beta)
            invSigma = SExx + alpha.mean() * eye
            Sigma = psd_inv(invSigma)
            mu = Sigma @ invSigmamu

        new_invSigma = (1 - lr) * self.invSigma + lr * invSigma
        new_invSigmamu = (1 - lr) * self.invSigmamu + lr * invSigmamu
        new_Sigma = psd_inv(new_invSigma)
        return replace(
            self,
            invSigma=new_invSigma,
            invSigmamu=new_invSigmamu,
            Sigma=new_Sigma,
            mu=new_Sigma @ new_invSigmamu,
            logdetinvSigma=psd_logdet(new_invSigma),
            alpha=alpha,
            SExx=store[0],
            SEx=store[1],
        )

    def KLqprior(self):
        ed = tuple(range(-self.event_dim, 0))
        KL = 0.5 * (self.mu**2 * self.alpha.mean()).sum(ed)
        KL = KL - 0.5 * self.alpha.loggeomean().sum(ed) + 0.5 * tsum(
            self.ElogdetinvSigma(), range(2 - self.event_dim, 0)
        )
        KL = KL + tsum(
            torch.diagonal(self.Sigma, dim1=-1, dim2=-2) * self.alpha.mean()[..., 0],
            range(1 - self.event_dim, 0),
        )
        return KL + self.alpha.KLqprior()

    # -- expectations ------------------------------------------------------------
    def mean(self):
        return self.mu

    def ESigma(self):
        return self.Sigma

    def EinvSigma(self):
        return self.invSigma

    def EinvSigmamu(self):
        return self.invSigmamu

    def ElogdetinvSigma(self):
        return self.logdetinvSigma

    def EX(self):
        return self.mu

    def EXXT(self):
        return self.Sigma + self.mu @ mT(self.mu)

    def EXTX(self):
        return self.Sigma.sum((-1, -2)) + (self.mu**2).sum(-2)[..., 0]

    def EXTinvUX(self):
        return (mT(self.mu) @ self.invSigma @ self.mu)[..., 0, 0]

    def Res(self):
        return (
            -0.5 * (self.mu * self.invSigmamu).sum((-1, -2))
            + 0.5 * self.logdetinvSigma
            - 0.5 * self.dim * um.LOG2PI
        )
