"""Multinomial logistic regression with the Bouchard bound: a global
per-sample alpha plus lambda(xi) quadratic weights (counterpart of
pyvbmp_tpu/transforms/mnlr_bouchard.py).  Every method that multiplies
matrices runs under ``highest_precision``: no TF32."""
from __future__ import annotations

import torch

from ..dists.mvn_ard import MVN_ard
from ..utils.linalg import mT
from ..utils.torchutils import default_device, highest_precision, normal, replace
from .mnlr import _ones_col, _one_hots


def lmbda(xi):
    return 0.25 / xi * torch.tanh(0.5 * xi)


def log_sigmoid(xi):
    return -torch.log1p(torch.exp(-xi))


class MultiNomialLogisticRegression_Bouchard:
    def __init__(self, n, p, batch_shape=(), pad_X=True, generator=None,
                 dtype=None, device=None):
        device = default_device(device)
        if pad_X:
            p = p + 1
        self.n = n
        self.p = p
        beta = MVN_ard.create(
            event_shape=(n, p, 1), batch_shape=tuple(batch_shape),
            generator=generator, dtype=dtype, device=device,
        )
        self.beta = replace(
            beta, mu=normal(beta.mu.shape, generator, beta.mu) / float(p) ** 0.5
        )
        self.pad_X = pad_X
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_shape = (n, p)
        self.event_dim = 2
        self.ELBO_last = -float("inf")

    def to(self, device=None, dtype=None):
        """Move the weight posterior in place; returns self."""
        self.beta = self.beta.to(device, dtype)
        return self

    def _padded(self, X):
        if self.pad_X:
            return torch.cat([X, _ones_col(X)], -1)
        return X

    def raw_update(self, X, Y, iters=4, p=None, lr=1.0, beta=None, verbose=False):
        self.beta = self.raw_update_beta(
            self.beta, X, Y, iters=iters, p=p, lr=lr, beta=beta
        )

    def _alpha_xi_sweeps(self, beta_node, EX, EXXT, N, SEyx, sdims, iters, p,
                         lr, beta):
        """The alpha/xi fixed point shared by raw_update_beta and update."""
        alpha = torch.full((1, 1, 1), (self.n - 2) / 4.0, dtype=EX.dtype,
                           device=EX.device)
        xi = torch.sqrt(
            (beta_node.EXXT() * EXXT).sum((-2, -1), keepdim=True)
            - 2.0 * alpha * (beta_node.EX() * EX).sum((-2, -1), keepdim=True)
            + alpha**2
        )
        new_beta = beta_node
        for _ in range(iters):
            alpha = (
                (self.n - 2) / 4.0
                + (lmbda(xi) * (new_beta.EX() * EX).sum((-2, -1), keepdim=True)).sum(
                    -3, keepdim=True
                )
            ) / lmbda(xi).sum(-3, keepdim=True)
            xi = torch.sqrt(
                (new_beta.EXXT() * EXXT).sum((-2, -1), keepdim=True)
                - 2.0 * alpha * (new_beta.EX() * EX).sum((-2, -1), keepdim=True)
                + alpha**2
            )
            if p is None:
                SExx = 2 * (N * lmbda(xi) * EXXT).sum(sdims)
                SEyx_star = 2 * (alpha * N * lmbda(xi) * EX).sum(sdims)
            else:
                pv = p[..., None, None, None]
                SExx = 2 * (lmbda(xi) * EXXT * pv).sum(sdims)
                SEyx_star = 2 * (alpha * N * lmbda(xi) * EX * pv).sum(sdims)
            new_beta = new_beta.ss_update(SExx, SEyx + SEyx_star, lr=lr, beta=beta)
        return new_beta

    @highest_precision
    def raw_update_beta(self, beta_node, X, Y, iters=4, p=None, lr=1.0,
                        beta=None):
        sdims = tuple(range(X.ndim - 1 - self.batch_dim))
        EX = self._padded(X)[..., None, :, None]
        EXXT = EX * mT(EX)
        N = Y.sum(-1, keepdim=True)[..., None, None]
        Yv = Y[..., None, None]
        if p is None:
            SEyx = ((Yv - 0.5 * N) * EX).sum(sdims)
        else:
            SEyx = ((Yv - 0.5 * N) * EX * p[..., None, None, None]).sum(sdims)
        return self._alpha_xi_sweeps(beta_node, EX, EXXT, N, SEyx, sdims, iters,
                                     p, lr, beta)

    @highest_precision
    def update(self, pX, Y, iters=1, p=None, lr=1.0, beta=None, verbose=False):
        """Message-valued X (reference Bouchard.update:100-140)."""
        sdims = tuple(range(len(pX.shape) - 2 - self.batch_dim))
        EXXT = pX.EXXT()[..., None, :, :]
        EX = pX.mean()[..., None, :, :]
        N = Y.sum(-1, keepdim=True)[..., None, None]
        Yv = Y[..., None, None]
        if self.pad_X:
            EXXT = torch.cat([EXXT, EX], -1)
            EX = torch.cat([EX, torch.ones_like(EX[..., :1, :])], -2)
            EXXT = torch.cat([EXXT, mT(EX)], -2)
        if p is None:
            SEyx = ((Yv - 0.5 * N) * EX).sum(sdims)
        else:
            SEyx = ((Yv - 0.5 * N) * EX * p[..., None, None, None]).sum(sdims)
        # the reference passes beta=0 on this path (Bouchard.py:140)
        self.beta = self._alpha_xi_sweeps(self.beta, EX, EXXT, N, SEyx, sdims,
                                          iters, p, lr, 0.0)

    def _ELL(self, Y, psi, psi2, iters):
        N = Y.sum(-1, keepdim=True)
        alpha = torch.full((1,), (self.n - 2) / 4.0, dtype=psi.dtype,
                           device=psi.device)
        xi = torch.sqrt(psi2 - 2.0 * alpha * psi + alpha**2)
        for _ in range(iters - 1):
            alpha = (
                (self.n - 2) / 4.0 + (lmbda(xi) * psi).sum(-1, keepdim=True)
            ) / lmbda(xi).sum(-1, keepdim=True)
            xi = torch.sqrt(psi2 - 2.0 * alpha * psi + alpha**2)
        ELL = ((Y - 0.5 * N) * psi).sum(-1) - (alpha * N)[..., 0]
        ELL = ELL + 0.5 * (N * (xi + alpha)).sum(-1)
        return ELL + (N * log_sigmoid(-xi)).sum(-1)

    @highest_precision
    def Elog_like_given_pX_pY(self, pX, Y, iters=2):
        """Bouchard ELL bound (reference Bouchard.py:178-218)."""
        bEX, bEXXT = self.beta.EX(), self.beta.EXXT()
        if not self.pad_X:
            Ephiphi = (bEXXT * pX.EXXT()[..., None, :, :]).sum((-2, -1))
            Ephi = (bEX * pX.mean()[..., None, :, :]).sum((-2, -1))
        else:
            Ephi = (bEX[..., :-1, :] * pX.mean()[..., None, :, :]).sum((-2, -1))
            Ephiphi = (bEXXT[..., :-1, :-1] * pX.EXXT()[..., None, :, :]).sum((-2, -1))
            Ephiphi = Ephiphi + 2 * Ephi + bEX[..., -1, -1]
            Ephi = Ephi + bEX[..., -1, -1]
        return self._ELL(Y, Ephi, Ephiphi, iters)

    @highest_precision
    def forward(self, pX):
        Yt = _one_hots(self.n, len(pX.shape) - 2, self.beta.mu)
        log_p = torch.movedim(self.Elog_like_given_pX_pY(pX, Yt), 0, -1)
        m = log_p.max(-1, keepdim=True).values
        Res = torch.log(torch.exp(log_p - m).sum(-1, keepdim=True)) + m
        return log_p - Res, Res[..., 0]

    @highest_precision
    def Elog_like(self, X, Y, iters=2):
        X = self._padded(X)
        Xr = X[..., None, :]
        psi = (Xr * self.beta.mean()[..., 0]).sum(-1)
        Xc = Xr[..., None]
        psi2 = (Xc * (self.beta.EXXT() @ Xc)).sum(-2)[..., 0]
        return self._ELL(Y, psi, psi2, iters)

    @highest_precision
    def log_predict(self, X):
        Yt = _one_hots(self.n, X.ndim - 1, X)
        return torch.movedim(self.Elog_like(X, Yt), 0, -1)

    @highest_precision
    def predict(self, X):
        lnp = self.log_predict(X)
        p = torch.exp(lnp - lnp.max(-1, keepdim=True).values)
        return p / p.sum(-1, keepdim=True)

    def KLqprior(self):
        KL = self.beta.KLqprior()
        for _ in range(self.event_dim - 2):
            KL = KL.sum(-1)
        return KL

    def weights(self):
        if self.pad_X:
            return self.beta.mean()[..., :-1, 0]
        return self.beta.mean()[..., 0]

    def bias(self):
        if self.pad_X:
            return self.beta.mean()[..., -1:, 0]
        return self.beta.mu.new_zeros(1)
