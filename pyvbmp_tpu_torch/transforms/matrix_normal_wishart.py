"""Bayesian linear map Y = A X + U^{-1/2} eps with a MatrixNormal-Wishart
prior (counterpart of pyvbmp_tpu/transforms/matrix_normal_wishart.py), with
the JAX package's whole surface: ``mask`` (zero pattern on A, enforced by a
constrained least-squares solve), ``X_mask`` (input selection), ``pad_X``
(a bias column appended to X), the data- and message-valued updates, the
likelihoods and messages (``Elog_like``, ``Elog_like_given_pX_pY``,
``Elog_like_X``, ``Elog_like_X_given_pY``, ``forward``, ``Eforward``,
``backward``, ``predict``, ``postdict``) and the expectation suite.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..dists.wishart import Wishart
from ..utils import math as um
from ..utils.linalg import (
    block_precision_marginalizer,
    mT,
    outer,
    product,
    psd_inv,
    psd_inv_and_logdet,
    psd_logdet,
    psd_solve,
)
from ..utils.torchutils import (
    Node, as_tensor, batch_sum, bcontract_pp, bweighted_sum, node, normal, replace,
)


def _constrain_to_mask(mu, invV, EinvSigma, mask):
    """Constrained least squares scattering zeros into the ~mask entries of
    the posterior mean (reference MatrixNormalWishart.py:111-120)."""
    idx = np.where(~mask.reshape(-1))[0]
    if idx.size == 0:
        return mu
    V_full = psd_inv(invV)
    U_full = psd_inv(EinvSigma)
    n_, p_ = mask.shape[-2:]
    # Astar[i,j,k,l] = U[i,k] * V[j,l]
    Astar = (
        V_full[..., None, :, None, :] * U_full[..., :, None, :, None]
    ).reshape(V_full.shape[:-2] + (n_ * p_, n_ * p_))
    idx_t = torch.as_tensor(idx, device=mu.device)
    A_sub = Astar[..., idx_t[:, None], idx_t[None, :]]
    b = mu.reshape(mu.shape[:-2] + (n_ * p_,))[..., idx_t]
    g = psd_solve(A_sub, b[..., None])[..., 0]
    gamma = mu.new_zeros(mu.shape[:-2] + (n_ * p_,))
    gamma[..., idx_t] = g
    mu = mu - U_full @ gamma.reshape(mu.shape) @ V_full
    return mu * torch.as_tensor(mask, device=mu.device)


@node
class MatrixNormalWishart(Node):
    mu_0: torch.Tensor
    mu: torch.Tensor
    invV_0: torch.Tensor
    invV: torch.Tensor
    V: torch.Tensor
    logdetinvV: torch.Tensor
    logdetinvV_0: torch.Tensor
    invU: Wishart
    X_mask: torch.Tensor  # bool, or None
    SExx: torch.Tensor
    SEyx: torch.Tensor
    SEyy: torch.Tensor
    N: torch.Tensor
    event_shape: tuple
    batch_shape: tuple
    mask: np.ndarray  # static (n, p) bool pattern on A, or None
    fixed_precision: bool
    pad_X: bool  # the last column of A is a bias: X gets a 1 appended

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, scale=1.0,
               mask=None, X_mask=None, pad_X=False, fixed_precision=False,
               generator=None, dtype=None, device=None):
        n, p = event_shape[-2], event_shape[-1]
        event_shape = tuple(event_shape)
        batch_shape = tuple(batch_shape)
        mu_0 = as_tensor(0.0 if prior_parms is None else prior_parms["mu"],
                         dtype, device)
        if pad_X:
            p = p + 1
            event_shape = event_shape[:-1] + (p,)
            if mu_0.ndim != 0:
                mu_0 = torch.cat([mu_0, mu_0.new_zeros(mu_0.shape[:-1] + (1,))], -1)
        mu_0 = mu_0.expand(batch_shape + event_shape).clone()
        mu = normal(mu_0.shape, generator, mu_0) / np.sqrt(p) + mu_0
        eye = torch.eye(p, dtype=mu_0.dtype, device=device)
        invV_0 = eye.expand(batch_shape + event_shape[:-2] + (p, p)).clone()
        logdetinvV = mu_0.new_zeros(invV_0.shape[:-2])
        invU = Wishart.create(event_shape[:-2] + (n, n), batch_shape,
                              scale=scale, dtype=mu_0.dtype, device=device)
        V, invV = invV_0, invV_0
        if X_mask is not None:
            X_mask = np.asarray(X_mask)
            if pad_X:
                X_mask = np.concatenate(
                    [X_mask, np.ones(X_mask.shape[:-1] + (1,), bool)], -1
                )
            X_mask = torch.as_tensor(X_mask, device=device).bool()
            mu_0, mu = mu_0 * X_mask, mu * X_mask
            V = V * X_mask * mT(X_mask)
            invV = invV * X_mask * mT(X_mask)
        if mask is not None:
            mask = np.asarray(mask)
            if pad_X:
                mask = np.concatenate([mask, np.ones(mask.shape[:-1] + (1,), bool)], -1)
            mask = mask > 0
            m = torch.as_tensor(mask, device=device)
            mu_0, mu = mu_0 * m, mu * m
        return cls(
            mu_0=mu_0,
            mu=mu,
            invV_0=invV_0,
            invV=invV,
            V=V,
            logdetinvV=logdetinvV,
            logdetinvV_0=logdetinvV,
            invU=invU,
            X_mask=X_mask,
            SExx=torch.zeros_like(invV_0),
            SEyx=torch.zeros_like(mu_0),
            SEyy=mu_0.new_zeros(batch_shape + event_shape[:-2] + (n, n)),
            N=mu_0.new_zeros(batch_shape + event_shape[:-2]),
            event_shape=event_shape,
            batch_shape=batch_shape,
            mask=mask,
            fixed_precision=fixed_precision,
            pad_X=pad_X,
        )

    @property
    def n(self):
        return self.event_shape[-2]

    @property
    def p(self):
        return self.event_shape[-1]

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    @property
    def X_mask_static(self):
        """Whether an input selection X_mask is set."""
        return self.X_mask is not None

    def to_event(self, n):
        if n == 0:
            return self
        return replace(self, event_shape=self.batch_shape[-n:] + self.event_shape,
                       batch_shape=self.batch_shape[:-n], invU=self.invU.to_event(n))

    # -- natural parameter update ------------------------------------------------
    def _posterior_mean(self, SExx, SEyx):
        """(invV, mu) from the statistics, with the X_mask selection and the
        mask constraint applied."""
        if self.X_mask is not None:
            Xm = self.X_mask
            SExx = SExx * Xm * mT(Xm)
            SEyx = SEyx * Xm
            invV = self.invV_0 + SExx
            muinvV = self.mu_0 @ self.invV_0 + SEyx
            mu = (muinvV @ psd_inv(invV)) * Xm
        else:
            invV = self.invV_0 + SExx
            muinvV = self.mu_0 @ self.invV_0 + SEyx
            mu = mT(psd_solve(invV, mT(muinvV)))
        if self.mask is not None:
            mu = _constrain_to_mask(mu, invV, self.invU.EinvSigma(), self.mask)
        return invV, mu

    def _noise_update(self, invU, SEyy_c, N, lr):
        return invU.ss_update(SEyy_c, N, lr=lr, beta=None)

    def ss_update(self, SExx, SEyx, SEyy, N, lr=1.0, beta=None):
        store = (self.SExx, self.SEyx, self.SEyy, self.N)
        if beta is not None:
            store = (
                beta * self.SExx + SExx,
                beta * self.SEyx + SEyx,
                beta * self.SEyy + SEyy,
                beta * self.N + N,
            )
            SExx, SEyx, SEyy, N = store
        invV, mu = self._posterior_mean(SExx, SEyx)
        invU = self.invU
        if not self.fixed_precision:
            SEyy_c = (
                SEyy
                - mu @ invV @ mT(mu)
                + self.mu_0 @ self.invV_0 @ mT(self.mu_0)
            )
            invU = self._noise_update(invU, SEyy_c, N, lr)
        new_invV = lr * invV + (1.0 - lr) * self.invV
        new_invV = 0.5 * (new_invV + mT(new_invV))
        new_mu = lr * mu + (1.0 - lr) * self.mu
        if self.mask is not None:
            new_mu = new_mu * torch.as_tensor(self.mask, device=new_mu.device)
        V, logdetinvV = psd_inv_and_logdet(new_invV)
        if self.X_mask is not None:
            new_mu = new_mu * self.X_mask
        return replace(
            self,
            mu=new_mu,
            invV=new_invV,
            V=V,
            logdetinvV=logdetinvV,
            invU=invU,
            SExx=store[0],
            SEyx=store[1],
            SEyy=store[2],
            N=store[3],
        )

    def update(self, pX, pY, p=None, lr=1.0, beta=None):
        """Message-valued update: pX, pY provide EXXT()/EX()."""
        nd = self.event_dim + self.batch_dim
        sample_shape = pX.shape[: len(pX.shape) - nd]
        sdims = tuple(range(len(sample_shape)))
        if p is None:
            SExx = pX.EXXT().sum(sdims)
            SEyy = pY.EXXT().sum(sdims)
            SEyx = outer(pY.EX(), pX.EX()).sum(sdims)
            nsamp = float(np.prod(sample_shape, dtype=np.float64))
            N = SExx.new_full(self.batch_shape + self.event_shape[:-2], nsamp)
        else:
            pv = p.reshape(p.shape + self.event_dim * (1,))
            N = p.sum(sdims)
            ns = len(sdims)
            SExx = bweighted_sum(pX.EXXT(), pv, ns)
            SEyy = bweighted_sum(pY.EXXT(), pv, ns)
            SEyx = bweighted_sum(outer(pY.EX(), pX.EX()), pv, ns)
        pad = ()
        if self.pad_X:
            if p is None:
                pad = (pX.EX().sum(sdims), pY.EX().sum(sdims))
            else:
                pad = ((pX.EX() * pv).sum(sdims), (pY.EX() * pv).sum(sdims))
        return self._ss_update_sums(SExx, SEyx, SEyy, N, pad, lr, beta)

    def _ss_update_sums(self, SExx, SEyx, SEyy, N, pad, lr, beta):
        """``ss_update`` from sums over the samples, completed over a batch
        split across processes (``batch_sum``); ``pad`` holds the sums of X
        and Y that the pad_X bias column needs, () without it."""
        SExx, SEyx, SEyy, N, *pad = batch_sum(SExx, SEyx, SEyy, N, *pad)
        if self.pad_X:
            SExx, SEyx = self._pad_stats(SExx, SEyx, *pad, N)
        return self.ss_update(SExx, SEyx, SEyy, N, lr=lr, beta=beta)

    def _pad_stats(self, SExx, SEyx, SEx, SEy, N):
        """The statistics of the bias-padded X = (x, 1)."""
        SExx = torch.cat([SExx, SEx], -1)
        SEx1 = torch.cat([SEx, N.reshape(N.shape + (1, 1))], -2)
        SExx = torch.cat([SExx, mT(SEx1)], -2)
        SEyx = torch.cat([SEyx, SEy.expand(SEyx.shape[:-1] + (1,))], -1)
        return SExx, SEyx

    def raw_update(self, X, Y, p=None, lr=1.0, beta=None):
        """Update from data: X (sample + batch + (p, 1)), Y (... (n, 1)),
        optional per-sample weights p (sample + batch)."""
        nd = self.event_dim + self.batch_dim
        sample_shape = X.shape[: X.ndim - nd]
        sdims = tuple(range(len(sample_shape)))
        if p is None:
            SExx = (X * mT(X)).sum(sdims)
            SEyy = (Y * mT(Y)).sum(sdims)
            SEyx = (Y * mT(X)).sum(sdims)
            nsamp = float(np.prod(sample_shape, dtype=np.float64))
            N = SExx.new_full(self.batch_shape + self.event_shape[:-2], nsamp)
        else:
            pv = p.reshape(p.shape + self.event_dim * (1,))
            N = p.sum(sdims)
            SExx = (X * mT(X) * pv).sum(sdims)
            SEyy = (Y * mT(Y) * pv).sum(sdims)
            SEyx = (Y * mT(X) * pv).sum(sdims)
        pad = ()
        if self.pad_X:
            if p is None:
                pad = (X.sum(sdims), Y.sum(sdims))
            else:
                pad = ((X * pv).sum(sdims), (Y * pv).sum(sdims))
        return self._ss_update_sums(SExx, SEyx, SEyy, N, pad, lr, beta)

    # -- KL ------------------------------------------------------------------------
    def _quad_mu(self):
        """(mu - mu_0)' <invU> (mu - mu_0)."""
        d = self.mu - self.mu_0
        return mT(d) @ self.invU.EinvSigma() @ d

    def _KL_noise(self, KL):
        return KL + self.invU.KLqprior()

    def KLqprior(self):
        n = self.n
        KL = (
            n / 2.0 * self.logdetinvV
            - n / 2.0 * self.logdetinvV_0
            - n * self.p / 2.0
        )
        KL = KL + 0.5 * n * (self.invV_0 * self.V).sum((-1, -2))
        KL = KL + 0.5 * (self.invV_0 * self._quad_mu()).sum((-1, -2))
        for _ in range(self.event_dim - 2):
            KL = KL.sum(-1)
        return self._KL_noise(KL)

    # -- likelihoods and messages ------------------------------------------------------
    def Elog_like(self, X, Y):
        """E log p(Y | X) for data X (... (p, 1)) and Y (... (n, 1))."""
        ELL = -0.5 * (mT(Y) @ self.EinvSigma() @ Y)[..., 0, 0]
        if self.pad_X:
            EinvUX = self.EinvUX()
            EXTinvUX = self.EXTinvUX()
            ELL = ELL + (mT(Y) @ (EinvUX[..., :, :-1] @ X + EinvUX[..., :, -1:]))[
                ..., 0, 0
            ]
            ELL = ELL - 0.5 * (
                mT(X) @ EXTinvUX[..., :-1, :-1] @ X
                + 2 * EXTinvUX[..., -1:, :-1] @ X
                + EXTinvUX[..., -1:, -1:]
            )[..., 0, 0]
        else:
            ELL = ELL + (mT(Y) @ self.EinvUX() @ X)[..., 0, 0]
            ELL = ELL - 0.5 * (mT(X) @ self.EXTinvUX() @ X)[..., 0, 0]
        ELL = ELL + 0.5 * self.ElogdetinvSigma() - 0.5 * self.n * um.LOG2PI
        for _ in range(self.event_dim - 2):
            ELL = ELL.sum(-1)
        return ELL

    def Elog_like_given_pX_pY(self, pX, pY):
        ELL = -0.5 * bcontract_pp(pY.EXXT(), self.EinvSigma())
        if self.pad_X:
            EinvUX = self.EinvUX()
            EXTinvUX = self.EXTinvUX()
            ELL = ELL + (
                mT(pY.mean()) @ (EinvUX[..., :, :-1] @ pX.mean() + EinvUX[..., :, -1:])
            )[..., 0, 0]
            ELL = ELL - 0.5 * bcontract_pp(pX.EXXT(), EXTinvUX[..., :-1, :-1])
            ELL = ELL - (EXTinvUX[..., -1:, :-1] @ pX.mean())[..., 0, 0]
            ELL = ELL - 0.5 * EXTinvUX[..., -1, -1]
        else:
            ELL = ELL + product(product(mT(pY.mean()), self.EinvUX()), pX.mean())[..., 0, 0]
            ELL = ELL - 0.5 * bcontract_pp(pX.EXXT(), self.EXTinvUX())
        ELL = ELL + 0.5 * self.ElogdetinvSigma() - 0.5 * self.n * um.LOG2PI
        for _ in range(self.event_dim - 2):
            ELL = ELL.sum(-1)
        return ELL

    def Elog_like_X(self, Y):
        """Likelihood contribution to latent X in natural parameters."""
        Residual = (
            -0.5 * (mT(Y) @ self.EinvSigma() @ Y)[..., 0, 0]
            - 0.5 * self.n * um.LOG2PI
            + 0.5 * self.ElogdetinvSigma()
        )
        if self.pad_X:
            EXTinvUX = self.EXTinvUX()
            invSigma_x_x = EXTinvUX[..., :-1, :-1]
            invSigmamu_x = self.EXTinvU()[..., :-1, :] @ Y - EXTinvUX[..., :-1, -1:]
            Residual = Residual - 0.5 * EXTinvUX[..., -1, -1]
        else:
            invSigma_x_x = self.EXTinvUX()
            invSigmamu_x = self.EXTinvU() @ Y
        return invSigma_x_x, invSigmamu_x, Residual

    def _message_to_X(self, pY, bias_sign):
        """(invSigma_x_x, invSigmamu_x, residual) of the message to X given
        the message pY: Y integrated out of the joint, with the bias column
        of a ``pad_X`` map entering Y's linear term with ``bias_sign``."""
        if self.pad_X:
            EinvUX = self.EinvUX()
            EXTinvUX = self.EXTinvUX()
            PJ_y_x = -EinvUX[..., :, :-1]
            PJ_x_x = EXTinvUX[..., :-1, :-1]
            PmuJ_y = pY.EinvSigmamu() + bias_sign * EinvUX[..., :, -1:]
            PmuJ_x = -EXTinvUX[..., :-1, -1:]
            PJ11 = EXTinvUX[..., -1, -1]
        else:
            PJ_y_x = -self.EinvUX()
            PJ_x_x = self.EXTinvUX()
            PmuJ_y = pY.EinvSigmamu()
            PmuJ_x = PJ_x_x.new_zeros(PJ_x_x.shape[:-1] + (1,))
            PJ11 = 0.0
        invSigma_y_y, negBinvD, negCinvA, invSigma_x_x = block_precision_marginalizer(
            pY.EinvSigma() + self.EinvSigma(), PJ_y_x, mT(PJ_y_x), PJ_x_x
        )
        invSigmamu_y = PmuJ_y + negBinvD @ PmuJ_x
        invSigmamu_x = PmuJ_x + negCinvA @ PmuJ_y
        Res = (
            pY.Res()
            + 0.5 * (mT(invSigmamu_y) @ psd_solve(invSigma_y_y, invSigmamu_y))[..., 0, 0]
            - 0.5 * psd_logdet(invSigma_y_y)
            + 0.5 * pY.dim * um.LOG2PI
            + 0.5 * self.ElogdetinvSigma()
            - 0.5 * PJ11
        )
        return invSigma_x_x, invSigmamu_x, Res

    def Elog_like_X_given_pY(self, pY):
        """The message to X given the message pY, with its moments, and its
        residual.  With ``pad_X`` the bias enters with the opposite sign to
        ``backward``'s: the JAX package's sign, kept for parity."""
        invSigma_x_x, invSigmamu_x, Res = self._message_to_X(pY, -1.0)
        Sigma_x_x = psd_inv(invSigma_x_x)
        px = MVN_vf(invSigma=invSigma_x_x, invSigmamu=invSigmamu_x,
                    mu=Sigma_x_x @ invSigmamu_x, Sigma=Sigma_x_x)
        return px, Res - px.Res()

    def backward(self, pY, Res=0.0):
        """The message to X given the message pY, and its residual."""
        invSigma_x_x, invSigmamu_x, Res_x = self._message_to_X(pY, 1.0)
        pX = MVN_vf(invSigma=invSigma_x_x, invSigmamu=invSigmamu_x)
        return pX, Res + Res_x - pX.Res()

    def forward(self, pX):
        """Collapsed-VB forward message to Y given the message pX, with its
        exact residual (reference :303-328)."""
        mean = self.mean()
        V = self.V
        if self.pad_X:
            mean, bias = mean[..., :-1], mean[..., -1:]
            V, V_x1, V_11 = V[..., :-1, :-1], V[..., :-1, -1:], V[..., -1, -1]
        Sigma_star = psd_inv(pX.EinvSigma() + self.n * V)
        invSigmamu_star = pX.EinvSigmamu()
        if self.pad_X:
            invSigmamu_star = invSigmamu_star - self.n * V_x1
        mu_star = Sigma_star @ invSigmamu_star
        mu_y = mean @ mu_star
        if self.pad_X:
            mu_y = mu_y + bias
        Sigma_yy = mean @ Sigma_star @ mT(mean) + self.invEinvSigma()
        Res = -0.5 * (mT(pX.mean()) @ pX.EinvSigma() @ pX.mean())[..., 0, 0]
        Res = Res + 0.5 * (mT(invSigmamu_star) @ Sigma_star @ invSigmamu_star)[..., 0, 0]
        if self.pad_X:
            Res = Res - 0.5 * self.n * V_11
        eye = torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
        Res = Res - 0.5 * psd_logdet(self.n * V @ pX.ESigma() + eye)
        return MVN_vf(mu=mu_y, Sigma=Sigma_yy), Res

    def Eforward(self, pX):
        """The message to Y given the message pX at the mean of A."""
        if self.pad_X:
            invSigmamu = self.EinvUX()[..., :, :-1] @ pX.mean() + self.EinvUX()[..., :, -1:]
        else:
            invSigmamu = self.EinvUX() @ pX.mean()
        return MVN_vf(invSigma=self.EinvSigma(), invSigmamu=invSigmamu)

    def predict_given_pX(self, pX):
        return self.forward(pX)

    def postdict(self, Y):
        """The message to X given data Y, and its residual."""
        invSigma_x_x, invSigmamu_x, Residual = self.Elog_like_X(Y)
        pX = MVN_vf(invSigma=invSigma_x_x, invSigmamu=invSigmamu_x)
        return pX, Residual - pX.Res()

    def predict(self, X):
        """The message to Y given data X, and its residual."""
        if self.pad_X:
            EinvUX = self.EinvUX()
            EXTinvUX = self.EXTinvUX()
            invSigmamu_y = EinvUX[..., :, :-1] @ X + EinvUX[..., :, -1:]
            Res = (
                -0.5 * mT(X) @ EXTinvUX[..., :-1, :-1] @ X
                - EXTinvUX[..., -1:, :-1] @ X
                - 0.5 * EXTinvUX[..., -1:, -1:]
            )
        else:
            invSigmamu_y = self.EinvUX() @ X
            Res = -0.5 * mT(X) @ self.EXTinvUX() @ X
        Res = Res[..., 0, 0] + 0.5 * self.ElogdetinvSigma() - 0.5 * self.n * um.LOG2PI
        pY = MVN_vf(invSigma=self.EinvSigma(), invSigmamu=invSigmamu_y)
        return pY, Res - pY.Res()

    # -- point estimates -----------------------------------------------------------
    def mean(self):
        return self.mu

    def bias(self):
        return self.mu[..., -1:] if self.pad_X else self.mu.new_zeros(())

    def weights(self):
        return self.mu[..., :-1] if self.pad_X else self.mu

    def var(self):
        return torch.diagonal(self.ESigma(), dim1=-1, dim2=-2)[..., None] \
            * torch.diagonal(self.V, dim1=-1, dim2=-2)[..., None, :]

    # -- expectations --------------------------------------------------------------
    def EinvUX(self):
        return self.invU.EinvSigma() @ self.mu

    def EXTinvU(self):
        return mT(self.mu) @ self.invU.EinvSigma()

    def EXTAX(self, A):
        return self.EXmMUTAXmMU(A) + mT(self.mu) @ A @ self.mu

    def EXmMUTAXmMU(self, A):
        return self.V * (self.invU.ESigma() * A).sum((-1, -2))[..., None, None]

    def EXAXT(self, A):
        return self.EXmMUAXmMUT(A) + self.mu @ A @ mT(self.mu)

    def EXmMUAXmMUT(self, A):
        return self.ESigma() * (self.V * A).sum((-1, -2))[..., None, None]

    def EXTinvUX(self):
        return self.n * self.V + mT(self.mu) @ self.invU.EinvSigma() @ self.mu

    def EXinvVXT(self):
        return self.p * self.invU.ESigma() + self.mu @ self.invV @ mT(self.mu)

    def EXmMUTinvUXmMU(self):
        return self.n * self.V

    def EXmMUinvVXmMUT(self):
        return self.p * self.invU.ESigma()

    def EXTX(self):
        trace = torch.diagonal(self.invU.ESigma(), dim1=-2, dim2=-1).sum(-1)
        return self.V * trace[..., None, None] + mT(self.mu) @ self.mu

    def EXXT(self):
        trace = torch.diagonal(self.V, dim1=-2, dim2=-1).sum(-1)
        return trace[..., None, None] * self.invU.ESigma() + self.mu @ mT(self.mu)

    def ElogdetinvU(self):
        return self.invU.ElogdetinvSigma()

    def logdetEinvSigma(self):
        return self.invU.logdetEinvSigma()

    def ElogdetinvSigma(self):
        return self.invU.ElogdetinvSigma()

    def EinvSigma(self):
        return self.invU.EinvSigma()

    def ESigma(self):
        return self.invU.ESigma()

    def invEinvSigma(self):
        return self.invU.invEinvSigma()
