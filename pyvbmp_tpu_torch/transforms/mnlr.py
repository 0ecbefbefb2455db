"""Multinomial logistic regression through the Polya-Gamma /
Jaakkola-Jordan bound, stick-breaking over K-1 logits (counterpart of
pyvbmp_tpu/transforms/mnlr.py).

``raw_update`` keeps the JAX package's dispatch: unbatched, unweighted data
(``p is None``, no batch shape, X of shape (S, p)) goes through
``_raw_update_fast``, whose per-class scatter is ``ops.weighted_scatter``
(the CUDA kernel for a card tensor); everything else through
``raw_update_beta`` and its (S, n, p, p) outer-product tensor.  Every
method that multiplies matrices runs under ``highest_precision``: no TF32.
"""
from __future__ import annotations

import copy

import torch

from ..dists.mvn_ard import MVN_ard
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils import math as um
from ..utils.linalg import mT, psd_inv
from ..utils.torchutils import (
    batch_sum,
    bquad,
    default_device,
    highest_precision,
    normal,
    replace,
)


def _stick_breaking_stats(Y):
    """pgb (PG counts) and YmN = Y - N/2 over the first K-1 logits
    (reference MNLR.raw_update:50-52)."""
    N = Y.sum(-1, keepdim=True) - (torch.cumsum(Y, -1) - Y)
    YmN = Y - N / 2.0
    return N[..., :-1], YmN[..., :-1]


def _pg_c(q):
    """The Polya-Gamma c = sqrt(x' <w w'> x) from its quadratic form q.  q
    is >= 0, but in float32 a form near 0 (a sample on a class boundary,
    <w w'> ~ mu mu') can round below it; it is floored at the dtype's
    smallest normal number, where pgb / 2 / c * tanh(c / 2) is still
    pgb / 4, rather than giving NaN."""
    return torch.sqrt(q.clamp_min(torch.finfo(q.dtype).tiny))


def _log_cosh(x):
    """log cosh x for x >= 0, as x + log1p(exp(-2 x)) - log 2: cosh itself
    overflows float32 above x ~ 89 (sharp transitions, c = |w'x| in the
    hundreds), and the bound's 0 * inf for the sticks past a class would
    then give NaN."""
    return x + torch.log1p(torch.exp(-2.0 * x)) - um.LOG2


def _ones_col(X):
    return torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)


def _one_hots(n, batch_ndim, like):
    """eye(n) shaped (n, 1 x batch_ndim, n): every class as a one-hot Y."""
    Yt = torch.eye(n, dtype=like.dtype, device=like.device)
    return Yt.reshape((n,) + (1,) * batch_ndim + (n,))


class MultiNomialLogisticRegression:
    def __init__(self, n, p, batch_shape=(), pad_X=True, generator=None,
                 dtype=None, device=None):
        device = default_device(device)
        if pad_X:
            p = p + 1
        n = n - 1
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

    # -- helpers -----------------------------------------------------------------
    def _padded(self, X):
        if self.pad_X:
            return torch.cat([X, _ones_col(X)], -1)
        return X

    def _padded_moments(self, pX):
        """EX (p,1) and EXXT (p,p) with the bias row appended
        (reference MNLR.update:96-103)."""
        EXXT = pX.EXXT()[..., None, :, :]
        EX = pX.mean()[..., None, :, :]
        if self.pad_X:
            EXXT = torch.cat([EXXT, EX], -1)
            EX = torch.cat([EX, torch.ones_like(EX[..., :1, :])], -2)
            EXXT = torch.cat([EXXT, mT(EX)], -2)
        return EX, EXXT

    # -- updates (natural parameter, PG inner loop) --------------------------------
    def _raw_stats(self, X, Y, p):
        pgb, YmN = _stick_breaking_stats(Y)
        YmN = YmN[..., None, None]
        EX = self._padded(X)
        EX = EX[..., None, :, None]  # sample x batch x 1 x p x 1
        EXXT = EX * mT(EX)
        sdims = tuple(range(X.ndim - 1 - self.batch_dim))
        if p is None:
            SEyx = (YmN * EX).sum(sdims)
        else:
            SEyx = (YmN * EX * p[..., None, None, None]).sum(sdims)
        return pgb, YmN, EX, EXXT, SEyx, sdims

    def with_beta(self, beta_node):
        """Shallow copy carrying a different beta posterior (for the
        mixture shells' sweep steps)."""
        c = copy.copy(self)
        c.beta = beta_node
        return c

    @highest_precision
    def raw_update_beta(self, beta_node, X, Y, iters=2, p=None, lr=1.0,
                        beta=None):
        """PG-bound update of a beta node, returned (the functional core of
        raw_update).  Its sums over the samples are completed over a batch
        or time axis split across processes (``batch_sum``) at each
        iteration."""
        pgb, YmN, EX, EXXT, SEyx, sdims = self._raw_stats(X, Y, p)
        SEyx, = batch_sum(SEyx)
        new_beta = beta_node
        for _ in range(iters):
            pgc = _pg_c((new_beta.EXXT() * EXXT).sum((-1, -2)))
            Ew = (pgb / 2.0 / pgc * torch.tanh(pgc / 2.0))[..., None, None]
            if p is None:
                SExx = (Ew * EXXT).sum(sdims)
            else:
                SExx = (Ew * EXXT * p[..., None, None, None]).sum(sdims)
            SExx, = batch_sum(SExx)
            new_beta = new_beta.ss_update(SExx, SEyx, lr=lr, beta=beta)
        return new_beta

    def raw_update(self, X, Y, iters=2, p=None, lr=1.0, beta=None, verbose=False):
        if p is None and self.batch_dim == 0 and X.ndim == 2:
            return self._raw_update_fast(X, Y, iters=iters, lr=lr, beta=beta)
        self.beta = self.raw_update_beta(
            self.beta, X, Y, iters=iters, p=p, lr=lr, beta=beta
        )

    @highest_precision
    def _raw_update_fast(self, X, Y, iters=2, lr=1.0, beta=None):
        """The unbatched bulk-data case without the (S, n, p, p) tensor: the
        quadratic forms go through one (S, p) x (p, n p) matmul and the
        per-class scatter Sum_s Ew[s,k] x_s x_s^T through
        ``ops.weighted_scatter.weighted_outer``."""
        from ..ops.weighted_scatter import weighted_outer

        pgb, YmN = _stick_breaking_stats(Y)  # (S, n)
        EX = self._padded(X).contiguous()  # (S, p)
        S, pdim = EX.shape
        SEyx = (YmN[..., None] * EX[:, None, :]).reshape(S, -1).sum(0)
        SEyx = SEyx.reshape(self.n, pdim, 1)
        new_beta = self.beta
        for _ in range(iters):
            BBT = new_beta.EXXT()  # (n, p, p)
            # pgc^2 = einsum('sp,kpq,sq->sk') through one matmul
            XB = (EX @ BBT.permute(1, 0, 2).reshape(pdim, -1)).reshape(
                S, self.n, pdim
            )
            pgc = _pg_c((XB * EX[:, None, :]).sum(-1))
            Ew = pgb / 2.0 / pgc * torch.tanh(pgc / 2.0)  # (S, n)
            SExx = weighted_outer(EX, Ew.contiguous())  # (n, p, p)
            new_beta = new_beta.ss_update(SExx, SEyx, lr=lr, beta=beta)
        self.beta = new_beta

    @highest_precision
    def update_beta(self, beta_node, pX, pY, iters=2, p=None, lr=1.0,
                    beta=None):
        """Message-valued update of a beta node, returned (the functional
        core of update)."""
        pgb, YmN = _stick_breaking_stats(pY)
        YmN = YmN[..., None, None]
        EX, EXXT = self._padded_moments(pX)
        sdims = tuple(range(len(pX.shape) - 2 - self.batch_dim))
        if p is None:
            SEyx = (YmN * EX).sum(0)
        else:
            SEyx = (YmN * EX * p[..., None, None, None]).sum(sdims)
        new_beta = beta_node
        for _ in range(iters):
            pgc = _pg_c((new_beta.EXXT() * EXXT).sum((-1, -2)))
            Ew = (pgb / 2.0 / pgc * torch.tanh(pgc / 2.0))[..., None, None]
            if p is None:
                SExx = (Ew * EXXT).sum(sdims)
            else:
                SExx = (Ew * EXXT * p[..., None, None, None]).sum(sdims)
            new_beta = new_beta.ss_update(SExx, SEyx, lr=lr, beta=beta)
        return new_beta

    def update(self, pX, pY, iters=2, p=None, lr=1.0, beta=None, verbose=False):
        """Message-valued X update (reference MNLR.update:82-118)."""
        self.beta = self.update_beta(
            self.beta, pX, pY, iters=iters, p=p, lr=lr, beta=beta
        )

    # -- likelihoods ---------------------------------------------------------------
    def _bound(self, SEyxb, pgb, pgc):
        return (
            SEyxb.sum(-1)
            - (pgb * _log_cosh(0.5 * pgc)).sum(-1)
            - pgb.sum(-1) * um.LOG2
        )

    @highest_precision
    def Elog_like(self, X, Y):
        X = self._padded(X)
        pgb, YmN = _stick_breaking_stats(Y)
        Xr = X[..., None, :]  # sample x batch x 1 x p
        # YmN factored out of the sum over p: with a leading class axis on Y
        # (log_predict) no (classes, samples, n, p) product is made
        SEyxb = YmN * (Xr * self.beta.mean()[..., 0]).sum(-1)
        # x' <b b'> x for every class: one (samples, p) @ (p, n p) matmul for
        # unbatched weights (bquad), not a (p, p) @ (p, 1) product a sample
        pgc = _pg_c(bquad(Xr, self.beta.EXXT()))
        return self._bound(SEyxb, pgb, pgc)

    @highest_precision
    def Elog_like_given_pX_pY(self, pX, Y):
        EX, EXXT = self._padded_moments(pX)
        pgb, YmN = _stick_breaking_stats(Y)
        SEyxb = (YmN[..., None] * EX[..., 0] * self.beta.mean()[..., 0]).sum(-1)
        pgc = _pg_c((EXXT * self.beta.EXXT()).sum((-1, -2)))
        return self._bound(SEyxb, pgb, pgc)

    # -- latent-X message (reference MNLR.Elog_like_X :208-242) --------------------
    @highest_precision
    def Elog_like_X(self, like_X, pY, iters=2):
        pgb, YmN = _stick_breaking_stats(pY)

        BBT = self.beta.EXXT()
        pgc = _pg_c(BBT.sum((-1, -2)))
        Ew = pgb / 2.0 / pgc * torch.tanh(pgc / 2.0)
        bmean = self.beta.mean()

        invSigma = invSigmamu = Sigma = mu = None
        for _ in range(iters):
            if self.pad_X:
                invSigmamu = (
                    YmN[..., None, None] * bmean[..., :-1, -1:]
                    - Ew[..., None, None] * BBT[..., :-1, -1:]
                ).sum(-3)
                invSigmamu = like_X.EinvSigmamu() + invSigmamu
                invSigma = (Ew[..., None, None] * BBT[..., :-1, :-1]).sum(-3)
                invSigma = like_X.EinvSigma() + invSigma
                Sigma = psd_inv(invSigma)
                mu = Sigma @ invSigmamu
                pgc = _pg_c(
                    (
                        BBT[..., :-1, :-1] * (Sigma + mu @ mT(mu))[..., None, :, :]
                    ).sum((-1, -2))
                    + 2 * (BBT[..., -1:, :-1] @ mu[..., None, :, :])[..., 0, 0]
                    + BBT[..., -1, -1]
                )
            else:
                invSigmamu = (YmN[..., None, None] * bmean).sum(-3)
                invSigmamu = like_X.EinvSigmamu() + invSigmamu
                invSigma = (Ew[..., None, None] * BBT).sum(-3)
                invSigma = like_X.EinvSigma() + invSigma
                Sigma = psd_inv(invSigma)
                mu = Sigma @ invSigmamu
                pgc = _pg_c(
                    (BBT * (Sigma + mu @ mT(mu))[..., None, :, :]).sum((-1, -2))
                )
            Ew = pgb / 2.0 / pgc * torch.tanh(pgc / 2.0)

        if self.pad_X:
            # the reference's term ``beta.mean()[...,-1:,:-1]*mu`` indexes an
            # empty slice (MNLR.py:245), so only the bias survives; reproduced
            # on purpose
            Res = -pgb.sum(-1) * um.LOG2 + (YmN * bmean[..., -1, -1]).sum(-1)
        else:
            Res = -pgb.sum(-1) * um.LOG2 + (
                YmN * (bmean * mu[..., None, :, :]).sum((-1, -2))
            ).sum(-1)
        Res = Res - (pgb * _log_cosh(0.5 * pgc)).sum(-1) + like_X.Res()
        return invSigma, invSigmamu, Sigma, mu, Res

    @highest_precision
    def backward(self, pY, like_X=None):
        if like_X is None:
            p = self.p - int(self.pad_X)
            like = self.beta.mu
            lead = (pY.ndim - 1) * (1,)
            like_X = MVN_vf(
                invSigmamu=like.new_zeros(lead + (p, 1)),
                invSigma=torch.eye(p, dtype=like.dtype, device=like.device).expand(
                    lead + (p, p)
                ),
            )
        invSigma, invSigmamu, Sigma, mu, Res = self.Elog_like_X(like_X, pY)
        return MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu, Sigma=Sigma, mu=mu), Res

    # -- prediction -----------------------------------------------------------------
    @highest_precision
    def log_predict(self, X):
        """Per-class log-probability lower bound: Elog_like at each one-hot
        class over a leading class axis (reference MNLR.log_predict:244-249)."""
        Yt = _one_hots(self.n + 1, X.ndim - 1, X)
        return torch.movedim(self.Elog_like(X, Yt), 0, -1)

    @highest_precision
    def log_predict_1(self, X):
        """Equivalent cumsum form (reference MNLR.log_predict_1:285-304)."""
        X = self._padded(X)
        lnpsb = X @ mT(self.beta.mean()[..., 0])
        Xc = X[..., None, :, None]
        pgc = _pg_c((Xc * (self.beta.EXXT() @ Xc)).sum(-2)[..., 0])
        lnpsb_N = -_log_cosh(0.5 * pgc) - um.LOG2
        lnpsb_0 = -0.5 * lnpsb.sum(-1, keepdim=True) + lnpsb_N.sum(-1, keepdim=True)
        lnpsb = lnpsb - 0.5 * torch.cumsum(lnpsb, -1) + torch.cumsum(lnpsb_N, -1)
        return torch.cat([lnpsb, lnpsb_0], -1)

    @highest_precision
    def log_predict_2(self, X):
        """Third prediction bound (reference MNLR.log_predict_2:261-290):
        marginalizes the betas per stick exactly while using <w> from the
        PG fixed point for the quadratic term."""
        X = self._padded(X)
        Xr = X[..., None, :]
        psi_bar = (Xr * self.beta.mean()[..., 0]).sum(-1)
        Xc = X[..., None, :, None]
        pgc = _pg_c((Xc * (self.beta.EXXT() @ Xc)).sum(-2)[..., 0])
        Ew = 0.5 / pgc * torch.tanh(0.5 * pgc)
        psi_var = (Xc * (self.beta.ESigma() @ Xc)).sum((-2, -1))
        nat1_plus = 0.5 + psi_bar / psi_var
        nat1_minus = nat1_plus - 1.0
        nat2 = Ew + 1.0 / psi_var
        Res = _log_cosh(0.5 * pgc)
        lnpsb = (
            0.5 * nat1_plus**2 / nat2
            - 0.5 * torch.log(nat2)
            - 0.5 * psi_bar**2 / psi_var
            - 0.5 * torch.log(psi_var)
            - um.LOG2
            + Res
        )
        lnpsb_minus = lnpsb + 0.5 * (nat1_minus**2 - nat1_plus**2) / nat2
        lnp = torch.cat(
            [torch.zeros_like(lnpsb[..., :1]), torch.cumsum(lnpsb_minus, -1)], -1
        )
        return torch.cat([lnp[..., :-1] + lnpsb, lnp[..., -1:]], -1)

    @staticmethod
    def _normalize(lnp):
        p = torch.exp(lnp - lnp.max(-1, keepdim=True).values)
        return p / p.sum(-1, keepdim=True)

    @highest_precision
    def predict_2(self, X):
        return self._normalize(self.log_predict_2(X))

    @highest_precision
    def log_forward(self, pX):
        """log p(z|pX) via Elog_like_given_pX_pY at each one-hot class
        (reference MNLR.log_forward:253-258)."""
        Yt = _one_hots(self.n + 1, len(pX.shape) - 2, self.beta.mu)
        return torch.movedim(self.Elog_like_given_pX_pY(pX, Yt), 0, -1)

    def loggeomean(self, X):
        return self.log_predict(X)

    @highest_precision
    def predict(self, X):
        return self._normalize(self.log_predict(X))

    @highest_precision
    def forward(self, pX):
        return self._normalize(self.log_forward(pX))

    # -- bookkeeping -----------------------------------------------------------------
    def KLqprior(self):
        KL = self.beta.KLqprior()
        for _ in range(self.event_dim - 2):
            KL = KL.sum(-1)
        return KL

    def ELBO(self, X=None, Y=None):
        if X is not None:
            return self.Elog_like(X, Y).sum() - self.KLqprior()
        return self.ELBO_last

    def weights(self):
        mu = self.beta.mean()[..., :-1, 0] if self.pad_X else self.beta.mean()[..., 0]
        return 2 * mu - torch.cumsum(mu, -2)
