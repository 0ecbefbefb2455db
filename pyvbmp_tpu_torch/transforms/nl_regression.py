"""Nonlinear regression family (counterpart of
pyvbmp_tpu/transforms/nl_regression.py): ``NLRegression_full_rank``,
``NLRegression_low_rank``, ``NLRegression_Multinomial`` and the legacy
``NLRegression_orig`` (which the JAX package has and does not export).
None reaches a kernel."""
from __future__ import annotations

import torch

from ..dists.dirichlet import Dirichlet
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..dists.niw import NormalInverseWishart
from ..dists.normal_gamma import NormalGamma
from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_logdet
from ..utils.torchutils import default_device, replace
from ._fused import fused_fit, record_elbos
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart
from .mnlr import MultiNomialLogisticRegression


def _softmax(log_p):
    """The normalized exp of log_p over the last axis, shifted by its max."""
    p = torch.exp(log_p - log_p.max(-1, keepdim=True).values)
    return p / p.sum(-1, keepdim=True)


def _logsumexp(log_p):
    """logsumexp over the last axis, kept, shifted by the max as the JAX
    package writes it."""
    shift = log_p.max(-1, keepdim=True).values
    return torch.logsumexp(log_p - shift, -1, keepdim=True) + shift


def _append_one(u):
    """(..., h, 1) -> (..., h + 1, 1) with a trailing 1."""
    return torch.cat([u, u.new_ones(u.shape[:-2] + (1, 1))], -2)


def _collapse(mu_y, Sigma_y, p):
    """Moment-match the components (axis -3) weighted by p."""
    pv = p[..., None, None]
    Sigma_y = ((Sigma_y + mu_y @ mT(mu_y)) * pv).sum(-3)
    mu_y = (mu_y * pv).sum(-3)
    return MVN_vf(mu=mu_y, Sigma=Sigma_y - mu_y @ mT(mu_y))


def _lift(X, Y, batch_dim):
    """X, Y (sample, width) -> (sample, 1 x (batch_dim + 1), width, 1)."""
    for _ in range(batch_dim + 1):
        X, Y = X[..., None, :], Y[..., None, :]
    return X, X[..., None], Y[..., None]


class NLRegression_full_rank:
    """z ~ Cat(pi); x|z ~ NIW (NormalGamma when ``independent``);
    y|x,z ~ MNW with a bias column (reference NLRegression_full_rank)."""

    def __init__(self, n, p, mixture_dim, batch_shape=(), independent=False,
                 generator=None, dtype=None, device=None):
        device = default_device(device)
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.independent = independent
        kw = dict(generator=generator, dtype=dtype, device=device)
        mix = self.batch_shape + (mixture_dim,)
        self.A = MatrixNormalWishart.create((n, p), mix, scale=mixture_dim ** (-1.0 / n),
                                            pad_X=True, **kw)
        self.X = (NormalGamma if independent else NormalInverseWishart).create((p,), mix, **kw)
        self.pi = Dirichlet.create((mixture_dim,), self.batch_shape, **kw)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.logZ = self.p = self.NA = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the last assignments are dropped);
        returns self."""
        self.A, self.X, self.pi = (n.to(device, dtype) for n in (self.A, self.X, self.pi))
        self.logZ = self.p = self.NA = None
        return self

    def _vb_step(self, nodes, X, Xv, Yv, lr):
        """One VB sweep of (A, X, pi) (reference
        NLRegression_full_rank.raw_update:30-52 body)."""
        A, Xn, pi = nodes
        log_p = A.Elog_like(Xv, Yv) + Xn.Elog_like(X) + pi.loggeomean()
        logZ = torch.logsumexp(log_p, -1, keepdim=True)
        p = _softmax(log_p)
        NA = p.sum(0)
        KL = A.KLqprior().sum(-1) + Xn.KLqprior().sum(-1) + pi.KLqprior()
        ELBO = torch.sum(logZ.sum(0) - KL)
        pi = pi.ss_update(NA, lr)
        A = A.raw_update(Xv, Yv, p=p, lr=lr)
        Xn = Xn.raw_update(X, p=p, lr=lr)
        return (A, Xn, pi), (ELBO, logZ, p, NA)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        X, Xv, Yv = _lift(X, Y, self.batch_dim)
        (self.A, self.X, self.pi), (self.logZ, self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step, (self.A, self.X, self.pi), int(iters), X, Xv, Yv, lr=lr
        )
        record_elbos(self, ELBOs, verbose)

    def predict(self, X):
        p = _softmax(self.X.Elog_like(X[..., None, :]) + self.pi.loggeomean())
        EinvUX = self.A.EinvUX()
        if self.A.pad_X:
            invSigmamu_y = EinvUX[..., :-1] @ X[..., None, :, None] + EinvUX[..., -1:]
        else:
            invSigmamu_y = EinvUX @ X[..., None, :, None]
        pv = p[..., None, None]
        invSigma_y = (self.A.EinvSigma() * pv).sum(-3)
        invSigmamu_y = (invSigmamu_y * pv).sum(-3)
        Sigma_y = psd_inv(invSigma_y)
        return MVN_vf(mu=Sigma_y @ invSigmamu_y, Sigma=Sigma_y), p

    forward = predict

    def ELBO(self):
        return self.logZ.sum(0) - self.KLqprior()

    def KLqprior(self):
        return self.A.KLqprior().sum(-1) + self.X.KLqprior().sum(-1) + self.pi.KLqprior()


class NLRegression_low_rank:
    """Low-rank NL regression with a shared encoder W: u|z ~ NormalGamma,
    x|u ~ MNW(W) (MNG when ``independent``), y|u,z ~ MNW(A) with a bias
    column (reference NLRegression_low_rank)."""

    def __init__(self, n, p, hidden_dim, mixture_dim, batch_shape=(), independent=False,
                 generator=None, dtype=None, device=None):
        device = default_device(device)
        self.hidden_dim = hidden_dim
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.mixture_dim = mixture_dim
        self.independent = independent
        kw = dict(generator=generator, dtype=dtype, device=device)
        mix = self.batch_shape + (mixture_dim,)
        cls = MatrixNormalGamma if independent else MatrixNormalWishart
        self.W = cls.create((p, hidden_dim), self.batch_shape + (1,), **kw)
        self.A = MatrixNormalWishart.create((n, hidden_dim + 1), mix,
                                            scale=mixture_dim ** (-1.0 / n), **kw)
        self.U = NormalGamma.create((hidden_dim,), mix, **kw)
        self.pi = Dirichlet.create((mixture_dim,), self.batch_shape, **kw)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.logZ = self.p = self.NA = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the last assignments are dropped);
        returns self."""
        self.A, self.W, self.U, self.pi = (
            n.to(device, dtype) for n in (self.A, self.W, self.U, self.pi))
        self.logZ = self.p = self.NA = None
        return self

    def _vb_step(self, nodes, Xv, Yv, SExx, lr):
        """One VB sweep of (A, W, U, pi) (reference
        NLRegression_low_rank.raw_update:41-103 body)."""
        A, W, U, pi = nodes
        AXT = A.EXTinvUX()
        AXU = A.EXTinvU()
        invSigma_u_u = U.EinvSigma() + AXT[..., :-1, :-1] + W.EXTinvUX()
        invSigmamu_u = (U.EinvSigmamu()[..., None] + AXU[..., :-1, :] @ Yv
                        - AXT[..., :-1, -1:] + W.EXTinvU() @ Xv)
        Sigma_u_u = psd_inv(invSigma_u_u)
        mu_u = Sigma_u_u @ invSigmamu_u

        logZ = (
            -0.5 * mT(Yv) @ A.EinvSigma() @ Yv
            - 0.5 * mT(Xv) @ W.EinvSigma() @ Xv
            - 0.5 * AXT[..., -1:, -1:]
            + AXU[..., -1:, :] @ Yv
            + 0.5 * mT(mu_u) @ invSigma_u_u @ mu_u
        )
        logZ = (
            logZ[..., 0, 0]
            + 0.5 * A.ElogdetinvSigma()
            + 0.5 * U.ElogdetinvSigma()
            + 0.5 * W.ElogdetinvSigma()
            - 0.5 * psd_logdet(invSigma_u_u)
            - 0.5 * U.EXTinvUX()
        )
        log_p = logZ + pi.loggeomean()
        logZt = _logsumexp(log_p)[..., 0]
        p = _softmax(log_p)

        SEuu = Sigma_u_u + mu_u @ mT(mu_u)
        SEux = mu_u @ mT(Xv)
        mu_u1 = _append_one(mu_u)
        SEu1u1 = torch.cat([torch.cat([SEuu, mu_u], -1), mT(mu_u1)], -2)
        SEyy = Yv @ mT(Yv)
        SEyu1 = Yv @ mT(mu_u1)

        NA = p.sum(0)
        pv = p[..., None, None]
        SEu = (mu_u * pv).sum(0)
        SEuu = (SEuu * pv).sum(0)
        SEux = (SEux * pv).sum(0)
        SEu1u1 = (SEu1u1 * pv).sum(0)
        SEyy = (SEyy * pv).sum(0)
        SEyu1 = (SEyu1 * pv).sum(0)

        KL = A.KLqprior().sum(-1) + W.KLqprior().sum(-1) + U.KLqprior().sum(-1) \
            + pi.KLqprior()
        ELBO = torch.sum(logZt.sum(0) - KL)
        pi = pi.ss_update(NA, lr)
        A = A.ss_update(SEu1u1, SEyu1, SEyy, NA, lr)
        W = W.ss_update(SEuu.sum(-3, keepdim=True), mT(SEux.sum(-3, keepdim=True)), SExx,
                        NA.sum(-1, keepdim=True), lr)
        U = U.ss_update(torch.diagonal(SEuu, dim1=-1, dim2=-2), SEu[..., 0], NA, lr)
        return (A, W, U, pi), (ELBO, logZt, p, NA)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        _, Xv, Yv = _lift(X, Y, self.batch_dim)
        SExx = (Xv**2).sum(0)[..., 0] if self.independent else (Xv @ mT(Xv)).sum(0)
        (self.A, self.W, self.U, self.pi), (self.logZ, self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step, (self.A, self.W, self.U, self.pi), int(iters),
            Xv, Yv, SExx, lr=lr,
        )
        record_elbos(self, ELBOs, verbose)

    def predict(self, X):
        for _ in range(self.batch_dim + 1):
            X = X[..., None, :]
        Xv = X[..., None]
        invSigma_u_u = self.U.EinvSigma() + self.W.EXTinvUX()
        invSigmamu_u = self.U.EinvSigmamu()[..., None] + self.W.EXTinvU() @ Xv
        Sigma_u_u = psd_inv(invSigma_u_u)
        mu_u = Sigma_u_u @ invSigmamu_u

        logZ = -0.5 * mT(Xv) @ self.W.EinvSigma() @ Xv + 0.5 * mT(mu_u) @ invSigma_u_u @ mu_u
        logZ = (
            logZ[..., 0, 0]
            + 0.5 * self.U.ElogdetinvSigma()
            + 0.5 * self.W.ElogdetinvSigma()
            - 0.5 * psd_logdet(invSigma_u_u)
            - 0.5 * self.U.EXTinvUX()
        )
        log_p = logZ + self.pi.loggeomean()
        p = torch.exp(log_p - _logsumexp(log_p))
        mu_y = self.A.mu @ _append_one(mu_u)
        Sigma_y = (self.A.mu[..., :, :-1] @ Sigma_u_u @ mT(self.A.mu[..., :, :-1])
                   + self.A.ESigma())
        return _collapse(mu_y, Sigma_y, p), p, mu_u[..., 0]

    forward = predict

    def ELBO(self):
        return self.logZ.sum(0) - self.KLqprior()

    def KLqprior(self):
        return (self.A.KLqprior().sum(-1) + self.W.KLqprior().sum(-1)
                + self.U.KLqprior().sum(-1) + self.pi.KLqprior())


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


class NLRegression_orig:
    """Legacy low-rank NL regression whose latent noise q(Sigma_uu) is
    shared between the latent prior q(u|z) (a fixed-precision NIW) and the
    encoder W (reference transforms/NLRegression_orig.py, which its package
    does not export).  The reference aliases the two nodes; here U's
    ``invU`` is re-bound to W's after every update of W.

    u|x,z ~ N(mu_z + W x, Sigma_uu), y|u,z ~ N(A_z [u; 1], Sigma_z)."""

    def __init__(self, n, p, hidden_dim, mixture_dim, batch_shape=(), generator=None,
                 dtype=None, device=None):
        device = default_device(device)
        self.hidden_dim = hidden_dim
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.n, self.p, self.mixture_dim = n, p, mixture_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        mix = self.batch_shape + (mixture_dim,)
        self.W = MatrixNormalWishart.create((hidden_dim, p), self.batch_shape + (1,), **kw)
        self.A = MatrixNormalWishart.create((n, hidden_dim + 1), mix, **kw)
        self.U = NormalInverseWishart.create((hidden_dim,), mix, fixed_precision=True, **kw)
        self._share_invU()
        self.pi = Dirichlet.create((mixture_dim,), self.batch_shape, **kw)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        # p is the input width until a fit replaces it with the assignments,
        # as in the JAX package
        self.logZ = self.NA = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the last assignments are dropped);
        returns self."""
        self.W, self.A, self.U, self.pi = (
            n.to(device, dtype) for n in (self.W, self.A, self.U, self.pi))
        self._share_invU()
        self.logZ = self.NA = None
        self.p = self.W.p
        return self

    def _share_invU(self):
        """U's precision node is W's."""
        self.U = replace(self.U, invU=self.W.invU)

    def _vb_step(self, nodes, Xv, Yv, SExx, lr):
        """One VB sweep of (W, A, U, pi) (reference NLRegression_orig.py:21-106
        body), the shared q(Sigma_uu) re-bound inside."""
        W, A, U, pi = nodes
        U = replace(U, invU=W.invU)
        AXT = A.EXTinvUX()
        AXU = A.EXTinvU()
        invSigma_u_u = W.EinvSigma() + AXT[..., :-1, :-1]
        invSigmamu_u = (U.EinvSigmamu()[..., None] + W.EinvUX() @ Xv
                        + AXU[..., :-1, :] @ Yv - AXT[..., :-1, -1:])
        Sigma_u_u = psd_inv(invSigma_u_u)
        mu_u = Sigma_u_u @ invSigmamu_u

        Res = -0.5 * mT(Yv) @ A.EinvSigma() @ Yv - 0.5 * AXT[..., -1:, -1:] \
            + AXU[..., -1:, :] @ Yv
        Res = (Res - 0.5 * mT(Xv) @ W.EXTinvUX() @ Xv
               - U.mean()[..., None, :] @ W.EinvUX() @ Xv
               + 0.5 * mT(mu_u) @ invSigmamu_u)
        Res = (
            Res[..., 0, 0]
            + 0.5 * A.ElogdetinvSigma()
            + 0.5 * W.ElogdetinvSigma()
            - 0.5 * psd_logdet(invSigma_u_u)
            - 0.5 * U.EXTinvUX()
            - 0.5 * self.n * um.LOG2PI
        )
        log_p = Res + pi.loggeomean()
        logZk = _logsumexp(log_p)
        pr = torch.exp(log_p - logZk)
        logZ = logZk[..., 0].sum(0)
        NA = pr.sum(0)

        # U's KL holds the shared invU's (broadcast over the mixture); the
        # reference takes it out once "because invU is shared with W"
        KL = (A.KLqprior().sum(-1) + W.KLqprior().sum(-1) + U.KLqprior().sum(-1)
              + pi.KLqprior() - U.invU.KLqprior().sum(-1))
        ELBO = torch.sum(logZ.sum() - KL)

        pi = pi.ss_update(NA, lr)

        pv = pr[..., None, None]
        NAv = NA[..., None, None]
        SEuu = ((Sigma_u_u + mu_u @ mT(mu_u)) * pv).sum(0)
        SEu = (mu_u * pv).sum(0)
        SEu1u1 = torch.cat([torch.cat([SEuu, SEu], -1), mT(torch.cat([SEu, NAv], -2))], -2)
        SEyy = ((Yv @ mT(Yv)) * pv).sum(0)
        SEyu1 = torch.cat([((Yv @ mT(mu_u)) * pv).sum(0), (Yv * pv).sum(0)], -1)
        A = A.ss_update(SEu1u1, SEyu1, SEyy, NA, lr)

        # U's mean is updated by hand; its covariance rides along with W
        SEx = (Xv * pv).sum(0)
        ubar = U.mean()[..., None]
        SEdux = (((mu_u - ubar) @ mT(Xv)) * pv).sum(0).sum(-3, keepdim=True)
        SEdudu = (SEuu - SEu @ mT(ubar) - ubar @ mT(SEu)
                  + ubar @ mT(ubar) * NAv).sum(-3, keepdim=True)
        mu = ((SEu[..., 0] - (W.mean() @ SEx)[..., 0] + U.mu_0 * U.lambda_mu_0[..., None])
              / (U.lambda_mu_0[..., None] + NA[..., None]))
        W = W.ss_update(SExx, SEdux, SEdudu, NA.sum(-1, keepdim=True), lr)
        U = replace(U, lambda_mu=U.lambda_mu + lr * (NA + U.lambda_mu_0 - U.lambda_mu),
                    mu=U.mu + lr * (mu - U.mu), invU=W.invU)
        return (W, A, U, pi), (ELBO, logZ, pr, NA)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        _, Xv, Yv = _lift(X, Y, self.batch_dim)
        SExx = (Xv @ mT(Xv)).sum(0)
        (self.W, self.A, self.U, self.pi), (self.logZ, self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step, (self.W, self.A, self.U, self.pi), int(iters),
            Xv, Yv, SExx, lr=lr,
        )
        record_elbos(self, ELBOs, verbose)

    def predict(self, X):
        # one mixture-axis unsqueeze, as the JAX package has it
        Xv = X[..., None, :, None]
        invSigma_u_u = self.W.EinvSigma()
        invSigmamu_u = self.W.EinvSigma() @ self.U.mean()[..., None] + self.W.EinvUX() @ Xv
        Sigma_u_u = psd_inv(invSigma_u_u)
        mu_u = Sigma_u_u @ invSigmamu_u

        Res = (-0.5 * mT(Xv) @ self.W.EXTinvUX() @ Xv
               - self.U.mean()[..., None, :] @ self.W.EinvUX() @ Xv
               + 0.5 * mT(mu_u) @ invSigmamu_u)
        Res = (Res[..., 0, 0] + 0.5 * self.W.ElogdetinvSigma()
               - 0.5 * psd_logdet(invSigma_u_u) - 0.5 * self.U.EXTinvUX())
        p = _softmax(Res + self.pi.loggeomean())
        mu_y = self.A.mean() @ _append_one(mu_u)
        Sigma_y = self.A.ESigma() + self.A.mean()[..., :-1] @ Sigma_u_u @ mT(
            self.A.mean()[..., :-1])
        return _collapse(mu_y, Sigma_y, p), p

    forward = predict

    def ELBO(self):
        return self.logZ.sum() - self.KLqprior()

    def KLqprior(self):
        # U's KL holds the shared invU's; taken out once, as in the reference
        KL = self.A.KLqprior().sum(-1) + self.W.KLqprior().sum(-1) + self.U.KLqprior().sum(-1)
        return KL + self.pi.KLqprior() - self.U.invU.KLqprior().sum(-1)
