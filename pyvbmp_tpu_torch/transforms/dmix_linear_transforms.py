"""Directed mixture of linear transforms (mixture of experts): the gate
p(z|x) is an MNLR, the experts are MatrixNormalWisharts with a bias column
(counterpart of pyvbmp_tpu/transforms/dmix_linear_transforms.py): the
data-valued path (``raw_update``, ``predict``, ``Elog_like``) and the
message-valued one (``update``, ``forward``, ``backward``,
``backward_mix``, ``postdict``, ``Elog_like_given_pX_pY``).
"""
from __future__ import annotations

import copy

import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils import math as um
from ..utils.linalg import mT, psd_logdet
from ..utils.torchutils import default_device
from ._fused import fused_fit
from .matrix_normal_wishart import MatrixNormalWishart
from .mnlr import MultiNomialLogisticRegression


class dMixtureofLinearTransforms:
    def __init__(self, n, p, mixture_dim, batch_shape=(), pad_X=True,
                 type="Wishart", fixed_precision=False, generator=None,
                 dtype=None, device=None):
        if type != "Wishart":
            raise ValueError(f"expert type {type!r} is not ported (only 'Wishart')")
        device = default_device(device)
        self.event_shape = (mixture_dim, n, p)
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_dim = 3
        self.n, self.p, self.mix_dim = n, p, mixture_dim
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

        self.A = MatrixNormalWishart.create(
            event_shape=(n, p), batch_shape=tuple(batch_shape) + (mixture_dim,),
            scale=1.0 / mixture_dim ** (1.0 / n), pad_X=pad_X,
            fixed_precision=fixed_precision, generator=generator, dtype=dtype,
            device=device,
        )
        self.pi = MultiNomialLogisticRegression(
            mixture_dim, p, batch_shape=tuple(batch_shape), pad_X=True,
            generator=generator, dtype=dtype, device=device,
        )
        self.p = None
        self.logZ = None
        self.NA = None

    def to(self, device=None, dtype=None):
        """Move the nodes and the last responsibilities in place; returns
        self."""
        self.A = self.A.to(device, dtype)
        self.pi.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device, dtype)
        return self

    def _vb_step_raw(self, nodes, X, AX, AY, p, lr):
        """One VB sweep of (A, pi.beta) (reference
        dMixtureofLinearTransforms.raw_update:37-56 body).  The ELBO is
        computed every sweep (the reference computes it only under verbose;
        the values are the same)."""
        A, pibeta = nodes
        pi = self.pi.with_beta(pibeta)
        log_p = A.Elog_like(AX, AY) + pi.log_predict(X)
        shift = log_p.max(-1, keepdim=True).values
        log_p = log_p - shift
        p_ass = torch.exp(log_p)
        p_ass = p_ass / p_ass.sum(-1, keepdim=True)
        logZ = (shift[..., 0] + torch.logsumexp(log_p, -1)).sum(0)
        KL = A.KLqprior().sum(-1) + pi.KLqprior()
        ELBO = torch.sum(logZ - KL)
        pibeta = pi.raw_update_beta(pibeta, X, p_ass, p=p, lr=lr)
        if p is None:
            A = A.raw_update(AX, AY, p=p_ass, lr=lr)
        else:
            A = A.raw_update(AX, AY, p=p_ass * p[..., None], lr=lr)
        return (A, pibeta), (ELBO, p_ass)

    def raw_update(self, X, Y, p=None, iters=1, lr=1.0, verbose=False):
        AX = X[..., None][..., None, :, :]  # sample x batch x 1 x p x 1
        AY = Y[..., None][..., None, :, :]
        (self.A, pibeta), (self.p,), ELBOs = fused_fit(
            self, self._vb_step_raw, (self.A, self.pi.beta), int(iters),
            X, AX, AY, p, lr=lr,
        )
        self.pi.beta = pibeta
        # The reference's defect (ADVICE.md, dMixtureofLinearTransforms.py:95),
        # kept on purpose: ELBO_save grows every sweep, but ELBO_last moves
        # only under verbose.
        for e in ELBOs.detach().to("cpu", torch.float64).tolist():
            if verbose:
                print(
                    "dMixture Percent Change in ELBO = ",
                    (e - self.ELBO_last) / abs(self.ELBO_last) * 100,
                )
                self.ELBO_last = float(e)
            self.ELBO_save.append(float(e))

    def with_nodes(self, A, pibeta):
        """Shallow copy carrying different (A, pi.beta) posteriors."""
        c = copy.copy(self)
        c.A = A
        c.pi = self.pi.with_beta(pibeta)
        return c

    def _vb_step_msg(self, nodes, pX, pY, pAX, pAY, p, lr):
        """One message-valued VB sweep of (A, pi.beta).  The reference
        computes this path's ELBO after the M-step (post-update KL); kept."""
        A, pibeta = nodes
        pi = self.pi.with_beta(pibeta)
        log_p = A.Elog_like_given_pX_pY(pAX, pAY) + pi.log_forward(pX)
        shift = log_p.max(-1, keepdim=True).values
        log_p = log_p - shift
        logZ = shift[..., 0] + torch.logsumexp(log_p, -1)
        p_ass = torch.exp(log_p)
        p_ass = p_ass / p_ass.sum(-1, keepdim=True)
        NA = p_ass.sum(0)
        pibeta = pi.update_beta(pibeta, pX, p_ass, p=p, lr=lr)
        if p is None:
            A = A.update(pAX, pAY, p=p_ass, lr=lr)
        else:
            A = A.update(pAX, pAY, p=p_ass * p[..., None], lr=lr)
        KL = A.KLqprior().sum(-1) + self.pi.with_beta(pibeta).KLqprior()
        ELBO = logZ.sum() - KL.sum()
        return (A, pibeta), (ELBO, logZ, p_ass, NA)

    def update(self, pX, pY, p=None, iters=1, lr=1.0, verbose=False):
        pAX = pX.unsqueeze(-3)
        pAY = pY.unsqueeze(-3)
        (self.A, pibeta), (self.logZ, self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step_msg, (self.A, self.pi.beta), int(iters),
            pX, pY, pAX, pAY, p, lr=lr,
        )
        self.pi.beta = pibeta
        for e in ELBOs.detach().to("cpu", torch.float64).tolist():
            if verbose:
                print(
                    "dMixLT Percent Change in ELBO: ",
                    (e - self.ELBO_last) / abs(self.ELBO_last),
                )
            self.ELBO_last = float(e)
            self.ELBO_save.append(float(e))

    def predict(self, X):
        p = self.pi.predict(X)
        pv = p[..., None, None]
        Xv = X[..., None][..., None, :, :]
        pY = self.A.predict(Xv)[0]
        Sigma = (pY.EXXT() * pv).sum(-3)
        mu = (pY.mean() * pv).sum(-3)
        Sigma = Sigma - mu @ mT(mu)
        return MVN_vf(mu=mu, Sigma=Sigma), p

    def forward(self, pX):
        p = self.pi.forward(pX)
        pY = self.A.forward(pX.unsqueeze(-3))[0]
        pv = p[..., None, None]
        mu = (pY.mean() * pv).sum(-3)
        Sigma = (pY.EXXT() * pv).sum(-3) - mu @ mT(mu)
        return MVN_vf(Sigma=Sigma, mu=mu)

    def forward_mix(self, pX):
        return self.A.forward(pX.unsqueeze(-3)), self.pi.forward(pX)

    def _class_one_hots(self, like):
        Z = torch.eye(self.mix_dim, dtype=like.dtype, device=like.device)
        return Z.reshape((self.mix_dim,) + (1,) * self.batch_dim + (self.mix_dim,))

    def backward(self, pY):
        pX, ResA = self.A.backward(pY.unsqueeze(-3))
        pXm, Res = self.pi.backward(self._class_one_hots(ResA), like_X=pX)
        log_p = Res + ResA
        p = torch.exp(log_p - log_p.max(-1, keepdim=True).values)
        p = p / p.sum(-1, keepdim=True)
        pv = p[..., None, None]
        invSigma = (pXm.EinvSigma() * pv).sum(-3)
        invSigmamu = (pXm.EinvSigmamu() * pv).sum(-3)
        lse = torch.logsumexp(log_p, -1, keepdim=True)
        return MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu), log_p - lse

    def backward_mix(self, pY):
        """Per-expert backward messages without collapsing the mixture
        (reference dMixtureofLinearTransforms.py:151-161, whose body reads
        ``p`` before assigning it; this is its documented intent, as in the
        JAX package).  Returns (pX_mix, p, Res): the mixture on axis -3 of
        pX_mix's parameters, responsibilities p, and
        Res = logsumexp(log_p) - pX_mix.Res() per component."""
        pXm, ResA = self.A.backward(pY.unsqueeze(-3))
        pXm, Res = self.pi.backward(self._class_one_hots(ResA), like_X=pXm)
        log_p = Res + ResA
        shift = log_p.max(-1, keepdim=True).values
        log_p = log_p - shift
        Res_total = shift[..., 0] + torch.logsumexp(log_p, -1)
        p = torch.exp(log_p)
        p = p / p.sum(-1, keepdim=True)
        return pXm, p, Res_total[..., None] - pXm.Res()

    def postdict(self, Y):
        """Invert the gate via MNLR.Elog_like_X (reference
        dMixLT.postdict:58-84)."""
        invSigma, invSigmamu, Res = self.A.Elog_like_X(Y[..., None, :][..., None])
        like_X = MVN_vf(
            invSigma=torch.movedim(invSigma[None], -3, -3 - self.batch_dim),
            invSigmamu=torch.movedim(invSigmamu, -3, -3 - self.batch_dim),
        )
        Res = torch.movedim(Res, -1, -1 - self.batch_dim)
        invSigma, invSigmamu, Sigma, mu, Res_z = self.pi.Elog_like_X(
            like_X, self._class_one_hots(Res), iters=4
        )
        Res = (
            Res
            + Res_z
            + 0.5 * (mu * invSigmamu).sum(-2)[..., 0]
            - 0.5 * psd_logdet(invSigma)
            + like_X.dim / 2.0 * um.LOG2PI
        )
        logZ = torch.logsumexp(Res, -1 - self.batch_dim, keepdim=True)
        p = torch.exp(Res - logZ)
        pv = p[..., None, None]
        invSigma = (invSigma * pv).sum(-3 - self.batch_dim)
        invSigmamu = (invSigmamu * pv).sum(-3 - self.batch_dim)
        return (
            MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu),
            logZ[..., 0].squeeze(-1) if logZ.ndim > 1 else logZ[..., 0],
            p,
        )

    def Elog_like_given_pX_pY(self, pX, pY):
        log_p = self.A.Elog_like_given_pX_pY(
            pX.unsqueeze(-3), pY.unsqueeze(-3)
        ) + self.pi.log_forward(pX)
        return torch.logsumexp(log_p, -1)

    def Elog_like(self, X, Y):
        log_p = self.A.Elog_like(
            X[..., None][..., None, :, :], Y[..., None][..., None, :, :]
        ) + self.pi.log_predict(X)
        return torch.logsumexp(log_p, -1)

    def KLqprior(self):
        return self.A.KLqprior().sum(-1) + self.pi.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)
