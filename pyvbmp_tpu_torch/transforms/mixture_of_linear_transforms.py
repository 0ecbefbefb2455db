"""Mixture over K linear experts with a Dirichlet gate independent of X
(counterpart of pyvbmp_tpu/transforms/mixture_of_linear_transforms.py)."""
from __future__ import annotations

import torch

from ..dists.dirichlet import Dirichlet
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils.linalg import mT
from ..utils.torchutils import default_device, sum_leading
from ._fused import fused_fit, record_elbos
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart


class MixtureofLinearTransforms:
    def __init__(self, n, p, dim, batch_shape=(), pad_X=True, type="Wishart",
                 generator=None, dtype=None, device=None):
        device = default_device(device)
        self.n, self.p, self.dim = n, p, dim
        self.event_dim = 1
        self.event_shape = (dim,)
        self.batch_dim = len(batch_shape)
        self.batch_shape = tuple(batch_shape)
        cls = {"Wishart": MatrixNormalWishart, "Gamma": MatrixNormalGamma}[type]
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.W = cls.create(event_shape=(n, p), batch_shape=self.batch_shape + (dim,),
                            scale=1.0 / dim ** (1.0 / n), pad_X=pad_X, **kw)
        self.pi = Dirichlet.create((dim,), self.batch_shape, **kw)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.p = None
        self.logZ = None

    def to(self, device=None, dtype=None):
        """Move the nodes and the last assignments in place; returns self."""
        self.W = self.W.to(device, dtype)
        self.pi = self.pi.to(device, dtype)
        for name in ("p", "logZ"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device=device, dtype=dtype))
        return self

    def _assign(self, W, pi, X, Y, via_messages=False):
        if via_messages:
            log_p = W.Elog_like_given_pX_pY(X.unsqueeze(-3), Y.unsqueeze(-3))
        else:
            log_p = W.Elog_like(X[..., None, :, :], Y[..., None, :, :])
        log_p = log_p + pi.loggeomean()
        shift = log_p.max(-1, keepdim=True).values
        p = torch.exp(log_p - shift)
        logZ = p.sum(-1, keepdim=True)
        return p / logZ, torch.log(logZ[..., 0]) + shift[..., 0]

    def update_assignments(self, X, Y):
        self.p, self.logZ = self._assign(self.W, self.pi, X, Y)

    def update_assignments_given_pX_pY(self, pX, pY):
        self.p, self.logZ = self._assign(self.W, self.pi, pX, pY, via_messages=True)

    def _vb_step(self, nodes, X, Y, lr):
        """One VB sweep of (W, pi) (reference
        MixtureofLinearTransforms.raw_update:50-61 body)."""
        W, pi = nodes
        p, logZ = self._assign(W, pi, X, Y)
        KL = pi.KLqprior() + W.KLqprior().sum(-1)
        ELBO = torch.sum(sum_leading(logZ, self.batch_dim) - KL)
        pi = pi.ss_update(sum_leading(p, self.batch_dim + 1), lr=lr)
        W = W.raw_update(X[..., None, :, :], Y[..., None, :, :], p=p, lr=lr)
        return (W, pi), (ELBO, logZ, p)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        """``iters`` sweeps on data X (sample + batch + (p, 1)) and Y
        (sample + batch + (n, 1))."""
        (self.W, self.pi), (self.logZ, self.p), ELBOs = fused_fit(
            self, self._vb_step, (self.W, self.pi), int(iters), X, Y, lr=lr
        )
        record_elbos(self, ELBOs, verbose)

    def update(self, pX, pY, iters=1, lr=1.0, verbose=False):
        for _ in range(iters):
            self.update_assignments_given_pX_pY(pX, pY)
            ELBO = self.ELBO()
            self.pi = self.pi.ss_update(sum_leading(self.p, self.batch_dim + 1), lr=lr)
            self.W = self.W.update(pX.unsqueeze(-3), pY.unsqueeze(-3), p=self.p, lr=lr)
            if verbose:
                print("MixLinearTransform: Percent Change in ELBO = ",
                      (ELBO - self.ELBO_last) / abs(self.ELBO_last) * 100)
            self.ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO.sum()))

    def Elog_like_given_pX_pY(self, pX, pY):
        return (self.W.Elog_like_given_pX_pY(pX.unsqueeze(-3), pY.unsqueeze(-3))
                * self.p).sum(-1)

    def predict(self, X):
        """The moment-matched collapse of the experts' predictions, and the
        gate's responsibilities (reference MixtureofLinearTransforms.predict)."""
        pY, Res = self.W.predict(X[..., None, :, :])
        log_p = Res + self.pi.loggeomean()
        p = torch.exp(log_p - log_p.max(-1, keepdim=True).values)
        pv = (p / p.sum(-1, keepdim=True))[..., None, None]
        Sigma = ((pY.ESigma() + pY.mean() @ mT(pY.mean())) * pv).sum(-3)
        mu = (pY.mean() * pv).sum(-3)
        return MVN_vf(mu=mu, Sigma=Sigma - mu @ mT(mu)), pv[..., 0, 0]

    def KLqprior(self):
        return self.pi.KLqprior() + self.W.KLqprior().sum(-1)

    def ELBO(self):
        return sum_leading(self.logZ, self.batch_dim) - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)

    def mean(self):
        return self.p

    # -- expectations averaged over the experts --------------------------------------
    def event_average(self, A):
        p = self.p
        for _ in range(self.W.event_dim):
            p = p[..., None]
        out = A * p
        for _ in range(self.event_dim):
            out = out.sum(-self.W.event_dim - 1)
        return out

    def average(self, A):
        out = self.p * A
        for _ in range(self.event_dim):
            out = out.sum(-1)
        return out

    def EinvUX(self):
        return self.event_average(self.W.EinvUX())

    def EXTinvU(self):
        return self.event_average(self.W.EXTinvU())

    def EXTAX(self, A):
        return self.event_average(self.W.EXTAX(A))

    def EXAXT(self, A):
        return self.event_average(self.W.EXAXT(A))

    def EXTinvUX(self):
        return self.event_average(self.W.EXTinvUX())

    def EXinvVXT(self):
        return self.event_average(self.W.EXinvVXT())

    def EXmMUTinvUXmMU(self):
        return self.event_average(self.W.EXmMUTinvUXmMU())

    def EXmMUinvVXmMUT(self):
        return self.event_average(self.W.EXmMUinvVXmMUT())

    def EXTX(self):
        return self.event_average(self.W.EXTX())

    def EXXT(self):
        return self.event_average(self.W.EXXT())

    def EinvSigma(self):
        return self.event_average(self.W.EinvSigma())

    def ESigma(self):
        return self.event_average(self.W.ESigma())

    def ElogdetinvU(self):
        return self.average(self.W.invU.ElogdetinvSigma())

    def ElogdetinvSigma(self):
        return self.average(self.W.ElogdetinvSigma())

    def weights(self):
        return self.W.mu[..., :-1] if self.W.pad_X else self.W.mu

    def bias(self):
        return self.W.mu[..., -1] if self.W.pad_X else None
