"""Bayesian "transformer" stacks: observations soft-assigned to latents and
roles through mixtures of linear maps (counterpart of
pyvbmp_tpu/transforms/bayesian_transformers.py): the Generative and Focused
transformers, the Discrete alias of the Focused one, and the Chained
transformer's chain discovery.

Two departures from the JAX package, both on its reference's defects:

- ``GenerativeBayesianTransformer.raw_update(latent_iters=0)`` leaves the
  assignments unset and crashes there (``bayesian_transformers.py:102``);
  the port raises ``ValueError`` up front.
- The JAX package's multi-sweep fit stacks every sweep's auxiliary outputs
  (the assignments among them) before keeping the last; the port's
  ``_fused.fused_fit`` keeps only the last sweep's, so a fit holds one
  sweep's assignments, not ``iters`` of them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists.delta import Delta
from ..dists.dirichlet import Dirichlet
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..dists.niw_vector_format import NormalInverseWishart_vector_format
from ..utils import math as um
from ..utils.torchutils import default_device, sum_leading
from ._fused import fused_fit, record_elbos
from .dmix_linear_transforms import dMixtureofLinearTransforms
from .matrix_normal_wishart import MatrixNormalWishart


def _plogp(p):
    """p log p, 0 where p is 0."""
    return torch.where(p > 0, p * torch.log(torch.where(p > 0, p, torch.ones_like(p))),
                       torch.zeros_like(p))


class GenerativeBayesianTransformer:
    """p(y_i | x_z, role_i, z_i): observations cluster into mixture_dim
    latents, each observation playing one of role_dim roles (reference
    wip_GenerativeBayesianTransformer)."""

    def __init__(self, mixture_dim, role_dim, obs_dim, hidden_dim, batch_shape=(),
                 pad_X=False, generator=None, dtype=None, device=None):
        device = default_device(device)
        self.obs_dim = obs_dim
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_dim = 3
        self.role_dim = role_dim
        self.hidden_dim = hidden_dim
        self.mixture_dim = mixture_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.A = MatrixNormalWishart.create(
            (obs_dim, hidden_dim), batch_shape=(mixture_dim, role_dim),
            scale=1.0 / (role_dim * mixture_dim), pad_X=pad_X, **kw,
        )
        self.pi_role = Dirichlet.create((role_dim,), (mixture_dim,), **kw)
        self.pi_mix = Dirichlet.create((mixture_dim,), **kw)
        self.p = self.NA = self.pX = None
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the assignments and latents are
        dropped); returns self."""
        self.A = self.A.to(device, dtype)
        self.pi_role = self.pi_role.to(device, dtype)
        self.pi_mix = self.pi_mix.to(device, dtype)
        self.p = self.NA = self.pX = None
        return self

    def _eye(self):
        return torch.eye(self.hidden_dim, dtype=self.A.mu.dtype, device=self.A.mu.device)

    def _init_pX(self):
        return MVN_vf(invSigma=self._eye(),
                      invSigmamu=self.A.mu.new_zeros((self.hidden_dim, 1)))

    @staticmethod
    def _Yv(Y):
        return Y[..., None][..., None, None, :, :]  # obs x 1(mix) x 1(role) x d x 1

    def _assignments(self, A, pi_role, pi_mix, pX, Yv):
        log_p = (A.Elog_like_given_pX_pY(pX, Delta(Yv)) + pi_role.ElogX()
                 + pi_mix.ElogX()[..., None])
        logZ = um.stable_logsumexp(log_p, (-1, -2), keepdim=True)
        p = torch.exp(log_p - logZ)
        return p, sum_leading(p.sum(-3), 2), logZ

    def _latents(self, A, p, Yv):
        """The role- and mixture-averaged latent messages, one latent per
        component and sample, and their residual (reference
        wip_GBT.update_latents)."""
        invSigma, invSigmamu, Res = A.Elog_like_X(Yv)
        pv = p[..., None, None]
        # sum over roles (-3) and observations (-5), keep the mixture axis
        invSigma = (invSigma * pv).sum((-3, -5), keepdim=True) + self._eye()
        invSigmamu = (invSigmamu * pv).sum((-3, -5), keepdim=True)
        Res = (Res * p).sum((-3, -1), keepdim=True)
        pX = MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu)
        return pX, Res - pX.Res()

    def update_assignments(self, Y):
        if self.pX is None:
            self.pX = self._init_pX()
        self.p, self.NA, logZ = self._assignments(self.A, self.pi_role, self.pi_mix,
                                                  self.pX, self._Yv(Y))
        return logZ[..., 0, 0]

    def update_latents(self, Y):
        if self.p is None:
            self.update_assignments(Y)
        self.pX, Res = self._latents(self.A, self.p, self._Yv(Y))
        return Res

    def update_parms(self, Y, lr=1.0):
        self.A = self.A.update(self.pX, Delta(self._Yv(Y)), p=self.p, lr=lr)
        self.pi_role = self.pi_role.raw_update(self.NA, lr=lr)
        self.pi_mix = self.pi_mix.raw_update(self.NA.sum(-1), lr=lr)

    def _vb_step(self, nodes, Y, lr, latent_iters):
        """One VB sweep of (A, pi_role, pi_mix, pX) (reference wip_GBT
        raw_update body)."""
        A, pi_role, pi_mix, pX = nodes
        Yv = self._Yv(Y)
        for _ in range(latent_iters):
            p, NA, _ = self._assignments(A, pi_role, pi_mix, pX, Yv)
            pX, Res = self._latents(A, p, Yv)
            ELBO_res = Res.sum()
        KL = A.KLqprior().sum((-1, -2)) + pi_mix.KLqprior() + pi_role.KLqprior().sum(-1)
        ELBO = (ELBO_res - _plogp(p).sum()
                + (NA * (pi_mix.ElogX()[..., None] + pi_role.ElogX())).sum() - KL)
        A = A.update(pX, Delta(Yv), p=p, lr=lr)
        pi_role = pi_role.raw_update(NA, lr=lr)
        pi_mix = pi_mix.raw_update(NA.sum(-1), lr=lr)
        return (A, pi_role, pi_mix, MVN_vf(invSigma=pX.invSigma, invSigmamu=pX.invSigmamu)), \
            (ELBO, p, NA)

    def raw_update(self, Y, iters=1, latent_iters=1, lr=1.0, verbose=False):
        """``iters`` sweeps on Y (sample x observations x obs_dim), each with
        ``latent_iters`` >= 1 rounds of assignments and latents."""
        if int(latent_iters) < 1:
            # the JAX package's sweep leaves p and NA unset at 0 and fails
            # on them (bayesian_transformers.py:102)
            raise ValueError(f"latent_iters must be >= 1, got {latent_iters}")
        if self.pX is None:
            pX0 = self._init_pX()
            shape = tuple(Y.shape[:-2]) + (1, self.mixture_dim, 1)
            h = self.hidden_dim
            self.pX = MVN_vf(invSigma=pX0.invSigma.expand(shape + (h, h)),
                             invSigmamu=pX0.invSigmamu.expand(shape + (h, 1)))

        def step(nodes, Y, lr):
            return self._vb_step(nodes, Y, lr, int(latent_iters))

        nodes = (self.A, self.pi_role, self.pi_mix, self.pX)
        (self.A, self.pi_role, self.pi_mix, self.pX), (self.p, self.NA), ELBOs = fused_fit(
            self, step, nodes, int(iters), Y, lr=lr
        )
        record_elbos(self, ELBOs, verbose)

    def KLqprior(self):
        return (self.A.KLqprior().sum((-1, -2)) + self.pi_mix.KLqprior()
                + self.pi_role.KLqprior().sum(-1))

    def Elog_like(self, Y):
        return self.update_latents(Y).sum(-1)

    def postdict(self, Y, iters=0):
        for _ in range(iters):
            self.update_assignments(Y)
            self.update_latents(Y)
        return self.pX


class FocusedBayesianTransformer:
    """Roles selected by the latent: a Dirichlet mixture over
    dMixtureofLinearTransforms heads (reference
    wip_FocusedBayesianTransformer)."""

    def __init__(self, mixture_dim, role_dim, obs_dim, hidden_dim, batch_shape=(),
                 pad_X=False, generator=None, dtype=None, device=None):
        device = default_device(device)
        self.obs_dim = obs_dim
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_dim = 3
        self.role_dim = role_dim
        self.hidden_dim = hidden_dim
        self.mixture_dim = mixture_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.W = dMixtureofLinearTransforms(obs_dim, hidden_dim, role_dim,
                                            batch_shape=(mixture_dim,), pad_X=pad_X, **kw)
        self.pi = Dirichlet.create((mixture_dim,), **kw)
        self.p = self.NA = self.pX = None
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the assignments and latents are
        dropped); returns self."""
        self.W.to(device, dtype)
        self.pi = self.pi.to(device, dtype)
        self.p = self.NA = self.pX = None
        return self

    def _eye(self, d):
        return torch.eye(d, dtype=self.pi.alpha.dtype, device=self.pi.alpha.device)

    def _init_pX(self):
        h, m = self.hidden_dim, self.mixture_dim
        return MVN_vf(invSigma=self._eye(h).expand((1, m, h, h)),
                      invSigmamu=self.pi.alpha.new_zeros((1, m, h, 1)))

    def _pY(self, Y):
        """Y as a near-point-mass message."""
        Yv = Y[..., None][..., None, :, :]
        eye = self._eye(self.obs_dim)
        return MVN_vf(mu=Yv, Sigma=1e-8 * eye, invSigma=1e8 * eye, invSigmamu=1e8 * Yv)

    def _assignments(self, W, pi, pX, pY):
        log_p = W.Elog_like_given_pX_pY(pX, pY) + pi.ElogX()
        p = torch.exp(log_p - um.stable_logsumexp(log_p, -1, keepdim=True))
        return p, sum_leading(p.sum(-2), 1)

    def _latents(self, W, p, Y):
        pXpost, logZ, _ = W.postdict(Y[..., None, :])
        pv = p[..., None, None]
        invSigma = (pXpost.EinvSigma() * pv).sum(-4, keepdim=True) + self._eye(self.hidden_dim)
        invSigmamu = (pXpost.EinvSigmamu() * pv).sum(-4, keepdim=True)
        pX = MVN_vf(invSigma=invSigma, invSigmamu=invSigmamu)
        Res = (logZ[..., None] * p).sum(-2, keepdim=True) if logZ.ndim else logZ
        return pX, Res - pX.Res()

    def _elbo(self, Res, p, NA, pi, W):
        return (torch.sum(Res) - _plogp(p).sum() + (NA * pi.ElogX()).sum()
                - (W.KLqprior().sum(-1) + pi.KLqprior()))

    def update_assignments(self, Y):
        if self.pX is None:
            self.pX = self._init_pX()
        self.p, self.NA = self._assignments(self.W, self.pi, self.pX, self._pY(Y))

    def update_latents(self, Y):
        if self.p is None:
            self.update_assignments(Y)
        self.pX, Res = self._latents(self.W, self.p, Y)
        return Res

    def update_parms(self, Y, lr=1.0):
        self.W.update(self.pX, self._pY(Y), p=self.p, lr=lr)
        self.pi = self.pi.raw_update(self.NA, lr=lr)

    def _vb_step(self, nodes, Y, lr):
        """One VB sweep of (W.A, W.pi.beta, pi, pX) (reference wip_FBT
        raw_update body)."""
        WA, Wbeta, pi, pX = nodes
        W = self.W.with_nodes(WA, Wbeta)
        pY = self._pY(Y)
        p, NA = self._assignments(W, pi, pX, pY)
        pX, Res = self._latents(W, p, Y)
        ELBO = self._elbo(Res, p, NA, pi, W)
        (WA, Wbeta), _ = W._vb_step_msg((WA, Wbeta), pX, pY, pX.unsqueeze(-3),
                                        pY.unsqueeze(-3), p, lr)
        pi = pi.raw_update(NA, lr=lr)
        return (WA, Wbeta, pi, MVN_vf(invSigma=pX.invSigma, invSigmamu=pX.invSigmamu)), \
            (ELBO, p, NA)

    def raw_update(self, Y, iters=1, lr=1.0, verbose=False):
        """``iters`` sweeps on Y (sample x observations x obs_dim): the first
        through the stepwise methods, as the JAX package runs it, the rest
        through ``_vb_step``."""
        label = "Focused Transformer Percent Change in ELBO: "
        self.update_assignments(Y)
        ELBO = self._elbo(self.update_latents(Y), self.p, self.NA, self.pi, self.W)
        record_elbos(self, ELBO.reshape(1), verbose, label)
        self.update_parms(Y, lr=lr)
        if int(iters) <= 1:
            return
        self.pX = MVN_vf(invSigma=self.pX.invSigma, invSigmamu=self.pX.invSigmamu)
        nodes = (self.W.A, self.W.pi.beta, self.pi, self.pX)
        (self.W.A, self.W.pi.beta, self.pi, self.pX), (self.p, self.NA), ELBOs = fused_fit(
            self, self._vb_step, nodes, int(iters) - 1, Y, lr=lr
        )
        record_elbos(self, ELBOs, verbose, label)

    def Elog_like(self, Y):
        return self.update_latents(Y).sum(-1)

    def KLqprior(self):
        return self.W.KLqprior().sum(-1) + self.pi.KLqprior()


# The reference's wip_DiscreteBayesianTransformer.py is the Focused one under
# another name, so the two share one class, as in the JAX package.
DiscreteBayesianTransformer = FocusedBayesianTransformer


class ChainedBayesianTransformer:
    """Out-of-order chain discovery: each observation y_i is either
    independent (z_i = -1, a vector-format NIW base density) or driven by
    one of the other observations through a shared linear map W (reference
    transforms/wip_ChainedBayesianTransformer.py)."""

    def __init__(self, mixture_dim, role_dim, n, p, batch_shape=(), pad_X=False,
                 generator=None, dtype=None, device=None):
        device = default_device(device)
        self.obs_dim = n
        self.regression_dim = p
        self.event_shape = (mixture_dim, n, p)
        self.event_dim = 3
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.role_dim = role_dim
        self.mixture_dim = mixture_dim
        kw = dict(dtype=dtype, device=device)
        self.x0 = NormalInverseWishart_vector_format.create((n, 1), **kw)
        self.W = MatrixNormalWishart.create((n, n), generator=generator, **kw)
        # pi.mean()[0]: the probability that an observation is independent
        self.pi = Dirichlet.create((2,), generator=generator, **kw)
        self.logZ = self.p = None

    def to(self, device=None, dtype=None):
        """Move the nodes in place (the assignments are dropped); returns
        self."""
        self.x0, self.W, self.pi = (n.to(device, dtype) for n in (self.x0, self.W, self.pi))
        self.logZ = self.p = None
        return self

    def _vb_step(self, nodes, Y, lr):
        """One VB sweep of (x0, W, pi) (reference
        wip_ChainedBayesianTransformer.raw_update body)."""
        x0, W, pi = nodes
        NR = Y.shape[-2]
        eye = torch.eye(NR, dtype=Y.dtype, device=Y.device)
        log_p = (W.Elog_like(Y[..., :, None, :, None], Y[..., None, :, :, None])
                 + pi.ElogX()[1] - np.log(NR - 1.0))
        log_p = log_p * (1.0 - eye) + (x0.Elog_like(Y[..., None])[..., None]
                                       + pi.ElogX()[0]) * eye
        shift = log_p.max(-1, keepdim=True).values
        p = torch.exp(log_p - shift)
        logZ = p.sum(-1, keepdim=True)
        p = p / logZ
        logZ = (torch.log(logZ) + shift)[..., 0]
        ELBO = torch.sum(logZ.sum() - (x0.KLqprior() + W.KLqprior() + pi.KLqprior()))

        p0 = torch.diagonal(p, dim1=-1, dim2=-2)
        x0 = x0.raw_update(Y[..., None], p=p0, lr=lr)
        p = p * (1.0 - eye)
        N = Y.new_full((1,), float(np.prod(Y.shape[:-1])))
        N0 = p0.sum()[None]
        pi = pi.raw_update(torch.cat([N0, N - N0], -1), lr=lr)
        W = W.raw_update(Y[..., :, None, :, None], Y[..., None, :, :, None], p=p, lr=lr)
        return (x0, W, pi), (ELBO, logZ, p)

    def raw_update(self, Y, iters=1, lr=1.0, beta=None, verbose=False):
        """Y: sample x observations x n."""
        (self.x0, self.W, self.pi), (self.logZ, self.p), _ = fused_fit(
            self, self._vb_step, (self.x0, self.W, self.pi), int(iters), Y, lr=lr
        )

    update = raw_update

    def KLqprior(self):
        return self.x0.KLqprior() + self.W.KLqprior() + self.pi.KLqprior()

    def ELBO(self):
        return self.logZ.sum() - self.KLqprior()
