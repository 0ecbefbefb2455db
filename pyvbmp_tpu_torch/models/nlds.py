"""Recurrent switching linear dynamical system (counterpart of
pyvbmp_tpu/models/nlds.py).

Generative model:

    s_0 ~ Cat(pi0)
    s_t | s_{t-1}, x_{t-1} ~ softmax(W_{s_{t-1}} x_{t-1} + b_{s_{t-1}})   (MNLR)
    x_t | x_{t-1}, s_t     ~ N(A_{s_t} x_{t-1} + a_{s_t}, Q_{s_t})
    y_t | x_t, s_t         ~ N(B_{s_t} x_t + b_{s_t}, R_{s_t})

Structured mean-field VB: q(x) is a Gaussian chain from the scan-based
Kalman smoother (``ops.parallel_kalman``: the lane or plane Kalman scan
kernels on the card) with per-time potentials mixed under q(s_t); q(s) is a
Markov chain from the sequential input-driven forward-backward
(``models/dhmm.py:driven_forward_backward``) with per-time transition
logits from the MNLR at E[x_{t-1}].  The ELBO is the s-chain normalizer
minus the parameter KLs.  ``batch_shape`` is ``()``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists import Dirichlet, NormalInverseWishart
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MatrixNormalWishart, MultiNomialLogisticRegression
from ..utils import math as um
from ..utils.linalg import mT
from ..utils.torchutils import default_device, sum_leading


class NonLinearDynamicalSystems:
    def __init__(self, obs_shape, hidden_dim, mixture_dim, batch_shape=(), *,
                 generator=None, dtype=None, device=None):
        """The JAX package's signature; ``generator`` (the initial draws and
        the symmetry-breaking q(s) of the first ``update``), ``dtype`` and
        ``device`` are keyword-only.  The model builds on ``device``, the
        card unless the caller asks for another."""
        if tuple(batch_shape) != ():
            raise ValueError(f"NLDS supports batch_shape=() only, got {batch_shape}")
        device = default_device(device)
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = obs_shape[-1]
        self.hidden_dim = hidden_dim
        self.mixture_dim = mixture_dim
        self.batch_shape = ()
        self.batch_dim = 0
        self.generator = generator

        h, K, n = hidden_dim, mixture_dim, self.obs_dim
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.x0 = NormalInverseWishart.create((h,), **kw)
        self.A = MatrixNormalWishart.create((h, h + 1), (K,), **kw)
        self.B = MatrixNormalWishart.create((n, h + 1), (K,), **kw)
        self.T = MultiNomialLogisticRegression(K, h, batch_shape=(K,), pad_X=True, **kw)
        self.pi0 = Dirichlet.create((K,), **kw)
        self.p = None
        self.px = None
        self.logZ = None
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes and state in place; returns self."""
        self.x0 = self.x0.to(device, dtype)
        self.A = self.A.to(device, dtype)
        self.B = self.B.to(device, dtype)
        self.T.to(device, dtype)
        self.pi0 = self.pi0.to(device, dtype)
        if self.p is not None:
            self.p = self.p.to(device=device, dtype=dtype)
        if self.px is not None:
            self.px = self.px.to(device, dtype)
        return self

    # ------------------------------------------------------------- potentials
    def _dyn_parms(self, A):
        """Per-state quadratic dynamics potentials (cf. lds._latent_parms)."""
        h = self.hidden_dim
        ATQA = A.EXTinvUX()
        QA = A.EinvUX()
        return dict(
            invQ=A.EinvSigma(),
            ATQA_x_x=ATQA[..., :h, :h],
            ATQA_x_u=ATQA[..., :h, h:],
            ATQA_u_u=ATQA[..., h:, h:],
            QA_xp_x=QA[..., :, :h],
            QA_xp_u=QA[..., :, h:],
            ElogdetinvQ=A.ElogdetinvSigma(),
        )

    def _obs_parms(self, B):
        """Per-state observation message pieces for a single y_t."""
        h = self.hidden_dim
        BTRB = B.EXTinvUX()
        BTR = B.EXTinvU()
        return dict(
            invS=BTRB[..., :h, :h],            # (K,h,h)
            BTR_x_y=BTR[..., :h, :],           # (K,h,n)
            BTRB_x_b=BTRB[..., :h, h:],        # (K,h,1)
            BTRB_b_b=BTRB[..., h:, h:],        # (K,1,1)
            BTR_b_y=BTR[..., h:, :],           # (K,1,n)
            invR=B.EinvSigma(),                # (K,n,n)
            ElogdetinvR=B.ElogdetinvSigma(),   # (K,)
        )

    def _obs_like_per_s(self, op, y):
        """Per-time, per-state information-form messages from y (T,b,n,1)."""
        ys = y[..., None, :, :]
        invSigmamu = op["BTR_x_y"] @ ys - op["BTRB_x_b"]
        Res = (
            -0.5 * mT(ys) @ op["invR"] @ ys
            - 0.5 * op["BTRB_b_b"]
            + op["BTR_b_y"] @ ys
        )[..., 0, 0] + 0.5 * op["ElogdetinvR"] - 0.5 * self.obs_dim * um.LOG2PI
        return op["invS"], invSigmamu, Res

    # ------------------------------------------------------------------ E: q(x)
    def _x_step(self, x0, dp, op, p, y):
        """Kalman sweep with q(s_t)-mixed per-time potentials (T, b, ...)."""
        from ..ops.parallel_kalman import parallel_kalman_smoother

        def mix(a):
            return torch.einsum("tbk,k...->tb...", p, a)

        parms = {k: mix(v) for k, v in dp.items()}
        iS_s, iSm_s, Res_s = self._obs_like_per_s(op, y)
        like = (
            torch.einsum("tbk,kij->tbij", p, iS_s),
            torch.einsum("tbk,tbk...->tb...", p, iSm_s),
            torch.einsum("tbk,tbk->tb", p, Res_s),
        )
        u = y.new_ones(y.shape[:2] + (1, 1))
        (Sigma, mu, Js, hs), Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ = (
            parallel_kalman_smoother(parms, x0, like, u)
        )
        px = MVN_vf(mu=mu, Sigma=Sigma, invSigmamu=hs, invSigma=Js)
        return px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ

    # ------------------------------------------------------------------ E: q(s)
    def _s_logits(self, dp, op, moments, y):
        """Per-time per-state logits: dynamics + observation terms."""
        Exx, Ex, C, Exx_prev, Ex_prev = moments
        # observation term: E_qx[log p(y_t | x_t, s_t=j)]
        iS_s, iSm_s, Res_s = self._obs_like_per_s(op, y)
        O = (
            Res_s
            + torch.einsum("tbho,tbkho->tbk", Ex, iSm_s)
            - 0.5 * torch.einsum("kij,tbji->tbk", op["invS"], Exx)
        )
        # dynamics term: E_qx[log p(x_t | x_{t-1}, s_t=i)]
        D = (
            0.5 * dp["ElogdetinvQ"]
            - 0.5 * self.hidden_dim * um.LOG2PI
            - 0.5 * torch.einsum("kij,tbji->tbk", dp["invQ"], Exx)
            + torch.einsum("kij,tbji->tbk", dp["QA_xp_x"], C)
            + torch.einsum("kio,tbio->tbk", dp["QA_xp_u"], Ex)
            - 0.5 * torch.einsum("kij,tbji->tbk", dp["ATQA_x_x"], Exx_prev)
            - torch.einsum("kio,tbio->tbk", dp["ATQA_x_u"], Ex_prev)
            - 0.5 * dp["ATQA_u_u"][..., 0, 0]
        )
        return O + D

    def _moments(self, px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0):
        mu, Sigma = px.mu, px.Sigma
        Exx = Sigma + mu @ mT(mu)                       # (T,b,h,h)
        E0 = Sigma_x0_x0 + mu_x0 @ mT(mu_x0)
        Exx_prev = torch.cat([E0.expand(Exx[:1].shape), Exx[:-1]], 0)
        mu_prev = torch.cat([mu_x0.expand(mu[:1].shape), mu[:-1]], 0)
        # C_t = E[x_{t-1} x_t'] (cross-covariance + mean product)
        cross = torch.cat([Sigma_x0_cross.expand(Sigma_cross[:1].shape), Sigma_cross], 0)
        C = cross + mu_prev @ mT(mu)
        return Exx, mu, C, Exx_prev, mu_prev

    # ---------------------------------------------------------------- one sweep
    def _vb_step(self, p, y, lr):
        """One sweep from q(s) = p: q(x), then the M-steps weighted by p, then
        q(s) from the updated parameters, then the transition MNLR and pi0.
        Updates the nodes in place; returns (new q(s), q(x), logZ, ELBO)."""
        from .dhmm import driven_forward_backward

        dp = self._dyn_parms(self.A)
        op = self._obs_parms(self.B)

        # ---- q(x) given q(s)
        px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, _ = self._x_step(
            self.x0, dp, op, p, y
        )
        moments = self._moments(px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0)
        Exx, Ex, C, Exx_prev, Ex_prev = moments

        # ---- M-steps first, weighted by the input q(s), so that the q(s)
        # update below sees the freshly fitted parameters
        K = self.mixture_dim
        N0 = torch.as_tensor(float(np.prod(y.shape[1:2])), dtype=y.dtype, device=y.device)
        self.x0 = self.x0.ss_update(
            sum_leading(Sigma_x0_x0 + mu_x0 @ mT(mu_x0), 2),
            sum_leading(mu_x0[..., 0], 1),
            N0,
            lr,
        )
        ones = torch.ones_like(Ex[..., :1, :1])
        # dynamics A_s: regress x_t on [x_{t-1}; 1]
        Ex1x1 = torch.cat([torch.cat([Exx_prev, Ex_prev], -1),
                           torch.cat([mT(Ex_prev), ones], -1)], -2)   # (T,b,h+1,h+1)
        Ex_x1 = torch.cat([mT(C), Ex], -1)                             # (T,b,h,h+1)

        def wsum(a):
            return torch.einsum("tbk,tbij->kij", p, a)

        Nk = p.sum((0, 1))
        self.A = self.A.ss_update(wsum(Ex1x1), wsum(Ex_x1), wsum(Exx), Nk, lr)
        # emissions B_s: regress y_t on [x_t; 1]
        Exy1 = torch.cat([torch.cat([Exx, Ex], -1), torch.cat([mT(Ex), ones], -1)], -2)
        SE_y_x1 = torch.cat([y @ mT(Ex), y @ ones], -1)
        self.B = self.B.ss_update(wsum(Exy1), wsum(SE_y_x1), wsum(y @ mT(y)), Nk, lr)

        # ---- q(s) given q(x) and the updated parameters
        dp = self._dyn_parms(self.A)
        op = self._obs_parms(self.B)
        obs_logits = self._s_logits(dp, op, moments, y)       # (T,b,K)
        # transition logits at E[x_{t-1}] per source state; the t=0 row
        # carries the initial distribution (a uniform pseudo-state before it)
        feats = Ex_prev[..., 0]                                # (T,b,h)
        trans = self.T.log_predict(feats[..., None, :])        # (T,b,K,K)
        init_row = self.pi0.loggeomean()[..., None, :].expand(trans.shape[1:])
        trans = torch.cat([init_row[None], trans[1:]], 0)
        init_logits = torch.full((K,), -np.log(float(K)), dtype=y.dtype, device=y.device)
        ps, SEzz, _, logZs = driven_forward_backward(trans, init_logits, obs_logits, 1.0)

        # recurrent transition MNLR: features x_{t-1}, soft labels xi_t
        self.T.raw_update(feats[1:][..., None, :], SEzz[1:], iters=2, lr=lr)
        # q(s_0) is the first smoothed marginal
        self.pi0 = self.pi0.ss_update(sum_leading(ps[0], 1), lr)

        KL = (
            self.x0.KLqprior()
            + self.A.KLqprior().sum(-1)
            + self.B.KLqprior().sum(-1)
            + self.T.KLqprior().sum()
            + self.pi0.KLqprior()
        )
        return ps, px, logZs, logZs.sum() - KL

    def _initial_p(self, T, b, like):
        """Symmetry breaking: q(s) half on a random state per segment of
        max(T // 8, 2) steps, half uniform."""
        K = self.mixture_dim
        seg = max(T // 8, 2)
        n_seg = (T + seg - 1) // seg
        states = torch.randint(0, K, (n_seg, b), generator=self.generator)
        states = states.repeat_interleave(seg, 0)[:T]
        hard = torch.nn.functional.one_hot(states, K).to(dtype=like.dtype,
                                                         device=like.device)
        return 0.5 * hard + 0.5 / K

    # ------------------------------------------------------------- reference API
    def update(self, y, iters=1, lr=1.0, verbose=False):
        """``iters`` sweeps on y: (T, batch, obs_dim) or (T, batch, obs_dim, 1).
        The first update starts q(s) from ``_initial_p`` unless ``self.p``
        is already set."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        if y.ndim == 3:
            y = y[..., None]
        p = self.p if self.p is not None else self._initial_p(*y.shape[:2], y)
        ELBOs = []
        for _ in range(iters):
            p, px, logZ, ELBO = self._vb_step(p, y, lr)
            ELBOs.append(ELBO)
        self.p, self.logZ = p, logZ
        self.px = MVN_vf(mu=px.mu, Sigma=px.Sigma)
        for e in torch.stack(ELBOs).cpu().numpy():  # one host fetch
            if verbose:
                print("Percent Change in ELBO = ",
                      (e - self.ELBO_last) / np.abs(self.ELBO_last) * 100)
            self.ELBO_last = float(e)
            self.ELBO_save.append(float(e))

    raw_update = update

    def fit(self, y, iters=30, restarts=5, lr=1.0, verbose=False):
        """Multi-restart fit, keeping the restart with the best final ELBO
        (the mean-field objective has strong local optima).  Each restart is
        a fresh model drawn from this model's generator, on its device and
        in its dtype."""
        like = self.A.mu
        best = None
        for rstart in range(restarts):
            fresh = NonLinearDynamicalSystems(
                self.obs_shape, self.hidden_dim, self.mixture_dim,
                generator=self.generator, dtype=like.dtype, device=like.device,
            )
            fresh.update(y, iters=iters, lr=lr, verbose=False)
            if verbose:
                print(f"restart {rstart}: ELBO {fresh.ELBO_save[-1]:.1f}")
            if best is None or fresh.ELBO_save[-1] > best.ELBO_save[-1]:
                best = fresh
        for attr in ("x0", "A", "B", "T", "pi0", "p", "px", "ELBO_last", "ELBO_save",
                     "logZ"):
            setattr(self, attr, getattr(best, attr))
        return self

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)

    def ELBO(self):
        return self.ELBO_last


NLDS = NonLinearDynamicalSystems
