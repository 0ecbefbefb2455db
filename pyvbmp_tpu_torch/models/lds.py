"""Variational Bayesian linear dynamical systems (counterpart of
pyvbmp_tpu/models/lds.py): information-form Kalman filter + RTS smoother
with exact logZ residual bookkeeping.

  y_t = B [x_t; r_t] + eps_t        (obs_model: MatrixNormalWishart, or one
                                    the caller gives: MNW or MNG, pad_X or not)
  x_t = A [x_{t-1}; u_t] + eta_t    (A: MNW 'shared' noise or MNG 'independent')

Two smoothers, picked by ``parallel_scan``:

- ``forward_backward_loop`` (the default): the sequential filter and
  smoother as two Python loops over T in plain PyTorch.  With
  ``cross_cov_compat=True`` (default) it reproduces the reference's
  cross-covariance line, whose ``QA @ Sigma * QA.T`` is an elementwise
  product where the math calls for ``@``; ``False`` uses the matrix product.
- ``ops.parallel_kalman.parallel_kalman_smoother``: the scan-based smoother
  (the lane-form CUDA kernel at h <= 3, the plane form above); it computes
  the corrected cross-covariances.

A ``time_mesh`` (a ``parallel.Mesh`` with a "seq" axis) comes before both:
the scan-based smoother with its time axis cut across the mesh's ranks
(``parallel/seq_parallel.py``), whatever ``cross_cov_compat`` says, as in
the JAX package.  ``update`` then runs the whole sweep on this rank's rows
of T (``seq_parallel.time_sweep``): the smoother's outputs, the
messages and the sufficient statistics are its rows and parts, and
``_ss_update``'s ``batch_sum`` completes the statistics over the ranks;
px stays this rank's rows (``CHUNK_STATE``; whole through
``seq_parallel.gather_posterior``) and each sequence's logZ is completed
over time when the update ends, so that ``ELBO()`` holds on every rank.
DMBD subclasses this class for the latent-chain machinery.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists import NormalInverseWishart
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..ops.parallel_kalman import kalman_smoother_rows, parallel_kalman_smoother
from ..parallel.seq_parallel import time_sharded_kalman_smoother, time_sweep
from ..transforms import MatrixNormalGamma, MatrixNormalWishart
from ..utils import math as um
from ..utils.linalg import mT, psd_inv, psd_inv_and_logdet
from ..utils.torchutils import batch_sum, default_device, sum_leading


class LinearDynamicalSystems:
    # the state a time-sharded update leaves as this rank's (seq_parallel):
    # its rows of time, and its block of the batch where the sweep splits it
    CHUNK_STATE = {"px": "time", "logZ": "seq"}

    def __init__(
        self,
        obs_shape,
        hidden_dim,
        control_dim=0,
        regression_dim=0,
        obs_model=None,
        latent_noise="independent",
        batch_shape=(),
        A_mask=None,
        B_mask=None,
        cross_cov_compat=True,
        parallel_scan=False,
        time_mesh=None,
        generator=None,
        dtype=None,
        device=None,
    ):
        from ..parallel.api import as_time_mesh

        self.time_mesh = as_time_mesh(time_mesh)
        self.time_chunk = self._sweep_chunk = None
        device = default_device(device)
        dtype = dtype or torch.get_default_dtype()
        control_dim = control_dim + 1
        regression_dim = regression_dim + 1
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = obs_shape[-1]
        self.hidden_dim = hidden_dim
        self.latent_noise = latent_noise
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.control_dim = control_dim
        self.regression_dim = regression_dim
        self.event_dim = len(obs_shape)
        self.cross_cov_compat = cross_cov_compat
        self.parallel_scan = parallel_scan
        self.logZ = torch.zeros((), dtype=dtype, device=device)
        self.ELBO_last = -float("inf")
        self.ELBO_save = []

        if A_mask is not None:
            A_mask = np.asarray(A_mask)
            A_mask = np.concatenate([A_mask, np.ones(A_mask.shape[:-1] + (1,))], -1) > 0
        if B_mask is not None:
            B_mask = np.asarray(B_mask)
            B_mask = np.concatenate([B_mask, np.ones(B_mask.shape[:-1] + (1,))], -1) > 0

        self.offset = (1,) * (len(obs_shape) - 1)
        self.expand_to_batch = False
        offset = self.offset
        self.x0 = NormalInverseWishart.create(
            offset + (hidden_dim,), batch_shape, generator=generator,
            dtype=dtype, device=device,
        )
        A_cls = MatrixNormalWishart if latent_noise == "shared" else MatrixNormalGamma
        self.A = A_cls.create(
            offset + (hidden_dim, hidden_dim + control_dim), batch_shape,
            mask=A_mask, generator=generator, dtype=dtype, device=device,
        )
        width = hidden_dim + regression_dim
        if obs_model is None:
            obs_model = MatrixNormalWishart.create(
                self.obs_shape + (width,), batch_shape,
                mask=B_mask, generator=generator, dtype=dtype, device=device,
            )
        elif obs_model.p != width:
            pad = int(obs_model.pad_X)
            raise ValueError(
                f"obs_model maps an X of width {obs_model.p}"
                + (" (its pad_X bias column included)" if pad else "")
                + f"; this LDS needs hidden_dim + regression_dim + 1 = {width}: build it "
                f"with event shape {self.obs_shape + (width - pad,)}"
                + (" and pad_X=True" if pad else ""))
        else:
            obs_model = obs_model.to(device, dtype)
        self.obs_model = obs_model
        self.px = None

    def to(self, device=None, dtype=None):
        """Move the model's nodes and state in place; returns self."""
        self.x0 = self.x0.to(device, dtype)
        self.A = self.A.to(device, dtype)
        self.obs_model = self.obs_model.to(device, dtype)
        if self.px is not None:
            self.px = self.px.to(device, dtype)
        self.logZ = self.logZ.to(device, dtype)
        return self

    def set_latent_parms(self):
        """A no-op kept for the reference's API: the latent parameters are
        recomputed from A inside every step."""

    # ------------------------------------------------------------------ inputs
    def reshape_inputs(self, y, u=None, r=None):
        """Vectorize and pad controls/regressors with ones."""
        sample_shape = tuple(y.shape[: y.ndim - len(self.obs_shape)])
        y = y[..., None]
        if u is None:
            u = y.new_ones(sample_shape + (self.control_dim, 1))
        else:
            u = torch.cat([u, u.new_ones(u.shape[:-1] + (1,))], -1)[..., None]
        if r is None:
            r = y.new_ones(
                sample_shape + self.obs_shape[:-1] + (self.regression_dim, 1)
            )
        else:
            r = torch.cat([r, r.new_ones(r.shape[:-1] + (1,))], -1)[..., None]
        if self.expand_to_batch:
            ns = len(sample_shape)
            for _ in range(len(self.batch_shape)):
                y, u, r = y.unsqueeze(ns), u.unsqueeze(ns), r.unsqueeze(ns)
            y = y.expand(sample_shape + self.batch_shape + self.obs_shape + (1,))
            u = u.expand(sample_shape + self.batch_shape + (self.control_dim, 1))
            r = r.expand(
                sample_shape + self.batch_shape + self.obs_shape[:-1]
                + (self.regression_dim, 1)
            )
        for _ in range(len(self.offset)):
            u = u.unsqueeze(-3)
        return y, u, r

    # ------------------------------------------------------ latent-param blocks
    def _latent_parms(self, A):
        invQ = A.EinvSigma()
        ATQA = A.EXTinvUX()
        h = self.hidden_dim
        QA = A.EinvUX()
        return dict(
            invQ=invQ,
            ATQA_x_x=ATQA[..., :h, :h],
            ATQA_x_u=ATQA[..., :h, h:],
            ATQA_u_u=ATQA[..., h:, h:],
            QA_xp_x=QA[..., :, :h],
            QA_xp_u=QA[..., :, h:],
            ElogdetinvQ=A.ElogdetinvSigma(),
        )

    # --------------------------------------------------------------- likelihoods
    def log_likelihood_function(self, obs_model, Y, R):
        """Per-time information-form observation messages."""
        h = self.hidden_dim
        invR = obs_model.EinvSigma()
        BTRB = obs_model.EXTinvUX()
        BTRB_xp_xp = BTRB[..., :h, :h]
        BTRB_xp_r = BTRB[..., :h, h:]
        BTRB_r_r = BTRB[..., h:, h:]
        BTR = obs_model.EXTinvU()
        BTR_xp_y = BTR[..., :h, :]
        BTR_r_y = BTR[..., h:, :]

        invSigma_t_t = BTRB_xp_xp
        invSigmamu_t = BTR_xp_y @ Y - BTRB_xp_r @ R
        Residual = (
            -0.5 * mT(Y) @ invR @ Y - 0.5 * mT(R) @ BTRB_r_r @ R + mT(R) @ BTR_r_y @ Y
        )
        Residual = (
            Residual[..., 0, 0]
            + 0.5 * obs_model.ElogdetinvSigma()
            - 0.5 * self.obs_dim * um.LOG2PI
        )
        for i in range(len(self.obs_shape) - 1):
            invSigma_t_t = invSigma_t_t.sum(-3 - i, keepdim=True)
            invSigmamu_t = invSigmamu_t.sum(-3 - i, keepdim=True)
            Residual = Residual.sum(-1 - i, keepdim=True)
        sample_shape = tuple(invSigmamu_t.shape[:-2])
        invSigma_t_t = invSigma_t_t.expand(sample_shape + (h, h))
        return invSigma_t_t, invSigmamu_t, Residual

    # ------------------------------------------------------------ forward/backward
    def forward_backward_loop(self, parms, x0, like, u):
        """The sequential information filter and RTS smoother: two Python
        loops over T (the JAX package's two ``lax.scan``s).

        like = (invSigma_like, invSigmamu_like, Residual_like), each (T,)+...
        Returns px (smoothed), Sigma_cross[t] = Sigma_{t,t+1} for t=0..T-2,
        Sigma_x0_cross, Sigma_x0_x0, mu_x0 and logZ (T,)+...
        """
        invSigma_like, invSigmamu_like, Residual_like = like
        T = invSigma_like.shape[0]
        h = self.hidden_dim
        invQ = parms["invQ"]
        ATQA_x_x = parms["ATQA_x_x"]
        ATQA_x_u = parms["ATQA_x_u"]
        ATQA_u_u = parms["ATQA_u_u"]
        QA_xp_x = parms["QA_xp_x"]
        QA_xp_u = parms["QA_xp_u"]

        invSigma0 = x0.EinvSigma()
        invSigmamu0 = x0.EinvSigmamu()[..., None]
        Residual0 = (
            -0.5 * x0.EXTinvUX()
            + 0.5 * x0.ElogdetinvSigma()
            - 0.5 * h * um.LOG2PI
        )

        bshape = torch.broadcast_shapes(invSigma0.shape, invSigma_like.shape[1:])
        invSigma = invSigma0.expand(bshape)
        invSigmamu = invSigmamu0.expand(bshape[:-1] + (1,))
        Residual = Residual0.expand(bshape[:-2])
        fw_invSigma, fw_invSigmamu, logZ, SigmaStar = [], [], [], []
        for t in range(T):
            U = u[t]
            Sstar, logdet_invSigmaStar = psd_inv_and_logdet(invSigma + ATQA_x_x)
            invSigmamu_t = invSigmamu_like[t] + QA_xp_u @ U
            invSigmamu_tm1 = invSigmamu - ATQA_x_u @ U
            invSigma_new = invSigma_like[t] + invQ - QA_xp_x @ Sstar @ mT(QA_xp_x)
            invSigmamu_new = invSigmamu_t + QA_xp_x @ Sstar @ invSigmamu_tm1
            Residual = (
                Residual
                + Residual_like[t]
                - 0.5 * (mT(U) @ ATQA_u_u @ U)[..., 0, 0]
                + 0.5 * parms["ElogdetinvQ"]
            )
            Residual = (
                Residual
                + 0.5 * (mT(invSigmamu_tm1) @ Sstar @ invSigmamu_tm1)[..., 0, 0]
                - 0.5 * logdet_invSigmaStar
            )
            Sigma_new, logdet_new = psd_inv_and_logdet(invSigma_new)
            mu = Sigma_new @ invSigmamu_new
            post_Residual = (
                -0.5 * (mu * invSigmamu_new)[..., 0].sum(-1)
                + 0.5 * logdet_new
                - 0.5 * h * um.LOG2PI
            )
            fw_invSigma.append(invSigma_new)
            fw_invSigmamu.append(invSigmamu_new)
            logZ.append(Residual - post_Residual)
            SigmaStar.append(Sstar)
            invSigma, invSigmamu, Residual = invSigma_new, invSigmamu_new, post_Residual
        fw_invSigma = torch.stack(fw_invSigma)
        fw_invSigmamu = torch.stack(fw_invSigmamu)
        logZ = torch.stack(logZ)
        SigmaStar = torch.stack(SigmaStar)

        Sigma_T = psd_inv(fw_invSigma[-1])
        mu_T = Sigma_T @ fw_invSigmamu[-1]

        def cross_cov(Sstar, invGamma, iS_like):
            if self.cross_cov_compat:
                corr = (QA_xp_x @ Sstar) * mT(QA_xp_x)
            else:
                corr = QA_xp_x @ Sstar @ mT(QA_xp_x)
            # general inverse: the compat-path matrix is not symmetric
            return Sstar @ mT(QA_xp_x) @ torch.linalg.inv(invGamma + iS_like + invQ - corr)

        def backward_step(invGamma, invGammamu, iS_like, iSm_like, U):
            Sigma_tp1_tp1 = psd_inv(invQ + iS_like + invGamma)
            invGamma_new = ATQA_x_x - mT(QA_xp_x) @ Sigma_tp1_tp1 @ QA_xp_x
            invGammamu_new = -ATQA_x_u @ U + mT(QA_xp_x) @ Sigma_tp1_tp1 @ (
                QA_xp_u @ U + iSm_like + invGammamu
            )
            return invGamma_new, invGammamu_new

        invGamma = torch.zeros_like(fw_invSigma[-1])
        invGammamu = torch.zeros_like(fw_invSigmamu[-1])
        bwd = [None] * (T - 1)
        for t in range(T - 2, -1, -1):
            Sigma_cross_t = cross_cov(SigmaStar[t + 1], invGamma, invSigma_like[t + 1])
            invGamma, invGammamu = backward_step(
                invGamma, invGammamu, invSigma_like[t + 1], invSigmamu_like[t + 1],
                u[t + 1],
            )
            invSigma_sm = fw_invSigma[t] + invGamma
            invSigmamu_sm = fw_invSigmamu[t] + invGammamu
            Sigma_sm = psd_inv(invSigma_sm)
            bwd[t] = (Sigma_sm, Sigma_sm @ invSigmamu_sm, invSigma_sm,
                      invSigmamu_sm, Sigma_cross_t)
        Sigma_sm, mu_sm, invSigma_sm, invSigmamu_sm, Sigma_cross = (
            torch.stack(x) for x in zip(*bwd)
        )

        # final x0 cross-covariance and posterior
        Sigma_x0_cross = cross_cov(SigmaStar[0], invGamma, invSigma_like[0])
        invGamma0, invGammamu0 = backward_step(
            invGamma, invGammamu, invSigma_like[0], invSigmamu_like[0], u[0]
        )
        Sigma_x0_x0 = psd_inv(invGamma0 + x0.EinvSigma())
        mu_x0 = Sigma_x0_x0 @ (invGammamu0 + x0.EinvSigmamu()[..., None])

        px = MVN_vf(
            mu=torch.cat([mu_sm, mu_T[None]], 0),
            Sigma=torch.cat([Sigma_sm, Sigma_T[None]], 0),
            invSigmamu=torch.cat([invSigmamu_sm, fw_invSigmamu[-1:]], 0),
            invSigma=torch.cat([invSigma_sm, fw_invSigma[-1:]], 0),
        )
        return px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ

    # ----------------------------------------------------------- smoother
    def _smoother(self, parms, x0, like, u):
        """Dispatch, in the JAX package's order: the time-sharded smoother
        over ``time_mesh`` when it is set, else the scan-based smoother when
        ``parallel_scan`` is set (both with the corrected
        cross-covariances), else the sequential loops.  In a time-sharded
        sweep (``seq_parallel.time_sweep``) the scan-based smoother runs on
        the sweep's chain and keeps this rank's rows: Sigma_cross holds its
        rows of Sigma_{t-1,t} (the x_{-1} cross in the chain's row 0) and
        Sigma_x0_cross is None."""
        chunk = self._sweep_chunk
        if chunk is not None:
            marginals, Sigma_cross, *ends = kalman_smoother_rows(parms, x0, like, u, chunk)
            out = (marginals, Sigma_cross, None, *ends)
        elif self.time_mesh is not None:
            out = time_sharded_kalman_smoother(parms, x0, like, u, self.time_mesh)
        elif self.parallel_scan:
            out = parallel_kalman_smoother(parms, x0, like, u)
        else:
            return self.forward_backward_loop(parms, x0, like, u)
        (Sigma, mu, Js, hs), Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ_total = out
        px = MVN_vf(mu=mu, Sigma=Sigma, invSigmamu=hs, invSigma=Js)
        return px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ_total[None]

    # ----------------------------------------------------------- suff statistics
    def _latent_suffstats(self, px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0,
                          SE_x0, y, u, r, logZ):
        """Time-integrated sufficient statistics.  In a time-sharded sweep
        they are this rank's part: sums over its rows, the pairs (x_{t-1},
        x_t) of its rows t with x_{start-1} from the rank before (one halo
        row), and the x_{-1} and x_{T-1} terms (N included) on the ranks
        holding those rows, zeros on the others."""
        chunk = self._sweep_chunk
        mu = px.mu
        Sigma = px.Sigma
        SE_x0_x0 = Sigma_x0_x0 + SE_x0 @ mT(SE_x0)

        def tsum_outer(a, b):
            """sum_t a_t b_t^T for (T,)+batch+(m,1) column stacks."""
            shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
            a = a.expand(shape + a.shape[-2:])
            b = b.expand(shape + b.shape[-2:])
            return torch.einsum("t...io,t...jo->...ij", a, b)

        SE_x_x = tsum_outer(mu, mu) + Sigma.sum(0)
        SE_x_u = tsum_outer(mu, u)
        if chunk is None:
            SE_xp_xp = SE_x_x - (mu[-1] @ mT(mu[-1]) + Sigma[-1]) + SE_x0_x0
            SE_xp_u = tsum_outer(mu[:-1], u[1:]) + SE_x0 @ mT(u[0])
            SE_xp_x = tsum_outer(mu[:-1], mu[1:]) + Sigma_cross.sum(0)
            SE_xp_x = SE_xp_x + SE_x0 @ mT(mu[0]) + Sigma_x0_cross
        else:
            mu_T, Sigma_T = chunk.last(mu, Sigma)
            SE_xp_xp = SE_x_x - chunk.held(mu_T @ mT(mu_T) + Sigma_T) + SE_x0_x0
            mu_prev, = chunk.shift((mu,), up=False, edge=(SE_x0,))
            SE_xp_u = tsum_outer(mu_prev, u)
            SE_xp_x = tsum_outer(mu_prev, mu) + Sigma_cross.sum(0)
        SE_x_r = tsum_outer(mu, r)
        SE_x_y = tsum_outer(mu, y)
        SE_u_u = tsum_outer(u, u)
        SE_r_r = tsum_outer(r, r)
        SE_y_y = tsum_outer(y, y)
        SE_y_r = tsum_outer(y, r)

        sample_shape = tuple(y.shape[1: y.ndim - self.event_dim - self.batch_dim - 1])
        SE_y_r = SE_y_r.expand(
            sample_shape + self.batch_shape + self.obs_shape + (self.regression_dim,)
        )
        SE_u_u = SE_u_u.expand(
            sample_shape + self.batch_shape + self.offset
            + (self.control_dim, self.control_dim)
        )
        SE_r_r = SE_r_r.expand(
            sample_shape + self.batch_shape + self.obs_shape[:-1]
            + (self.regression_dim, self.regression_dim)
        )

        lead = sample_shape + self.batch_shape + self.offset
        T = y.new_full(lead, float(y.shape[0]))
        N = y.new_full(lead, 1.0 if chunk is None or chunk.holds_first else 0.0)
        SE_y_xr = torch.cat([mT(SE_x_y), SE_y_r], -1)
        SE_xpu_xpu = torch.cat(
            [
                torch.cat([SE_xp_xp, SE_xp_u], -1),
                torch.cat([mT(SE_xp_u), SE_u_u], -1),
            ],
            -2,
        )
        SE_x_xpu = torch.cat([mT(SE_xp_x), SE_x_u], -1)
        SE_x_x_b = SE_x_x.expand(SE_x_r.shape[:-2] + SE_x_x.shape[-2:])
        SE_xr_xr = torch.cat(
            [
                torch.cat([SE_x_x_b, SE_x_r], -1),
                torch.cat([mT(SE_x_r), SE_r_r], -1),
            ],
            -2,
        )
        logZ_out = logZ
        for _ in range(len(self.offset)):
            logZ_out = logZ_out[..., 0]
        logZ_out = logZ_out.sum(0)
        return dict(
            T=T,
            N=N,
            SE_x_x=SE_x_x,
            SE_x0_x0=SE_x0_x0,
            SE_x0=SE_x0,
            SE_y_xr=SE_y_xr,
            SE_y_y=SE_y_y,
            SE_xpu_xpu=SE_xpu_xpu,
            SE_x_xpu=SE_x_xpu,
            SE_xr_xr=SE_xr_xr,
            logZ=logZ_out,
        )

    # -------------------------------------------------------------------- E-step
    def _update_latents(self, x0, A, obs_model, y, u, r):
        parms = self._latent_parms(A)
        like = self.log_likelihood_function(obs_model, y, r)
        px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ = (
            self._smoother(parms, x0, like, u)
        )
        ss = self._latent_suffstats(
            px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, y, u, r, logZ
        )
        return px, ss

    # -------------------------------------------------------------------- M-step
    def _ss_update(self, x0, A, ss, p=None, lr=1.0):
        """Sum sufficient statistics over samples (p-weighted for mixtures)
        and push to x0 / A.  The sums over the batch are completed in one
        ``batch_sum`` (data-parallel sweeps)."""
        keys = ("SE_x0_x0", "SE_x0", "SE_xpu_xpu", "SE_x_xpu", "SE_x_x",
                "SE_xr_xr", "SE_y_xr", "SE_y_y")
        stats = {k: ss[k] for k in ss if k != "logZ"}
        if p is not None:
            pe = p
            for _ in range(len(self.offset)):
                pe = pe[..., None]
            stats["T"] = stats["T"] * pe
            stats["N"] = stats["N"] * pe
            pm = pe[..., None, None]
            for k in keys:
                stats[k] = stats[k] * pm
        keep = self.batch_dim + len(self.offset)
        for k in ("T", "N"):
            stats[k] = sum_leading(stats[k], keep)
        for k in keys:
            stats[k] = sum_leading(stats[k], keep + 2)
        names = ("T", "N") + keys
        stats.update(zip(names, batch_sum(*(stats[k] for k in names))))
        for k in ("SE_x0_x0", "SE_xpu_xpu", "SE_x_x", "SE_xr_xr"):
            stats[k] = 0.5 * (stats[k] + mT(stats[k]))
        x0 = x0.ss_update(stats["SE_x0_x0"], stats["SE_x0"][..., 0], stats["N"], lr)
        A = A.ss_update(
            stats["SE_xpu_xpu"], stats["SE_x_xpu"], stats["SE_x_x"], stats["T"], lr
        )
        return x0, A, stats

    def _vb_step(self, x0, A, obs_model, y, u, r, lr, p=None):
        px, ss = self._update_latents(x0, A, obs_model, y, u, r)
        logZ = ss["logZ"]
        KL = self._KL(x0, A, obs_model)
        data, = batch_sum(sum_leading(logZ, self.batch_dim).sum())
        ELBO = data - KL.sum()
        x0, A, stats = self._ss_update(x0, A, ss, p=p, lr=lr)
        obs_model = obs_model.ss_update(
            stats["SE_xr_xr"], stats["SE_y_xr"], stats["SE_y_y"], stats["T"], lr
        )
        return x0, A, obs_model, px, logZ, ELBO

    def _KL(self, x0, A, obs_model):
        KL = x0.KLqprior() + A.KLqprior()
        for _ in range(len(self.offset)):
            if KL.ndim > 0:
                KL = KL[..., 0] if KL.shape[-1] == 1 else KL
        return KL + obs_model.KLqprior()

    def _vb_multi(self, x0, A, obs_model, y, u, r, lr, iters, p=None):
        """``iters`` VB-EM sweeps, then the smoothed posterior of the final
        parameters (one more smoother pass, as in the JAX package)."""
        Ls = []
        for _ in range(iters):
            x0, A, obs_model, px, logZ, L = self._vb_step(
                x0, A, obs_model, y, u, r, lr, p
            )
            Ls.append(L)
        px, _ = self._update_latents(x0, A, obs_model, y, u, r)
        return x0, A, obs_model, px, logZ, Ls

    # ---------------------------------------------------------- reference API
    def update(self, y, u=None, r=None, p=None, iters=1, lr=1.0, verbose=False):
        y, u, r = self.reshape_inputs(y, u, r)
        self._update_reshaped(y, u, r, p=p, iters=iters, lr=lr, verbose=verbose)

    def _n_seq(self, y):
        """The width of a reshaped ``y``'s sample axis (axis 1), or None."""
        sample_shape = y.shape[1: y.ndim - self.event_dim - self.batch_dim - 1]
        return sample_shape[0] if len(sample_shape) else None

    def _update_reshaped(self, y, u, r, p=None, iters=1, lr=1.0, verbose=False):
        """VB sweeps on already-reshaped inputs.  ``p`` (sample x batch
        assignment weights) weights the M-step sufficient statistics.  With
        a ``time_mesh`` the sweeps run on this rank's rows."""
        with time_sweep(self, y, self._n_seq(y)) as chunk:
            if chunk is not None:
                y, u, r = chunk.take(y), chunk.take(u), chunk.take(r)
                p = None if p is None else chunk.take_samples(p)
            if iters == 1:
                self.x0, self.A, self.obs_model, self.px, self.logZ, L = self._vb_step(
                    self.x0, self.A, self.obs_model, y, u, r, lr, p
                )
                Ls = [L]
            else:
                self.x0, self.A, self.obs_model, self.px, self.logZ, Ls = self._vb_multi(
                    self.x0, self.A, self.obs_model, y, u, r, lr, iters, p
                )
            if chunk is not None:  # each sequence's logZ, whole over time
                self.logZ, = chunk.complete_time(self.logZ)
        # one host fetch for the whole trajectory
        for L in torch.stack(Ls).cpu().tolist():
            if verbose:
                print("Percent Change in ELBO %f" % ((L - self.ELBO_last) / abs(L) * 100))
            self.ELBO_last = float(L)
            self.ELBO_save.append(float(L))

    def update_latents(self, y, u, r, p=None, lr=1.0):
        self.px, ss = self._update_latents(self.x0, self.A, self.obs_model, y, u, r)
        self.time_chunk = None  # px is whole (a time_mesh's whole-output smoother)
        self._ss = ss
        self.logZ = ss["logZ"]
        # expose stats with the reference's attribute names
        for k, v in ss.items():
            if k != "logZ":
                setattr(self, k, v)

    def ss_update(self, p=None, lr=1.0):
        self.x0, self.A, stats = self._ss_update(self.x0, self.A, self._ss, p=p, lr=lr)
        for k, v in stats.items():
            setattr(self, k, v)
        self._ss.update(stats)

    def KLqprior(self):
        return self._KL(self.x0, self.A, self.obs_model)

    def ELBO(self):
        return sum_leading(self.logZ, self.batch_dim) - self.KLqprior()
