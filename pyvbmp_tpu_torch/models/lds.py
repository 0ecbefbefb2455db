"""Variational Bayesian linear dynamical systems (counterpart of
pyvbmp_tpu/models/lds.py).

  y_t = B [x_t; r_t] + eps_t        (observation model)
  x_t = A [x_{t-1}; u_t] + eta_t    (A: MatrixNormalGamma, 'independent')

The port carries the pieces DMBD inherits: input reshaping, the latent
parameter blocks, the scan-based smoother, the time-integrated sufficient
statistics and the latent M-step.  The standalone LDS model (its own
constructor, observation model and ``update``) and the sequential smoother
are not ported yet.
"""
from __future__ import annotations

import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..utils.linalg import mT
from ..utils.torchutils import sum_leading


class LinearDynamicalSystems:
    """Base of DynamicMarkovBlanketDiscovery: the latent-chain machinery.

    Subclasses set hidden_dim, control_dim, regression_dim (both counting
    the appended constant 1), obs_shape, event_dim, batch_shape, batch_dim
    and offset."""

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

    # ----------------------------------------------------------- smoother
    def _smoother(self, parms, x0, like, u):
        """The scan-based smoother (corrected cross-covariances)."""
        from ..ops.parallel_kalman import parallel_kalman_smoother

        (Sigma, mu, Js, hs), Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ_total = (
            parallel_kalman_smoother(parms, x0, like, u)
        )
        px = MVN_vf(mu=mu, Sigma=Sigma, invSigmamu=hs, invSigma=Js)
        return px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0, mu_x0, logZ_total[None]

    # ----------------------------------------------------------- suff statistics
    def _latent_suffstats(self, px, Sigma_cross, Sigma_x0_cross, Sigma_x0_x0,
                          SE_x0, y, u, r, logZ):
        """Time-integrated sufficient statistics."""
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
        SE_xp_xp = SE_x_x - (mu[-1] @ mT(mu[-1]) + Sigma[-1]) + SE_x0_x0
        SE_x_u = tsum_outer(mu, u)
        SE_xp_u = tsum_outer(mu[:-1], u[1:]) + SE_x0 @ mT(u[0])
        SE_xp_x = tsum_outer(mu[:-1], mu[1:]) + Sigma_cross.sum(0)
        SE_xp_x = SE_xp_x + SE_x0 @ mT(mu[0]) + Sigma_x0_cross
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
        N = y.new_ones(lead)
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

    # -------------------------------------------------------------------- M-step
    def _ss_update(self, x0, A, ss, lr=1.0):
        """Sum sufficient statistics over samples and push to x0 / A."""
        stats = {k: ss[k] for k in ss if k != "logZ"}
        keep = self.batch_dim + len(self.offset)
        for k in ("T", "N"):
            stats[k] = sum_leading(stats[k], keep)
        for k in ("SE_x0_x0", "SE_x0", "SE_xpu_xpu", "SE_x_xpu", "SE_x_x",
                  "SE_xr_xr", "SE_y_xr", "SE_y_y"):
            stats[k] = sum_leading(stats[k], keep + 2)
        for k in ("SE_x0_x0", "SE_xpu_xpu", "SE_x_x", "SE_xr_xr"):
            stats[k] = 0.5 * (stats[k] + mT(stats[k]))
        x0 = x0.ss_update(stats["SE_x0_x0"], stats["SE_x0"][..., 0], stats["N"], lr)
        A = A.ss_update(
            stats["SE_xpu_xpu"], stats["SE_x_xpu"], stats["SE_x_x"], stats["T"], lr
        )
        return x0, A, stats
