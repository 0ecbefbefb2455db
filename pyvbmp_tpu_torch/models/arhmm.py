"""Autoregressive HMMs, p(y_t | x_t, z_t) = N(A_{z_t} x_t, Sigma_{z_t})
(counterpart of pyvbmp_tpu/models/arhmm.py).

- ``ARHMM``: observed (X, Y) pairs;
- ``ARHMM_prXY``: (X, Y) given as Gaussian messages;
- ``ARHMM_prXRY``: (pX, R, Y) with pX a Gaussian message and the regressor R
  observed (DMBD's role model).

Each is the HMM shell with a MatrixNormalWishart batched over the states as
its observation model; the hooks below give the shell that model's logits
and update.
"""
from __future__ import annotations

import torch

from .hmm import HMM
from ..dists.delta import Delta
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MatrixNormalWishart
from ..utils.linalg import block_diag_matrix_builder, mT
from ..utils.torchutils import brole_avg, default_device


def _states_mnw(dim, event_shape, batch_shape, pad_X, X_mask, mask, generator,
                dtype, device):
    return MatrixNormalWishart.create(
        event_shape=event_shape,
        batch_shape=tuple(batch_shape) + (dim,),
        pad_X=pad_X,
        X_mask=X_mask,
        mask=mask,
        generator=generator,
        dtype=dtype,
        device=device,
    )


class ARHMM(HMM):
    """Observed (X, Y) pairs; obs_dist = MNW batched over states."""

    def __init__(self, dim, n, p, batch_shape=(), pad_X=True, X_mask=None, mask=None,
                 transition_mask=None, *, generator=None, dtype=None, device=None):
        device = default_device(device)
        dist = _states_mnw(dim, (n, p), batch_shape, pad_X, X_mask, mask, generator,
                           dtype, device)
        super().__init__(dist, transition_mask=transition_mask,
                         generator=generator, dtype=dtype, device=device)

    def _obs_logits(self, obs_dist, XY):
        return obs_dist.Elog_like(XY[0], XY[1])

    def _obs_update(self, obs_dist, XY, p, lr, beta):
        return obs_dist.raw_update(XY[0], XY[1], p=p, lr=lr, beta=beta)

    def Elog_like_X_given_Y(self, Y):
        invSigma_x_x, invSigmamu_x, Residual = self.obs_dist.Elog_like_X(Y)
        if self.p is not None:
            invSigma_x_x = (invSigma_x_x * self.p[..., None, None]).sum(-3)
            invSigmamu_x = (invSigmamu_x * self.p[..., None, None]).sum(-3)
            Residual = (Residual * self.p).sum(-1)
        return invSigma_x_x, invSigmamu_x, Residual


class ARHMM_prXY(HMM):
    """(X, Y) supplied as Gaussian messages."""

    def __init__(self, dim, n, p, batch_shape=(), X_mask=None, mask=None, pad_X=True,
                 transition_mask=None, *, generator=None, dtype=None, device=None):
        device = default_device(device)
        dist = _states_mnw(dim, (n, p), batch_shape, pad_X, X_mask, mask, generator,
                           dtype, device)
        super().__init__(dist, transition_mask=transition_mask,
                         generator=generator, dtype=dtype, device=device)

    def _obs_logits(self, obs_dist, XY):
        return obs_dist.Elog_like_given_pX_pY(XY[0], XY[1])

    def _obs_update(self, obs_dist, XY, p, lr, beta):
        return obs_dist.update(XY[0], XY[1], p, lr=lr, beta=beta)

    def Elog_like_X_given_pY(self, pY):
        px, Res = self.obs_dist.Elog_like_X_given_pY(pY)
        invSigma_x_x = px.EinvSigma()
        invSigmamu_x = px.EinvSigmamu()
        if self.p is not None:
            invSigma_x_x = brole_avg(invSigma_x_x, self.p)
            invSigmamu_x = brole_avg(invSigmamu_x, self.p)
            Res = (Res * self.p).sum(-1)
        return invSigma_x_x, invSigmamu_x, Res


class ARHMM_prXRY(HMM):
    """(pX, R, Y) with pX a Gaussian message, R and Y observed; the regressor
    R is spliced onto X with a block-diagonal covariance."""

    def __init__(self, dim, n, p1, p2, batch_shape=(), mask=None, X_mask=None,
                 transition_mask=None, pad_X=False, *, generator=None, dtype=None,
                 device=None):
        device = default_device(device)
        self.p1 = p1
        self.p2 = p2
        dist = _states_mnw(dim, (n, p1 + p2), batch_shape, pad_X, X_mask, mask,
                           generator, dtype, device)
        super().__init__(dist, transition_mask=transition_mask,
                         generator=generator, dtype=dtype, device=device)

    def _splice(self, pX, R):
        shape = pX.shape[:-2]
        Sigma = block_diag_matrix_builder(
            pX.ESigma(), R.new_zeros(shape + (self.p2, self.p2))
        )
        mu = torch.cat([pX.mean(), R.expand(shape + tuple(R.shape[-2:]))], -2)
        return MVN_vf(mu=mu, Sigma=Sigma)

    def _obs_logits(self, obs_dist, XRY):
        pX, R, Y = XRY
        return obs_dist.Elog_like_given_pX_pY(self._splice(pX, R), Delta(Y))

    def _obs_update(self, obs_dist, XRY, p, lr, beta):
        pX, R, Y = XRY
        return obs_dist.update(self._splice(pX, R), Delta(Y), p=p, lr=lr, beta=beta)

    def Elog_like(self, XRY):
        return (self._obs_logits(self.obs_dist, XRY) * self.p).sum(-1)

    def Elog_like_X(self, YR, p=None):
        """The likelihood of the X block in natural parameters, with the R
        block conditioned out; ``p`` overrides the stored assignments."""
        Y, R = YR
        invSigma_xr_xr, invSigmamu_xr, Residual = self.obs_dist.Elog_like_X(Y)
        p1 = self.p1
        invSigma_x_x = invSigma_xr_xr[..., :p1, :p1]
        invSigmamu_x = invSigmamu_xr[..., :p1, :] - invSigma_xr_xr[..., :p1, p1:] @ R
        Residual = Residual - 0.5 * (
            invSigma_xr_xr[..., p1:, p1:] * (R * mT(R))
        ).sum((-1, -2))
        Residual = Residual + (invSigmamu_xr[..., p1:, :] * R).sum((-1, -2))
        if p is None:
            p = self.p
        if p is not None:
            pv = p[..., None, None]
            invSigma_x_x = (invSigma_x_x * pv).sum(-3)
            invSigmamu_x = (invSigmamu_x * pv).sum(-3)
            Residual = (Residual * p).sum(-1)
        return invSigma_x_x, invSigmamu_x, Residual
