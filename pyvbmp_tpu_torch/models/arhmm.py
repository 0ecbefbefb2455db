"""Autoregressive HMM with Gaussian-message inputs (counterpart of
pyvbmp_tpu/models/arhmm.py, class ARHMM_prXRY only): DMBD's role model."""
from __future__ import annotations

import torch

from .hmm import HMM
from ..dists.delta import Delta
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MatrixNormalWishart
from ..utils.linalg import block_diag_matrix_builder
from ..utils.torchutils import default_device


class ARHMM_prXRY(HMM):
    """(pX, R, Y) with pX a Gaussian message, R and Y observed; the regressor
    R is spliced onto X with a block-diagonal covariance."""

    def __init__(self, dim, n, p1, p2, batch_shape=(), mask=None, X_mask=None,
                 transition_mask=None, generator=None, dtype=None,
                 device=None):
        device = default_device(device)
        self.p1 = p1
        self.p2 = p2
        dist = MatrixNormalWishart.create(
            event_shape=(n, p1 + p2),
            batch_shape=tuple(batch_shape) + (dim,),
            X_mask=X_mask,
            mask=mask,
            generator=generator,
            dtype=dtype,
            device=device,
        )
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
