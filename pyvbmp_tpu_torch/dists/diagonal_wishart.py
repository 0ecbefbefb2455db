"""Diagonal Wishart = vector of Gammas (counterpart of
pyvbmp_tpu/dists/diagonal_wishart.py): MatrixNormalGamma's row precisions."""
from __future__ import annotations

import torch

from .gamma import Gamma
from ..utils.torchutils import Node, node, replace


@node
class DiagonalWishart(Node):
    gamma: Gamma
    event_shape: tuple
    batch_shape: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, scale=1.0,
               generator=None, dtype=None, device=None):
        pp = {"nu": 2.0, "U": 0.5}
        if prior_parms is not None:
            pp.update(prior_parms)
        gamma = Gamma.create(
            event_shape,
            batch_shape,
            prior_parms={"alpha": pp["nu"], "beta": scale**2 / pp["U"]},
            generator=generator,
            dtype=dtype,
            device=device,
        )
        return cls(gamma=gamma, event_shape=tuple(event_shape),
                   batch_shape=tuple(batch_shape))

    def ss_update(self, SExx, N, lr=1.0, beta=None):
        """SExx is the diagonal of a scatter matrix."""
        return replace(self, gamma=self.gamma.ss_update(N / 2.0, SExx / 2.0, lr, beta))

    def KLqprior(self):
        return self.gamma.KLqprior()

    @staticmethod
    def tensor_diag(A):
        return torch.diag_embed(A)

    def ESigma(self):
        return self.tensor_diag(self.gamma.meaninv())

    def EinvSigma(self):
        return self.tensor_diag(self.gamma.mean())

    def ElogdetinvSigma(self):
        return self.gamma.loggeomean().sum(-1)

    def mean(self):
        return self.tensor_diag(self.gamma.mean())
