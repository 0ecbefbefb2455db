"""Multilinear model Y = sum_i A_i X_i + b with a factorized posterior and
one noise precision shared by every factor (counterpart of
pyvbmp_tpu/transforms/multilinear_normal_wishart.py; its reference calls
itself "not working", and the JAX package reproduces its behaviour, the
shared-precision coupling through fixed-precision factors included).

The factors hold the shared noise node as their own ``invU`` (the bias as
its ``invSigma``); after every update ``_sync`` re-attaches the shell's
``invSigma`` to each, as the reference's aliasing would.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists.diagonal_wishart import DiagonalWishart
from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..dists.niw_vector_format import NormalInverseWishart_vector_format_invSigma
from ..dists.wishart import Wishart
from ..utils import math as um
from ..utils.linalg import mT
from ..utils.torchutils import default_device, replace
from .matrix_normal_gamma import MatrixNormalGamma
from .matrix_normal_wishart import MatrixNormalWishart


class MultiLinearNormalWishart:
    def __init__(self, n, p_list, batch_shape=(), mask_list=None, X_mask_list=None,
                 pad_X=False, noise_type="Wishart", generator=None, dtype=None,
                 device=None):
        device = default_device(device)
        self.noise_type = noise_type
        self.pad_X = pad_X
        self.p_list = list(p_list)
        self.n = n
        self.event_dim = 2
        self.batch_dim = len(batch_shape)
        self.event_shape = (n, 0)
        self.batch_shape = tuple(batch_shape)
        if mask_list is None:
            mask_list = [None] * len(p_list)
        if X_mask_list is None:
            X_mask_list = [None] * len(p_list)
        kw = dict(dtype=dtype, device=device)
        if noise_type == "Wishart":
            self.invSigma = Wishart.create((n, n), self.batch_shape, **kw)
            cls = MatrixNormalWishart
        else:
            self.invSigma = DiagonalWishart.create((n,), self.batch_shape,
                                                   generator=generator, **kw)
            cls = MatrixNormalGamma
        self.A = [
            cls.create((n, p), self.batch_shape, mask=mask_list[i], X_mask=X_mask_list[i],
                       fixed_precision=True, pad_X=False, generator=generator, **kw)
            for i, p in enumerate(self.p_list)
        ]
        self.bias = NormalInverseWishart_vector_format_invSigma.create(
            event_shape=(n, 1), batch_shape=self.batch_shape, fixed_precision=True, **kw
        )
        self._sync()

    def to(self, device=None, dtype=None):
        """Move the nodes in place; returns self."""
        self.invSigma = self.invSigma.to(device, dtype)
        self.A = [A.to(device, dtype) for A in self.A]
        self.bias = self.bias.to(device, dtype)
        self._sync()
        return self

    def _sync(self):
        """Hand the shared noise node to every factor."""
        self.A = [replace(A, invU=self.invSigma) for A in self.A]
        self.bias = replace(self.bias, invSigma=self.invSigma)

    def raw_update(self, X_list, Y, p=None, iters=1, lr=1.0, beta=None):
        nd = self.event_dim + self.batch_dim
        sample_shape = Y.shape[: Y.ndim - nd]
        sdims = tuple(range(len(sample_shape)))
        if p is None:
            N = Y.new_full(self.batch_shape + self.event_shape[:-2],
                           float(np.prod(sample_shape, dtype=np.float64)))
        else:
            N = p.sum(sdims)

        Y_res = Y - self.bias.mean()
        for i in range(len(self.p_list)):
            Y_res = Y_res - self.A[i].mean() @ X_list[i]

        for _ in range(iters):
            for i in range(len(self.p_list)):
                Y_res = Y_res + self.A[i].mean() @ X_list[i]
                self.A[i] = self.A[i].raw_update(X_list[i], Y_res, p=p, lr=lr, beta=beta)
                Y_res = Y_res - self.A[i].weights() @ X_list[i]
            Y_res = Y_res + self.bias.mean()
            self.bias = self.bias.raw_update(Y_res, p=p, lr=lr,
                                             beta=0.0 if beta is None else beta)
            Y_res = Y_res - self.bias.mean()

        if p is None:
            SEyy = (Y_res * mT(Y_res)).sum(sdims)
        else:
            SEyy = (Y_res * mT(Y_res) * p.reshape(p.shape + (1, 1))).sum(sdims)
        # the prior terms, the bias's once per factor: the JAX package's
        # (and its reference's) loop, kept
        for A in self.A:
            SEyy = SEyy + A.mu_0 @ A.invV_0 @ mT(A.mu_0)
            SEyy = SEyy + self.bias.mu_0 @ mT(self.bias.mu_0) * self.bias.lmbda_0

        if self.noise_type == "Wishart":
            self.invSigma = self.invSigma.ss_update(SEyy, N, lr, beta)
        else:
            self.invSigma = self.invSigma.ss_update(
                torch.diagonal(SEyy, dim1=-1, dim2=-2), N[..., None], lr, beta
            )
        self._sync()

    def Elog_like(self, X_list, Y):
        temp = Y - self.bias.mean()
        ELL = (
            0.5 * self.ElogdetinvSigma()
            - 0.5 * self.n * um.LOG2PI
            - 0.5 * self.bias.EXmMUTinvUXmMU()[..., 0, 0]
        )
        for A, X in zip(self.A, X_list):
            temp = temp - A.mean() @ X
            ELL = ELL - 0.5 * (mT(X) @ A.EXmMUTinvUXmMU() @ X)[..., 0, 0]
        return ELL - 0.5 * (mT(temp) @ self.EinvSigma() @ temp)[..., 0, 0]

    def predict(self, X_list):
        mu_y = self.bias.mean()
        Res = -0.5 * self.bias.EXmMUTinvUXmMU()
        for A, X in zip(self.A, X_list):
            mu_y = mu_y + A.mean() @ X
            Res = Res - 0.5 * (mT(X) @ A.EXmMUTinvUXmMU() @ X)
        return (
            MVN_vf(invSigma=self.EinvSigma(), Sigma=self.ESigma(),
                   invSigmamu=self.EinvSigma() @ mu_y, mu=mu_y),
            Res[..., 0, 0],
        )

    def forward(self, pX_list):
        mu_y = self.bias.mean()
        Sigma_y = 0.0
        Res = 0.0
        for A, pX in zip(self.A, pX_list):
            pY_i, Res_i = A.forward(pX)
            mu_y = mu_y + pY_i.mean()
            Sigma_y = Sigma_y + pY_i.ESigma()
            Res = Res + Res_i
        return MVN_vf(mu=mu_y, Sigma=Sigma_y), Res

    def postdict(self, Y, iters=10):
        """Each factor's message to its input given Y, by ``iters`` sweeps
        of backfitting (``iters`` must exceed 1, as in the JAX package)."""
        assert iters > 1
        Y_res = Y - self.bias.mean()
        pX_list = [None] * len(self.p_list)
        for i, A in enumerate(self.A):
            pX_list[i] = A.postdict(Y_res)[0]
            Y_res = Y_res - A.mean() @ pX_list[i].mean()
        for _ in range(iters - 1):
            for i, A in enumerate(self.A):
                Y_res = Y_res + A.mean() @ pX_list[i].mean()
                pX_list[i] = A.postdict(Y_res)[0]
                Y_res = Y_res - A.mean() @ pX_list[i].mean()
        return pX_list

    def KLqprior(self):
        KL = -self.invSigma.KLqprior() * (len(self.p_list) - 1)
        for A in self.A:
            KL = KL + A.KLqprior()
        return KL

    def ElogdetinvSigma(self):
        return self.invSigma.ElogdetinvSigma()

    def EinvSigma(self):
        return self.invSigma.EinvSigma()

    def ESigma(self):
        return self.invSigma.ESigma()
