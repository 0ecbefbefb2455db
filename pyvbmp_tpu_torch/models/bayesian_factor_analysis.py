"""Bayesian factor analysis, y = A z + eps with z ~ N(0, I) (counterpart of
pyvbmp_tpu/models/bayesian_factor_analysis.py): a MatrixNormalGamma loading
matrix A and a Gaussian posterior over each sample's factors z.

The sample sums of the M-step, sum_s y_s y_s' and sum_s y_s <z_s>', are one
matmul over the sample axis each (``_sample_outer``), so no (samples, o, o)
or (samples, o, h) product is made; equal to the JAX package's sums of
outer products in exact arithmetic.

The updates compute in float64 whatever the model's dtype, and cast A, q(z)
and logZ back to it.  Both the ELBO (each sample's -y'<L>y/2 and q(z)'s
mu'P mu/2 cancel from ~5e4 to ~20 at S=100000, o=64, h=8) and the noise
update (sum_s y_s y_s' less the fitted part, ~1e5 to ~1e3) cancel three to
four digits, which in float32 left the ELBO falling between two sweeps at
chip_smoke.py phase 35's size.  No kernel is on this path.  Under
``parallel.data_parallel_update`` (``batch_axis=0``) one ``batch_sum`` a
sweep completes logZ and the M-step's sums over the samples.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MatrixNormalGamma
from ..utils.linalg import mT, psd_inv
from ..utils.torchutils import batch_sum, default_device

F64 = torch.float64


def _sample_outer(A, B, ns):
    """``(A[..., :, None] * B[..., None, :]).sum(range(ns))`` as one matmul
    over the ``ns`` leading sample dims, flattened: A is sample + batch +
    (a,), B sample + batch + (b,) (broadcast against each other)."""
    lead = torch.broadcast_shapes(A.shape[:-1], B.shape[:-1])
    A = A.expand(lead + A.shape[-1:]).reshape((-1,) + lead[ns:] + A.shape[-1:])
    B = B.expand(lead + B.shape[-1:]).reshape((-1,) + lead[ns:] + B.shape[-1:])
    return torch.movedim(A, 0, -1) @ torch.movedim(B, 0, -2)


class BayesianFactorAnalysis:
    def __init__(self, obs_dim, latent_dim, batch_shape=(), pad_X=True, *, generator=None,
                 dtype=None, device=None):
        """The JAX package's signature (``pad_X`` is accepted and unused, as
        there); ``generator``, ``dtype`` and ``device`` (the card unless the
        caller asks for another) are keyword-only."""
        device = default_device(device)
        self.batch_shape = tuple(batch_shape)
        self.batch_dim = len(batch_shape)
        self.event_dim = 2
        self.obs_dim = obs_dim
        self.latent_dim = latent_dim
        self.A = MatrixNormalGamma.create(
            event_shape=(obs_dim, latent_dim), batch_shape=self.batch_shape,
            generator=generator, dtype=dtype, device=device,
        )
        self.ELBO_last = -float("inf")
        self.ELBO_save = []
        self.pz = None
        self.logZ = None

    def to(self, device=None, dtype=None):
        """Move the nodes and the last latents in place; returns self."""
        self.A = self.A.to(device, dtype)
        if self.pz is not None:
            self.pz = self.pz.to(device, dtype)
        for name in ("logZ", "ELBO_last"):
            v = getattr(self, name)
            if isinstance(v, torch.Tensor):
                setattr(self, name, v.to(device=device, dtype=dtype))
        return self

    def _eye(self, dtype=None):
        return torch.eye(self.latent_dim, dtype=dtype or self.A.mu.dtype,
                         device=self.A.mu.device)

    def _posterior(self, A, Y):
        """q(z) for data Y (sample + batch + (obs_dim,)) under A, and the
        residual of A's message."""
        invSigma, invSigmamu, Res = A.Elog_like_X(Y[..., None])
        return MVN_vf(invSigma=invSigma + self._eye(A.mu.dtype), invSigmamu=invSigmamu), Res

    def update_latents(self, Y):
        dtype = self.A.mu.dtype
        pz, Res = self._posterior(self.A.to(dtype=F64), Y.to(F64))
        self.logZ = (Res - pz.Res()).to(dtype)
        self.pz = pz.to(dtype=dtype)

    def update_parms(self, Y, lr=1.0):
        """A's update from the first axis of Y and the current q(z)."""
        dtype = self.A.mu.dtype
        Y, pz = Y.to(F64), self.pz.to(dtype=F64)
        SEzz = pz.EXXT().sum(0)
        SEyy = _sample_outer(Y, Y, 1)
        SEyz = _sample_outer(Y, pz.mean()[..., 0], 1)
        N = torch.as_tensor(float(Y.shape[0]), dtype=F64, device=Y.device)
        SEzz, SEyz, SEyy, N = batch_sum(SEzz, SEyz, SEyy, N)
        self.A = self.A.to(dtype=F64).ss_update(SEzz, SEyz, SEyy, N, lr=lr).to(dtype=dtype)

    def raw_update(self, Y, iters=1, lr=1.0, verbose=False):
        dtype = self.A.mu.dtype
        Y = Y.to(F64)
        for _ in range(iters):
            A, logZ, pz, KL_pre = _bfa_step(self.A.to(dtype=F64), Y, lr, self._eye(F64))
            self.A = A.to(dtype=dtype)
            self.pz = pz.to(dtype=dtype)
            self.logZ = logZ.to(dtype)
            ELBO = (logZ - KL_pre).to(dtype)
            if verbose:
                print("Percent change in ELBO: ",
                      (ELBO - self.ELBO_last) / abs(self.ELBO_last))
            self.ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO.sum()))

    update = raw_update

    def forward(self, pz):
        B = self.A.EinvUX()
        invD = psd_inv(pz.EinvSigma() + self.A.EXTinvUX())
        invSigma_yy = self.A.EinvSigma() - B @ invD @ mT(B)
        invSigmamu_y = B @ invD @ pz.EinvSigmamu()
        return MVN_vf(invSigmamu=invSigmamu_y, invSigma=invSigma_yy)

    def backward(self, pY):
        pz, Res = self.A.Elog_like_X_given_pY(pY)
        pz = MVN_vf(invSigma=pz.EinvSigma() + self._eye(), invSigmamu=pz.EinvSigmamu())
        return pz, Res

    def postdict(self, Y):
        return self._posterior(self.A, Y)[0]

    def ELBO(self):
        return self.logZ.sum() - self.KLqprior()

    def KLqprior(self):
        return self.A.KLqprior()


def _bfa_step(A, Y, lr, eye):
    """One sweep: q(z), logZ summed over the sample dims, A's KL before the
    M-step (the reference's ELBO order, BayesianFactorAnalysis.py:55-60),
    then A's update."""
    Yv = Y[..., None]
    ns = Yv.ndim - 2 - A.batch_dim
    sample_dims = tuple(range(ns))
    invSigma, invSigmamu, Res = A.Elog_like_X(Yv)
    pz = MVN_vf(invSigma=invSigma + eye, invSigmamu=invSigmamu)
    logZ = Res.sum(sample_dims) - pz.Res().sum(sample_dims)
    SEzz = pz.EXXT().sum(sample_dims)
    SEyy = _sample_outer(Y, Y, ns)
    SEyz = _sample_outer(Y, pz.mean()[..., 0], ns)
    N = torch.full(A.batch_shape + A.event_shape[:-2],
                   float(np.prod(Yv.shape[:ns], dtype=np.float64)), dtype=Y.dtype,
                   device=Y.device)
    # the sums over the samples, completed over processes that split them
    logZ, SEzz, SEyz, SEyy, N = batch_sum(logZ, SEzz, SEyz, SEyy, N)
    KL_pre = A.KLqprior()
    A = A.ss_update(SEzz, SEyz, SEyy, N, lr=lr)
    return A, logZ, pz, KL_pre
