"""Directed mixture of any conjugate node with an MNLR gate p(z|x)
(counterpart of pyvbmp_tpu/transforms/dmixture.py; its reference calls
itself "Untested").

The gate's update, ``MultiNomialLogisticRegression.raw_update(X, p)``, takes
the MNLR's bulk-data path for an unbatched gate and 2-D X: its per-class
scatter is ``ops.weighted_scatter.weighted_outer``, the CUDA kernel for a
card tensor, launched twice a sweep (the two Polya-Gamma iterations) at
X (S, p + 1) and weights (S, K - 1).  The gate runs without TF32
(``highest_precision``), which the Polya-Gamma bound needs.
"""
from __future__ import annotations

import dataclasses

import torch

from ..utils.torchutils import default_device, sum_leading
from .mnlr import MultiNomialLogisticRegression


class dMixture:
    def __init__(self, dist, p, *, generator=None, dtype=None, device=None):
        """``dist``'s last batch dim indexes the components; the gate reads
        inputs of width ``p``, its initial draw from ``generator``.  The
        model goes to ``device`` (the card unless the caller asks for
        another) in ``dtype``."""
        dist = dist.to(default_device(device), dtype)
        like = next(v for v in (getattr(dist, f.name) for f in dataclasses.fields(dist))
                    if isinstance(v, torch.Tensor))
        self.event_dim = 1
        self.batch_dim = dist.batch_dim - 1
        self.event_shape = tuple(dist.batch_shape[-1:])
        self.batch_shape = tuple(dist.batch_shape[:-1])
        self.pi = MultiNomialLogisticRegression(
            self.event_shape[-1], p, batch_shape=self.batch_shape, pad_X=True,
            generator=generator, dtype=like.dtype, device=like.device,
        )
        self.dist = dist
        self.logZ = torch.full((), -float("inf"), dtype=like.dtype, device=like.device)
        self.p = self.NA = None
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes and the last assignments in place; returns self."""
        self.pi.to(device, dtype)
        self.dist = self.dist.to(device, dtype)
        for name in ("p", "NA", "logZ"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device=device, dtype=dtype))
        return self

    def _log_p(self, X, Y):
        return (self.dist.Elog_like(Y.unsqueeze(-self.dist.event_dim - 1))
                + self.pi.log_predict(X))

    def update_assignments(self, X, Y):
        log_p = self._log_p(X, Y)
        shift = log_p.max(-1, keepdim=True).values
        p = torch.exp(log_p - shift)
        logZ = p.sum(-1, keepdim=True)
        self.p = p / logZ
        logZ = torch.log(logZ[..., 0]) + shift[..., 0]
        self.NA = sum_leading(self.p, self.event_dim + self.batch_dim)
        self.logZ = sum_leading(logZ, self.batch_dim)

    def update_parms(self, X, Y, lr=1.0):
        self.pi.raw_update(X, self.p, lr=lr)
        self.dist = self.dist.raw_update(Y.unsqueeze(-self.dist.event_dim - 1), self.p, lr)

    def raw_update(self, X, Y, iters=1, lr=1.0, verbose=False):
        ELBO = -float("inf")
        for _ in range(iters):
            ELBO_last = ELBO
            self.update_assignments(X, Y)
            ELBO = self.ELBO()
            self.update_parms(X, Y, lr)
            if verbose:
                print("Percent Change in ELBO:   ",
                      (ELBO - ELBO_last) / abs(ELBO_last) * 100.0)
            self.ELBO_save.append(float(ELBO.sum()))

    def Elog_like(self, X, Y):
        return torch.logsumexp(self._log_p(X, Y), -1)

    def KLqprior(self):
        KL = self.pi.KLqprior() + self.dist.KLqprior().sum(-1)
        for _ in range(self.event_dim - 1):
            KL = KL.sum(-1)
        return KL

    def ELBO(self):
        return self.logZ - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)

    def means(self):
        return self.dist.mean()

    def average(self, A, keepdim=False):
        return (A * self.p).sum(-1, keepdim=keepdim)

    def event_average(self, A, keepdim=False):
        de = self.dist.event_dim
        out = (A * self.p.reshape(self.p.shape + (1,) * de)).sum(-1 - de, keepdim=keepdim)
        for _ in range(self.event_dim - 1):
            out = out.sum(-de - 1, keepdim=keepdim)
        return out
