"""Generic mixture over any conjugate node whose trailing batch dims index
the mixture components (counterpart of pyvbmp_tpu/dists/mixture.py).

One VB-EM iteration (``_mixture_step``: E-step assignments, ELBO, M-step)
is a pure function of the (pi, dist) nodes; ``update`` runs it ``iters``
times eagerly and fetches the ELBO trajectory from the device once.  It
reaches no kernel: the JAX package's mixtures run no Pallas kernel either.
"""
from __future__ import annotations

import dataclasses

import torch

from .dirichlet import Dirichlet
from ..utils import math as um
from ..utils.torchutils import sum_leading


class Mixture:
    def __init__(self, dist, event_shape, prior_parms=None, *, generator=None):
        """``dist``'s trailing batch dims must be ``event_shape``; the
        mixture weights pi are built like ``dist`` (dtype and device), their
        initial draw from ``generator``."""
        assert tuple(dist.batch_shape[-len(event_shape):]) == tuple(event_shape)
        self.event_shape = tuple(event_shape)
        self.event_dim = len(event_shape)
        self.batch_shape = tuple(dist.batch_shape[: -len(event_shape)])
        self.batch_dim = len(self.batch_shape)
        like = next(v for v in (getattr(dist, f.name) for f in dataclasses.fields(dist))
                    if isinstance(v, torch.Tensor))
        self.pi = Dirichlet.create(
            self.event_shape, self.batch_shape, prior_parms=prior_parms,
            generator=generator, dtype=like.dtype, device=like.device,
        )
        self.dist = dist
        self.logZ = torch.full((), -float("inf"), dtype=like.dtype, device=like.device)
        self.ELBO_last = -float("inf")
        self.p = None
        self.NA = None
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move the nodes and the state in place; returns self."""
        self.pi = self.pi.to(device, dtype)
        self.dist = self.dist.to(device, dtype)
        for name in ("p", "NA"):
            v = getattr(self, name)
            if v is not None:
                setattr(self, name, v.to(device=device, dtype=dtype))
        self.logZ = self.logZ.to(device=device, dtype=dtype)
        return self

    # -- pure pieces -----------------------------------------------------------
    def _reshape_data(self, X):
        return X.reshape(
            tuple(X.shape[: X.ndim - self.dist.event_dim])
            + self.event_dim * (1,)
            + tuple(self.dist.event_shape)
        )

    def Elog_like(self, X):
        return self.dist.Elog_like(self._reshape_data(X)) + self.pi.loggeomean()

    def update_assignments(self, X):
        self.p, self.NA, self.logZ = _assignments(
            self.event_dim, self.batch_dim, self.pi, self.dist, self._reshape_data(X)
        )

    def update_parms(self, X, lr=1.0):
        self.pi = self.pi.ss_update(self.NA, lr=lr)
        self.dist = self.dist.raw_update(self._reshape_data(X), self.p, lr)

    def update(self, X, iters=1, lr=1.0, verbose=False):
        """``iters`` VB-EM iterations on data X: sample + batch + the
        component node's event shape."""
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        Xv = self._reshape_data(X)
        ELBOs = []
        for _ in range(iters):
            self.pi, self.dist, self.p, self.NA, self.logZ, ELBO = _mixture_step(
                self.event_dim, self.batch_dim, self.pi, self.dist, Xv, lr
            )
            ELBOs.append(ELBO)
        # one host fetch for the whole trajectory
        for ELBO in torch.stack(ELBOs).cpu():
            if verbose:
                pct = (ELBO - self.ELBO_last) / abs(self.ELBO_last) * 100.0
                print("Percent Change in ELBO:   ", pct)
            self.ELBO_last = ELBO
            self.ELBO_save.append(float(ELBO.sum()))

    raw_update = update

    def KLqprior(self):
        return self.dist.KLqprior().sum(tuple(range(-self.event_dim, 0))) \
            + self.pi.KLqprior()

    def ELBO(self):
        return self.logZ - self.KLqprior()

    def assignment_pr(self):
        return self.p

    def assignment(self):
        return self.p.argmax(-1)

    def means(self):
        return self.dist.mean()

    # -- expectation averaging --------------------------------------------------
    def average(self, A, keepdim=False):
        return (A * self.p).sum(-1, keepdim=keepdim)

    def event_average(self, A, keepdim=False):
        de = self.dist.event_dim
        out = (A * self.p.reshape(self.p.shape + (1,) * de)).sum(-1 - de, keepdim=keepdim)
        for _ in range(self.event_dim - 1):
            out = out.sum(-de - 1, keepdim=keepdim)
        return out

    def event_average_f(self, fname, A=None, keepdim=False):
        f = getattr(self.dist, fname)
        return self.event_average(f() if A is None else f(A), keepdim=keepdim)

    def average_f(self, fname, A=None, keepdim=False):
        f = getattr(self.dist, fname)
        return self.average(f() if A is None else f(A), keepdim=keepdim)


def _assignments(event_dim, batch_dim, pi, dist, Xv):
    """The E-step: assignments p, their counts NA and logZ (batch-shaped)."""
    log_p = dist.Elog_like(Xv) + pi.loggeomean()
    logZ = um.stable_logsumexp(log_p, tuple(range(-event_dim, 0)))
    p = torch.exp(log_p - logZ.reshape(logZ.shape + (1,) * event_dim))
    return p, sum_leading(p, batch_dim + event_dim), sum_leading(logZ, batch_dim)


def _mixture_step(event_dim, batch_dim, pi, dist, Xv, lr):
    """One VB-EM iteration: E-step, ELBO (with the KL of the nodes it
    started from), M-step."""
    p, NA, logZ = _assignments(event_dim, batch_dim, pi, dist, Xv)
    ELBO = logZ - (dist.KLqprior().sum(tuple(range(-event_dim, 0))) + pi.KLqprior())
    pi = pi.ss_update(NA, lr=lr)
    dist = dist.raw_update(Xv, p, lr)
    return pi, dist, p, NA, logZ, ELBO
