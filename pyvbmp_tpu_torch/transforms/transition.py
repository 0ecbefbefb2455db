"""Tensor-state Markov transition nodes (counterpart of
pyvbmp_tpu/transforms/transition.py).

- ``Transition``: the full transition tensor p(z'|z) over tensor-valued
  states, a Dirichlet shaped event x event;
- ``HierarchicalTransition``: the chain-factorized transition
  p(x0) p(x1|x0) ..., a list of broadcast-shaped Dirichlets.
"""
from __future__ import annotations

import torch

from ..dists.dirichlet import Dirichlet
from ..utils import math as um
from ..utils.torchutils import Node, as_tensor, node, replace, sum_leading


@node
class Transition(Dirichlet):
    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, generator=None,
               dtype=None, device=None):
        if prior_parms is None:
            prior_parms = {"alpha": 0.5}
        base = Dirichlet.create(event_shape, tuple(batch_shape) + tuple(event_shape),
                                prior_parms=prior_parms, generator=generator, dtype=dtype,
                                device=device)
        return cls(alpha_0=base.alpha_0, alpha=base.alpha, NA=base.NA,
                   event_shape=base.event_shape, batch_shape=base.batch_shape)

    @property
    def left_sum_list(self):
        return tuple(range(-2 * self.event_dim, -self.event_dim))

    @property
    def right_sum_list(self):
        return tuple(range(-self.event_dim, 0))

    def unsqueeze_left(self, X):
        ed = self.event_dim
        return X.reshape(X.shape[: X.ndim - ed] + ed * (1,) + X.shape[X.ndim - ed:])

    def unsqueeze_right(self, X):
        return X.reshape(X.shape + self.event_dim * (1,))

    def forward_filter(self, logits, obs_logits):
        return um.stable_logsumexp(
            self.unsqueeze_right(logits) + self.unsqueeze_left(obs_logits)
            + self.loggeomean(), self.left_sum_list)

    def backward_smoothe(self, logits_t, logits_tplus1):
        xi_logits = um.stable_softmax(self.unsqueeze_right(logits_t) + self.loggeomean(),
                                      self.left_sum_list)
        xi_logits = xi_logits + self.unsqueeze_left(logits_tplus1)
        return um.stable_logsumexp(xi_logits, self.right_sum_list), xi_logits

    def log_forward(self, logits):
        return um.stable_logsumexp(self.unsqueeze_right(logits) + self.loggeomean(),
                                   self.left_sum_list)

    def log_backward(self, logits):
        return um.stable_logsumexp(self.unsqueeze_left(logits) + self.loggeomean(),
                                   self.right_sum_list)

    def KLqprior(self):
        return super().KLqprior().sum(self.right_sum_list)

    def Elog_like(self, X, Y):
        return (self.unsqueeze_right(X) * self.unsqueeze_left(Y) * self.loggeomean()).sum(
            tuple(range(-2 * self.event_dim, 0)))


@node
class HierarchicalTransition(Node):
    dists: list
    NA: torch.Tensor
    event_shape: tuple
    batch_shape: tuple
    sum_list: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, generator=None,
               dtype=None, device=None):
        dims = tuple(event_shape)
        n_dims = len(dims)
        if prior_parms is None:
            alpha_0, alpha_sticky = as_tensor(0.5, dtype, device), 1.0
        else:
            alpha_0, alpha_sticky = as_tensor(prior_parms["alpha"], dtype, device), 0.0
        dists, sum_list = [], []
        for i in range(n_dims):
            shape1 = dims[: i + 1] + (1,) * (n_dims - 1 - i)
            shape2 = (1,) * i + dims[i: i + 1] + (1,) * (n_dims - 1 - i)
            eye = torch.eye(dims[i], dtype=alpha_0.dtype, device=device).reshape(2 * shape2)
            alpha = alpha_0.expand(shape1 + shape2) + alpha_sticky * eye
            dists.append(Dirichlet.create(shape2, tuple(batch_shape) + shape1,
                                          prior_parms={"alpha": alpha}, generator=generator,
                                          dtype=dtype, device=device))
            sl1 = list(range(-2 * n_dims + i + 1, -n_dims))
            sl2 = [x for x in range(-n_dims, 0) if x != -n_dims + i]
            sum_list.append(tuple(sl1 + sl2))
        NA = alpha_0.new_zeros(tuple(batch_shape) + dims + dims)
        return cls(dists=dists, NA=NA, event_shape=dims,
                   batch_shape=tuple(batch_shape) + dims, sum_list=tuple(sum_list))

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    def ss_update(self, NA, lr=1.0, beta=None):
        if beta is not None:
            NA = beta * self.NA + NA
        dists = [d.ss_update(NA.sum(self.sum_list[i], keepdim=True), lr=lr, beta=None)
                 for i, d in enumerate(self.dists)]
        return replace(self, dists=dists, NA=NA)

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        if p is not None:
            X = X * p.reshape(p.shape + (1,) * self.event_dim)
        return self.ss_update(sum_leading(X, self.batch_dim + self.event_dim), lr, beta)

    update = raw_update

    def marginal(self, idx):
        sl = tuple(x for x in range(-self.event_dim, 0) if x != idx)
        return self.mean().sum(sl, keepdim=True)

    def mean(self):
        p = self.dists[0].mean()
        for d in self.dists[1:]:
            p = p * d.mean()
        return p

    def loggeomean(self):
        logp = self.dists[0].ElogX()
        for d in self.dists[1:]:
            logp = logp + d.ElogX()
        return logp

    ElogX = loggeomean

    def KLqprior(self):
        sl = tuple(range(-len(self.dists), 0))
        KL = self.dists[0].KLqprior().sum(sl)
        for d in self.dists[1:]:
            KL = KL + d.KLqprior().sum(sl)
        return KL

    def Elog_like(self, X):
        sl = tuple(range(-self.event_dim, 0))
        return ((X * self.loggeomean()).sum(sl) + torch.lgamma(1 + X.sum(sl))
                - torch.lgamma(1 + X).sum(sl))
