"""Chain-factorized Dirichlet over a tensor-valued event (counterpart of
pyvbmp_tpu/dists/hierarchical_dirichlet.py).

p(x_0, ..., x_{n-1}) = p(x_0) p(x_1|x_0) ... p(x_{n-1}|x_{n-2}) is held as a
list of broadcast-shaped Dirichlets:
  dists[0]   ~ p(x_0):         event (e_0, 1, ..., 1),     batch batch_shape
  dists[k+1] ~ p(x_{k+1}|x_k): event (e_{k+1}, 1, ...),    batch batch + (1,)*k + (e_k,)
The joint expectations broadcast-multiply (or add) the chain back to the
full event shape.
"""
from __future__ import annotations

import torch

from .dirichlet import Dirichlet
from ..utils.torchutils import Node, node, replace, sum_leading


@node
class Hierarchical_Dirichlet(Node):
    dists: list
    NA: torch.Tensor
    event_shape: tuple
    batch_shape: tuple
    sum_list: tuple

    @classmethod
    def create(cls, event_shape, batch_shape=(), prior_parms=None, generator=None,
               dtype=None, device=None):
        event_shape = tuple(event_shape)
        batch_shape = tuple(batch_shape)
        n_dims = len(event_shape)
        kw = dict(prior_parms=prior_parms, generator=generator, dtype=dtype, device=device)
        dists = [Dirichlet.create(event_shape[:1] + (1,) * (n_dims - 1), batch_shape, **kw)]
        sum_list = [tuple(range(-n_dims + 1, 0))]
        for i in range(n_dims - 1):
            shape = event_shape[i + 1: i + 2] + (1,) * (n_dims - 2 - i)
            bshape = batch_shape + (1,) * i + event_shape[i: i + 1]
            dists.append(Dirichlet.create(shape, bshape, **kw))
            sum_list.append(tuple(range(-n_dims, -n_dims + i))
                            + tuple(range(-n_dims + i + 2, 0)))
        NA = dists[0].alpha.new_zeros(batch_shape + event_shape)
        return cls(dists=dists, NA=NA, event_shape=event_shape, batch_shape=batch_shape,
                   sum_list=tuple(sum_list))

    @property
    def event_dim(self):
        return len(self.event_shape)

    @property
    def batch_dim(self):
        return len(self.batch_shape)

    def ss_update(self, NA, lr=1.0, beta=None):
        if beta is not None:
            NA = beta * self.NA + NA
        # ``beta`` goes on to the children after NA has been decayed here, so
        # they decay their own stored statistics a second time: the JAX
        # package's (and its reference's) behaviour, kept for parity
        dists = [
            d.ss_update(NA.sum(self.sum_list[i], keepdim=True) if self.sum_list[i] else NA,
                        lr=lr, beta=beta)
            for i, d in enumerate(self.dists)
        ]
        return replace(self, dists=dists, NA=NA)

    def raw_update(self, X, p=None, lr=1.0, beta=None):
        if p is not None:
            X = X * p.reshape(p.shape + (1,) * self.event_dim)
        return self.ss_update(sum_leading(X, self.batch_dim + self.event_dim), lr, beta)

    update = raw_update

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
        KL = self.dists[0].KLqprior()
        for i, d in enumerate(self.dists[1:], start=1):
            KL = KL + d.KLqprior().sum(tuple(range(-i, 0)))
        return KL
