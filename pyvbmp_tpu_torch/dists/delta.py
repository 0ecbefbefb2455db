"""Point-mass pseudo-distribution wrapping observed tensors so they can be
used as messages (counterpart of pyvbmp_tpu/dists/delta.py)."""
from __future__ import annotations

import torch

from ..utils.linalg import mT, outer
from ..utils.torchutils import Node, node


@node
class Delta(Node):
    X: torch.Tensor

    def unsqueeze(self, dim):
        return Delta(self.X.unsqueeze(dim))

    def squeeze(self, dim):
        return Delta(self.X.squeeze(dim))

    def sum(self, dim, keepdim=False):
        return self.X.sum(dim, keepdim=keepdim)

    def cumsum(self, dim):
        return self.X.cumsum(dim)

    @property
    def shape(self):
        return tuple(self.X.shape)

    @property
    def dim(self):
        return self.X.shape[-2]

    def mean(self):
        return self.X

    def EX(self):
        return self.X

    def EXXT(self):
        return outer(self.X, self.X)

    def EXTX(self):
        return mT(self.X) @ self.X

    def EXTAX(self, A):
        return mT(self.X) @ A @ self.X

    def EXX(self):
        return self.X**2

    def ElogX(self):
        return torch.log(self.X)

    def E(self, f):
        return f(self.X)
