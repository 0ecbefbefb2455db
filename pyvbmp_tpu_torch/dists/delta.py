"""Point-mass pseudo-distribution wrapping observed tensors so they can be
used as messages (counterpart of pyvbmp_tpu/dists/delta.py)."""
from __future__ import annotations

import torch

from ..utils.linalg import mT
from ..utils.torchutils import Node, node


@node
class Delta(Node):
    X: torch.Tensor

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
        return self.X @ mT(self.X)
