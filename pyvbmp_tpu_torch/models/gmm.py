"""Gaussian and Poisson mixture models (counterpart of
pyvbmp_tpu/models/gmm.py).  Each builds on the card unless the caller asks
for another device, and draws its initial state from a ``torch.Generator``."""
from __future__ import annotations

import torch

from ..dists import Gamma, NormalGamma, NormalInverseWishart
from ..dists.mixture import Mixture
from ..utils.torchutils import default_device, replace


class GaussianMixtureModel(Mixture):
    def __init__(self, nc, dim, isotropic=False, *, generator=None, dtype=None,
                 device=None):
        """``nc`` components over ``dim``-vectors: NormalInverseWishart
        components, or NormalGamma (diagonal precisions) with
        ``isotropic=True``."""
        device = default_device(device)
        create = NormalGamma.create if isotropic else NormalInverseWishart.create
        dist = create(event_shape=(dim,), batch_shape=(nc,), scale=1.0 / nc ** (1.0 / dim),
                      generator=generator, dtype=dtype, device=device)
        super().__init__(dist, event_shape=(nc,), generator=generator)

    def initialize(self, data, generator=None):
        """Seed the component means with random rows of ``data`` (n, dim)."""
        idx = torch.randint(0, data.shape[0], self.event_shape, generator=generator)
        self.dist = replace(self.dist, mu=data[idx.to(data.device), :])


class PoissonMixtureModel(Mixture):
    def __init__(self, nc, dim, *, generator=None, dtype=None, device=None):
        """``nc`` components of ``dim`` Poisson rates with Gamma posteriors."""
        dist = Gamma.create(event_shape=(dim,), batch_shape=(nc,), generator=generator,
                            dtype=dtype, device=default_device(device))
        super().__init__(dist, event_shape=(nc,), generator=generator)
