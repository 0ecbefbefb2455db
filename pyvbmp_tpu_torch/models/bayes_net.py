"""Deep gradient-free network (counterpart of pyvbmp_tpu/models/bayes_net.py):
a stack of dMixtureofLinearTransforms layers with a
MultiNomialLogisticRegression head, trained by forward/backward message
passing ("FBI" sweeps).

Each layer and the head draw their initial state from a generator of their
own, seeded from the one the caller gives (the JAX package folds its key
with the layer's index).  The sweeps take the message-valued paths of the
layers and the head, which reach no kernel.

The input layer's update runs in float64 whatever the model's dtype
(``_update_in_float64``): its expected log-likelihoods against the raw
inputs are large terms that cancel (|E log p| ~ 270 on the digits task), so
in float32 the responsibilities, and the layer's expert means after one
sweep, missed float64's by more than the 1e-5 that
tests/test_torch_bfa_bayesnet.py holds them to.  The same update in exact
arithmetic; unchanged for a float64 model.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dists.mvn_vector_format import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MultiNomialLogisticRegression, dMixtureofLinearTransforms
from ..utils.torchutils import default_device


def _layer_generators(generator, n):
    """``n`` CPU generators, each seeded by one draw from ``generator``."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator).tolist()
    return [torch.Generator().manual_seed(s) for s in seeds]


def _update_in_float64(layer, pX, pY, lr):
    """``layer.update(pX, pY, lr=lr)`` computed in float64, the layer then
    cast back to its dtype."""
    dtype = layer.A.mu.dtype
    f64 = torch.float64
    layer.to(dtype=f64)
    layer.update(pX.to(dtype=f64), pY.to(dtype=f64), lr=lr)
    layer.to(dtype=dtype)


class BayesNet:
    def __init__(self, n, p, hidden_dims, mixture_dims, batch_shape=(), pad_X=True, *,
                 generator=None, dtype=None, device=None):
        """The JAX package's signature (every layer pads its input, whatever
        ``pad_X`` says, as there); ``generator``, ``dtype`` and ``device``
        (the card unless the caller asks for another) are keyword-only."""
        device = default_device(device)
        self.num_layers = len(mixture_dims)
        self.mixture_dims = mixture_dims
        self.hidden_dims = hidden_dims
        self.batch_shape = tuple(batch_shape)
        gens = _layer_generators(generator, self.num_layers + 1)
        kw = dict(batch_shape=self.batch_shape, pad_X=True, dtype=dtype, device=device)
        widths = [p] + list(hidden_dims[: self.num_layers - 1])
        self.layers = [
            dMixtureofLinearTransforms(hidden_dims[i], widths[i], mixture_dims[i],
                                       generator=gens[i], **kw)
            for i in range(self.num_layers)
        ]
        self.head = MultiNomialLogisticRegression(n, hidden_dims[-1],
                                                  generator=gens[self.num_layers], **kw)
        self.MSE = []
        self.ELBO_save = []

    def to(self, device=None, dtype=None):
        """Move every layer and the head in place; returns self."""
        for layer in self.layers:
            layer.to(device, dtype)
        self.head.to(device, dtype)
        return self

    def _forward_messages(self, X):
        pX_forward = [self.layers[0].predict(X)[0]]
        for i in range(1, self.num_layers):
            pX_forward.append(self.layers[i].forward(pX_forward[i - 1]))
        return pX_forward

    def update(self, X, Y, iters=1, lr=1.0, verbose=False, FBI=True):
        """Forward/backward message sweeps with interleaved layer updates
        (reference wip_BayesNet.update:43-90)."""
        for _ in range(int(iters)):
            pX_forward = self._forward_messages(X)
            pX_backward = [None] * self.num_layers
            pX = [None] * self.num_layers

            pX_backward[-1] = self.head.backward(Y)[0]
            pX[-1] = pX_forward[-1].combiner(pX_backward[-1])
            if FBI:
                self.head.update(pX[-1], Y, lr=lr)
                pX_backward[-1] = self.head.backward(Y)[0]
                pX[-1] = pX_forward[-1].combiner(pX_backward[-1])

            for n in range(self.num_layers - 1, 0, -1):
                pX_backward[n - 1] = self.layers[n].backward(pX_backward[n])[0]
                pX[n - 1] = pX_forward[n - 1].combiner(pX_backward[n - 1])
                if FBI:
                    self.layers[n].update(pX[n - 1], pX[n], lr=lr)
                    pX_backward[n - 1] = self.layers[n].backward(pX_backward[n])[0]
                    pX[n - 1] = pX_forward[n - 1].combiner(pX_backward[n - 1])

            # the input layer's update from raw X to the first combined message
            eye = torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)
            pX0 = MVN_vf(mu=X[..., None], Sigma=1e-8 * eye, invSigma=1e8 * eye,
                         invSigmamu=1e8 * X[..., None])
            _update_in_float64(self.layers[0], pX0, pX[0], lr)

    def predict(self, X):
        return self.head.forward(self._forward_messages(X)[-1])

    def accuracy(self, X, y_labels):
        pred = self.predict(X).argmax(-1).cpu().numpy()
        if isinstance(y_labels, torch.Tensor):
            y_labels = y_labels.cpu().numpy()
        return (pred == np.asarray(y_labels)).mean()
