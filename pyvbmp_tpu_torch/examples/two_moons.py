"""Deep gradient-free classifier on two-moons data (counterpart of
examples/two_moons.py, reference examples/two_moons.py:35-66): a
dMixtureofLinearTransforms layer and a MultiNomialLogisticRegression head
trained by forward/backward message passing.  No kernel is on its path.

    python -m pyvbmp_tpu_torch.examples.two_moons
"""
import numpy as np
import torch

from ..dists import MultivariateNormal_vector_format as MVN_vf
from ..transforms import MultiNomialLogisticRegression, dMixtureofLinearTransforms
from ..utils import rng
from ..utils.torchutils import default_device
from ._common import numpy, smoke_mode

ITERS, N, HIDDEN, EXPERTS = 20, 400, 2, 4
SMOKE_ITERS, SMOKE_N = 3, 80


def two_moons(n=N, noise=0.08, seed=0):
    rs = np.random.RandomState(seed)
    t = np.pi * rs.rand(n // 2)
    outer = np.stack([np.cos(t), np.sin(t)], -1)
    inner = np.stack([1 - np.cos(t), -np.sin(t) + 0.5], -1)
    X = np.concatenate([outer, inner]) + noise * rs.randn(n, 2)
    y = np.concatenate([np.zeros(n // 2, int), np.ones(n // 2, int)])
    return X.astype(np.float32), y


def make_data(n=N, device=None, dtype=torch.float32):
    """(pX, the inputs as messages with covariance 1e-4 I; Y, the one-hot
    labels; y, the labels as numpy)."""
    device = default_device(device)
    X, y = two_moons(n)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    eye = torch.eye(2, dtype=dtype, device=device)
    pX = MVN_vf(mu=X[..., None], Sigma=1e-4 * eye.expand(X.shape[0], 2, 2))
    return pX, eye[torch.as_tensor(y, device=device)], y


def build_model(generator=None, device=None, dtype=None):
    """(layer, head)."""
    kw = dict(pad_X=True, generator=generator, dtype=dtype, device=device)
    return (dMixtureofLinearTransforms(HIDDEN, 2, EXPERTS, **kw),
            MultiNomialLogisticRegression(2, HIDDEN, **kw))


def fit(model, pX, Y, iters=ITERS):
    layer, head = model
    for i in range(iters):
        # forward pass through the layer
        pH = layer.forward(pX)
        # train head on layer output
        head.update(pH, Y, iters=1)
        # backward message from labels through the head
        pH_msg, _ = head.backward(Y)
        # combine and update layer
        pH_comb = pH.combiner(pH_msg)
        layer.update(pX, pH_comb, iters=1)
    return model


def predict(model, pX):
    layer, head = model
    return head.forward(layer.forward(pX))


def main(iters=ITERS, device=None, smoke=None, plots=True, dtype=torch.float32):
    smoke = smoke_mode(smoke)
    if smoke:
        iters = SMOKE_ITERS
    device = default_device(device)
    rng.seed(0)
    pX, Y, y = make_data(SMOKE_N if smoke else N, device, dtype)
    model = fit(build_model(rng.next_generator(), device, dtype), pX, Y, iters)
    acc = (numpy(predict(model, pX)).argmax(-1) == y).mean()
    print("two-moons accuracy (gradient-free deep message passing):", acc)
    return acc


if __name__ == "__main__":
    main()
