"""The plain reference agrees with the port in float64 on the CPU, from the
same starting state, at both configurations' widths cut to small T and
batch, and its masks are the port's."""
import json

import numpy as np
import pytest
import torch

from cardbench.drivers import dmbd as drv
from cardbench.reference import dmbd as ref
from cardbench.tests.conftest import ROOT

CONFIGS = ("dmbd-lorenz", "dmbd-flocking")


def config(name):
    return json.loads((ROOT / "cardbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,T,batch", [("dmbd-lorenz", 24, 3), ("dmbd-flocking", 16, 2)])
def test_reference_follows_the_port_in_float64(name, T, batch):
    cfg, traffic = config(name), dict(T=T, batch=batch, lr=0.5)
    inputs = drv.make_inputs(cfg, traffic, 2**31 + 17, "cpu")
    inputs["y"] = inputs["y"].double()
    model = drv.build(cfg, inputs, "cpu", torch.float64)
    port = [(drv.sweep(model, inputs, traffic), drv.snapshot(model)) for _ in range(3)]
    for (e_p, leaves_p), (e_r, leaves_r) in zip(port, drv.reference(cfg, inputs, traffic, 3)):
        assert abs(e_p - e_r) <= 1e-9 * abs(e_r)
        for k in drv.LEAVES:
            scale = max(leaves_r[k].abs().max().item(), 1e-30)
            assert (leaves_p[k] - leaves_r[k]).abs().max().item() <= 1e-8 * scale, k


@pytest.mark.parametrize("name,T,batch", [("dmbd-lorenz", 24, 3), ("dmbd-flocking", 16, 2)])
def test_reference_from_the_ports_state_follows_its_next_sweep(name, T, batch):
    """The reference takes up the port's whole state after three sweeps
    (``drivers.dmbd.state``) and its one sweep agrees with the port's
    fourth, as the late check after the window needs."""
    from cardbench import check

    cfg, traffic = config(name), dict(T=T, batch=batch, lr=0.5)
    inputs = drv.make_inputs(cfg, traffic, 2**31 + 29, "cpu")
    inputs["y"] = inputs["y"].double()
    model = drv.build(cfg, inputs, "cpu", torch.float64)
    for _ in range(3):
        drv.sweep(model, inputs, traffic)
    before = drv.state(model)
    port = [(drv.sweep(model, inputs, traffic), drv.snapshot(model))]
    reference = drv.reference_from(cfg, inputs, traffic, before)
    (e_p, leaves_p), (e_r, leaves_r) = port[0], reference[0]
    assert abs(e_p - e_r) <= 1e-9 * abs(e_r)
    for k in drv.LEAVES:
        scale = max(leaves_r[k].abs().max().item(), 1e-30)
        assert (leaves_p[k] - leaves_r[k]).abs().max().item() <= 1e-8 * scale, k
    late = check.compare_late(port, reference, drv.observables(inputs))
    assert late["late_elbo_gap"] <= 1e-9 and late["late_leaf_gap"] <= 1e-8


@pytest.mark.parametrize("name", CONFIGS)
def test_masks_are_the_models(name):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery

    cfg = config(name)
    model = DynamicMarkovBlanketDiscovery(
        tuple(cfg["obs_shape"]), tuple(cfg["role_dims"]), tuple(cfg["hidden_dims"]),
        number_of_objects=cfg["number_of_objects"], dtype=torch.float64, device="cpu")
    A, X, R = ref.masks(cfg["role_dims"], cfg["hidden_dims"], cfg["number_of_objects"])
    assert np.array_equal(np.asarray(model.A.mask).reshape(A.shape), A)
    assert np.array_equal(model.obs_model.obs_dist.X_mask.cpu().numpy().reshape(X.shape), X)
    assert np.array_equal(np.asarray(model.obs_model.transition_mask.cpu()), R)


def test_lower_precision_moves_the_reference():
    """The reference in float32 departs from itself in float64 by far more
    than float64 round-off: the comparison can tell precisions apart."""
    from cardbench import check

    cfg, traffic = config("dmbd-lorenz"), dict(T=40, batch=4, lr=0.5)
    inputs = drv.make_inputs(cfg, traffic, 5, "cpu")
    r64 = drv.reference(cfg, inputs, traffic, 3)
    r32 = drv.reference(cfg, inputs, traffic, 3, dtype=torch.float32)
    again = drv.reference(cfg, inputs, traffic, 3)
    start = drv.start(cfg, inputs)
    low, same = check.compare(r32, r64, start), check.compare(again, r64, start)
    for k in ("elbo_gap", "sweep1_leaf_gap", "sweep3_leaf_gap"):
        assert same[k] == 0.0
        assert low[k] > 1e-9
