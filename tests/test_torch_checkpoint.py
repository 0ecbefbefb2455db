"""Checkpoint and diagnostics of the port (``pyvbmp_tpu_torch.utils.checkpoint``
and ``.diagnostics``): the four tests of tests/test_checkpoint_diagnostics.py
run on the port, on the CPU, plus

- a float32 model saved and loaded stays float32, and one file loads into a
  float32 and a float64 model, each in its own dtype;
- the nested shells of an NLDS (its MNLR transition) and of a BayesNet (a
  list of layers), and a DMBD, resume to the same ELBO;
- a file is read back with ``weights_only=True`` (no pickled class), and a
  checkpoint the JAX package wrote (a pickled JAX tree definition) is
  refused, not read.
The same round trip on the card: ``chip_smoke.py`` phase 37."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from pyvbmp_tpu_torch.dists import Dirichlet
from pyvbmp_tpu_torch.models import (
    BayesNet, DynamicMarkovBlanketDiscovery, GaussianMixtureModel,
    MixtureofLinearDynamicalSystems, NLDS,
)
from pyvbmp_tpu_torch.utils import checkpoint, diagnostics


def gen(seed):
    return torch.Generator().manual_seed(seed)


def _data():
    rs = np.random.RandomState(0)
    mus = np.asarray([[-4.0, 0.0], [4.0, 0.0]])
    return torch.tensor(np.concatenate([mus[i] + rs.randn(80, 2) for i in range(2)], 0))


def gmm(seed, dtype=torch.float64):
    return GaussianMixtureModel(3, 2, generator=gen(seed), device="cpu", dtype=dtype)


def test_checkpoint_roundtrip(tmp_path):
    X = _data()
    m = gmm(0)
    m.update(X, iters=5)
    path = str(tmp_path / "gmm.ckpt")
    checkpoint.save(m, path)
    m2 = gmm(1)  # different random init
    checkpoint.load(m2, path)
    np.testing.assert_allclose(m.dist.mu.numpy(), m2.dist.mu.numpy())
    np.testing.assert_allclose(m.pi.alpha.numpy(), m2.pi.alpha.numpy())
    # resumed model continues from the same ELBO
    m.update(X, iters=1)
    m2.update(X, iters=1)
    np.testing.assert_allclose(float(m.ELBO().sum()), float(m2.ELBO().sum()), rtol=1e-6)


def test_minibatch_resume_beta(tmp_path):
    """beta-accumulated minibatch VB survives a checkpoint boundary."""
    d = Dirichlet.create((3,), generator=gen(0), dtype=torch.float64)
    d = d.ss_update(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), beta=1.0)

    class Holder:
        pass

    h = Holder()
    h.node = d
    path = str(tmp_path / "dir.ckpt")
    checkpoint.save(h, path)
    h2 = Holder()
    h2.node = Dirichlet.create((3,), generator=gen(1), dtype=torch.float64)
    checkpoint.load(h2, path)
    d2 = h2.node.ss_update(torch.ones(3, dtype=torch.float64), beta=1.0)
    np.testing.assert_allclose(
        d2.alpha.numpy(), (h.node.alpha_0 + torch.tensor([2.0, 3.0, 4.0])).numpy(), rtol=1e-6
    )


def test_assert_finite_and_report():
    X = _data()
    m = gmm(0)
    m.update(X, iters=4)
    assert diagnostics.assert_finite(m)
    rep = diagnostics.elbo_report(m)
    assert rep["iters"] == 4 and rep["monotone_after_2"]

    # corrupt a parameter -> detection by name
    alpha = m.pi.alpha.clone()
    alpha[0] = float("nan")
    m.pi = dataclasses.replace(m.pi, alpha=alpha)
    with pytest.raises(FloatingPointError, match=r"pi\.alpha"):
        diagnostics.assert_finite(m, where="sweep 4")


def test_checkpoint_nested_shells(tmp_path):
    """Models holding stateful sub-shells (MixLDS -> inner LDS, NLDS -> MNLR
    transition) roundtrip their nested nodes."""
    rs = np.random.RandomState(1)
    y = torch.tensor(rs.randn(25, 6, 3), dtype=torch.float32)
    a = MixtureofLinearDynamicalSystems(2, (3,), 2, 0, 0, generator=gen(0), device="cpu")
    a.update(y, iters=2)
    pth = str(tmp_path / "mix.pt")
    checkpoint.save(a, pth)
    b = MixtureofLinearDynamicalSystems(2, (3,), 2, 0, 0, generator=gen(9), device="cpu")
    checkpoint.load(b, pth)
    a.update(y, iters=1)
    b.update(y, iters=1)
    assert abs(a.ELBO_save[-1] - b.ELBO_save[-1]) < 1e-2

    n = NLDS((3,), 2, 2, generator=gen(0), device="cpu", dtype=torch.float64)
    n.update(y.double(), iters=2)
    assert "T.beta" in checkpoint.model_state(n)
    checkpoint.save(n, pth)
    n2 = NLDS((3,), 2, 2, generator=gen(5), device="cpu", dtype=torch.float64)
    checkpoint.load(n2, pth)
    assert torch.equal(n2.T.beta.mu, n.T.beta.mu) and torch.equal(n2.p, n.p)
    n.update(y.double(), iters=1)
    n2.update(y.double(), iters=1)
    assert n.ELBO_save[-1] == n2.ELBO_save[-1]


def test_bayesnet_layers_round_trip(tmp_path):
    """A list of shells (BayesNet's layers) is followed under indexed keys."""
    rs = np.random.RandomState(2)
    X = torch.tensor(rs.randn(40, 2))
    Y = torch.eye(2, dtype=torch.float64)[(X[:, 0] > 0).long()]
    a = BayesNet(2, 2, (3, 2), (2, 2), generator=gen(0), device="cpu", dtype=torch.float64)
    a.update(X, Y, iters=2)
    keys = checkpoint.model_state(a)
    assert {"layers.0.A", "layers.1.pi.beta", "head.beta"} <= set(keys)
    checkpoint.save(a, str(tmp_path / "net.pt"))
    b = BayesNet(2, 2, (3, 2), (2, 2), generator=gen(3), device="cpu", dtype=torch.float64)
    checkpoint.load(b, str(tmp_path / "net.pt"))
    assert torch.equal(a.predict(X), b.predict(X))


def test_float32_stays_float32_and_one_file_loads_in_either_dtype(tmp_path):
    X = _data()
    m = gmm(0, torch.float32)
    m.update(X.float(), iters=3)
    path = str(tmp_path / "f32.pt")
    checkpoint.save(m, path)
    for dtype in (torch.float32, torch.float64):
        m2 = checkpoint.load(gmm(4, dtype), path)
        floats = [t for v in checkpoint.model_state(m2).values()
                  for _, t in diagnostics._leaves(v, "") if t.is_floating_point()]
        assert floats and all(t.dtype == dtype and t.device.type == "cpu" for t in floats)
        np.testing.assert_allclose(m2.dist.mu.double().numpy(), m.dist.mu.double().numpy())


def test_dmbd_resumes_to_the_same_elbo(tmp_path):
    rs = np.random.RandomState(3)
    y = torch.tensor(np.cumsum(rs.randn(16, 3, 3, 2) * 0.3, 0))
    make = lambda s: DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2),
                                                   generator=gen(s), device="cpu",
                                                   dtype=torch.float64)
    a = make(0)
    a.update(y, iters=2)
    checkpoint.save(a, str(tmp_path / "dmbd.pt"))
    b = checkpoint.load(make(1), str(tmp_path / "dmbd.pt"))
    a.update(y, iters=1)
    b.update(y, iters=1)
    assert a.ELBO_save[-1] == b.ELBO_save[-1]
    assert diagnostics.assert_finite(b)


def test_files_hold_no_pickled_objects_and_jax_files_are_refused(tmp_path):
    m = gmm(0)
    path = str(tmp_path / "gmm.pt")
    checkpoint.save(m, path)
    state = torch.load(path, weights_only=True)
    assert state["pi"]["__node__"] == "pyvbmp_tpu_torch.dists.dirichlet:Dirichlet"
    # the JAX package's checkpoint of the same model: a pickled tree definition
    from pyvbmp_tpu.models import GaussianMixtureModel as JGMM
    from pyvbmp_tpu.utils import checkpoint as jax_checkpoint

    jax_file = str(tmp_path / "jax.ckpt")
    jax_checkpoint.save(JGMM(3, 2), jax_file)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load(gmm(1), jax_file)
