"""The port's plain weighted scatter (``weighted_outer_einsum``, what
``weighted_outer`` runs for a CPU tensor) against the JAX package: its
Pallas kernel ``weighted_outer_pallas`` in interpret mode (float32,
rtol = atol = 2e-4, as tests/test_untested_components.py holds the kernel to
the einsum) and its einsum (float64, max |port - jax| / max |jax| <= 1e-12:
the two sum in different orders).  The CUDA kernel itself is
held to the plain version on the card in tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.ops.weighted_scatter import weighted_outer as jax_weighted_outer
from pyvbmp_tpu.ops.weighted_scatter import weighted_outer_einsum as jax_einsum
from pyvbmp_tpu_torch.ops import weighted_scatter as ws

SHAPES = [(512, 8, 3), (1024, 33, 5), (1347, 65, 9)]  # the last: digits


def inputs(S, p, K):
    rs = np.random.RandomState(S + p + K)
    return rs.randn(S, p), rs.rand(S, K)


@pytest.mark.parametrize("S,p,K", SHAPES)
def test_plain_matches_pallas_interpret(S, p, K):
    X, W = (a.astype(np.float32) for a in inputs(S, p, K))
    ref = jax_weighted_outer(jnp.asarray(X), jnp.asarray(W), force="pallas",
                             interpret=True)
    out = ws.weighted_outer_einsum(torch.from_numpy(X), torch.from_numpy(W))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,p,K", SHAPES)
def test_plain_matches_jax_einsum_float64(S, p, K):
    X, W = inputs(S, p, K)
    with jax.enable_x64(True):
        ref = np.asarray(jax_einsum(jnp.asarray(X), jnp.asarray(W)))
    out = ws.weighted_outer_einsum(torch.from_numpy(X), torch.from_numpy(W))
    assert np.abs(out.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def test_cpu_tensors_take_the_plain_version():
    X, W = (torch.from_numpy(a) for a in inputs(70, 4, 2))
    launches, plain = ws.WEIGHTED_OUTER.launches, ws.WEIGHTED_OUTER.plain_calls
    out = ws.weighted_outer(X, W)
    assert out.shape == (2, 4, 4)
    assert ws.WEIGHTED_OUTER.plain_calls == plain + 1
    assert ws.WEIGHTED_OUTER.launches == launches
    ref = torch.einsum("sk,si,sj->kij", W, X, X)
    torch.testing.assert_close(out, ref, rtol=1e-12, atol=1e-12)
