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


# ------------------------------------------------- the kernel's launch plan
PLAN_CASES = [(S, K, p) for S in (1, 37, 1347, 60000, 400000)
              for K, p in ((1, 1), (9, 65), (16, 32), (17, 33), (9, 257), (40, 31))]
SMS = (1, 7, 66, 114, 132)


@pytest.mark.parametrize("S,K,p", PLAN_CASES)
def test_plan_chunks_cover_the_samples_once(S, K, p):
    for sms in SMS:
        plan = ws._plan(S, K, p, sms)
        assert plan.rows % ws.STAGE_ROWS == 0
        bounds = [(s * plan.rows, min(S, (s + 1) * plan.rows)) for s in range(plan.n_splits)]
        assert bounds[0][0] == 0 and bounds[-1][1] == S
        assert all(a < b for a, b in bounds)  # no empty chunk
        assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
        assert 1 <= plan.group <= ws.MAX_GROUP and plan.threads == 16 * plan.group
        assert (plan.n_groups - 1) * plan.group < K <= plan.n_groups * plan.group


@pytest.mark.parametrize("K,p", [(1, 1), (9, 65), (17, 33), (3, 70), (2, 257)])
def test_plan_scratch_is_what_the_kernel_writes(K, p):
    """Pass 1's writes (csrc/weighted_outer.cu:weighted_outer_partial, one
    8 x 8 micro-tile per active thread) and pass 2's reads (one upper entry
    per split for each output) cover the same offsets, inside the scratch."""
    plan = ws._plan(3000, K, p, 5)
    n_tiles = -(-p // ws.TILE)
    upper = [(ti, tj) for ti in range(n_tiles) for tj in range(ti, n_tiles)]
    pi = [0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 1, 2, 2, 3, 3, 3]  # kPairI, kPairJ
    pj = [0, 1, 2, 3, 1, 2, 3, 2, 3, 3, 0, 0, 1, 0, 1, 2]
    written = set()
    for split in range(plan.n_splits):
        for grp in range(plan.n_groups):
            for tile, (ti, tj) in enumerate(upper):
                for t in range(plan.threads):
                    g, slot = t % plan.group, t // plan.group
                    if ((ti == tj and pi[slot] > pj[slot]) or grp * plan.group + g >= K
                            or ti * 32 + pi[slot] * 8 >= p or tj * 32 + pj[slot] * 8 >= p):
                        continue
                    base = (((split * plan.n_groups + grp) * plan.n_upper + tile)
                            * plan.group + g) * ws.TILE ** 2
                    for u in range(8):
                        for v in range(8):
                            off = base + (pi[slot] * 8 + u) * ws.TILE + pj[slot] * 8 + v
                            assert off not in written
                            written.add(off)
    assert max(written) < plan.scratch
    stride = plan.n_groups * plan.n_upper * plan.group * ws.TILE ** 2
    for k in range(K):
        for i in range(p):
            for j in range(i, p):
                ti, tj = i // ws.TILE, j // ws.TILE
                tile = ti * n_tiles - ti * (ti - 1) // 2 + (tj - ti)
                assert upper[tile] == (ti, tj)
                src = (((k // plan.group) * plan.n_upper + tile) * plan.group + k % plan.group
                       ) * ws.TILE ** 2 + (i % ws.TILE) * ws.TILE + j % ws.TILE
                assert all(src + s * stride in written for s in range(plan.n_splits))


@pytest.mark.parametrize("K,p", [(1, 1), (9, 65), (16, 32), (9, 257), (40, 31)])
def test_plan_fills_every_sm_in_one_wave(K, p):
    """Every SM gets a block, no block waits for a second wave, and no
    chunk is a stage longer than one wave needs."""
    for S in (1347, 60000, 400000, 10 ** 6):
        for sms in SMS:
            plan = ws._plan(S, K, p, sms)
            base = plan.n_groups * plan.n_upper
            blocks = plan.n_splits * base
            resident = sms * plan.blocks_per_sm
            if S >= sms * ws.STAGE_ROWS:
                assert blocks >= sms
            if base <= resident:
                assert blocks <= resident
                want = resident // base
                assert plan.rows == -(-S // (want * ws.STAGE_ROWS)) * ws.STAGE_ROWS
