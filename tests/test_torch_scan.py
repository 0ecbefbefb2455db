"""The port's scans (pyvbmp_tpu_torch/ops/scan.py) against the JAX package's
Pallas scan kernel in interpret mode, as tests/test_pallas_scan.py runs it.

On the CPU the port's scans are the plain folds of the kernels' combines, so
these tests hold the plain versions to the TPU kernel's contract: inclusive,
forward and reverse, chain order, ragged T and N.  float32 throughout (the
Pallas kernel is f32-only); rtol = atol = 1e-4 as in test_pallas_scan.py,
with logw compared relative to its scale (it grows like O(T))."""
import numpy as np
import pytest
import torch

from pyvbmp_tpu.ops import pallas_scan
from pyvbmp_tpu.ops.chunked_scan import swapped_combine
from pyvbmp_tpu.ops.pallas_scan import pallas_chunked_scan
from pyvbmp_tpu.ops.parallel_hmm import _logmatmul_plane as jax_logmatmul_plane
from pyvbmp_tpu.ops.parallel_kalman import _combine_plane as jax_combine_plane
from pyvbmp_tpu_torch.ops import scan

TOL = 1e-4
SHAPES = [(20, 140), (13, 37)]  # multi-chunk + ragged T; N not a multiple of 128


@pytest.fixture(autouse=True)
def _small_chunk(monkeypatch):
    """Several time chunks with a ragged tail, at a fraction of the
    interpret-mode cost."""
    monkeypatch.setattr(pallas_scan, "PALLAS_SCAN_CHUNK", 8)


def semiring_elems(rs, T, K, N):
    """(T, K, K, N) log transition + observation logits with masked (-inf)
    transitions."""
    trans = np.log(rs.dirichlet(np.ones(K), (K, N)))  # (K, N, K)
    trans[0, :, K - 1] = -np.inf
    trans[K - 1, :, 0] = -np.inf
    obs = rs.randn(T, N, K)
    M = trans.transpose(1, 0, 2)[None] + obs[:, :, None, :]  # (T, N, K, K)
    return np.ascontiguousarray(M.transpose(0, 2, 3, 1)).astype(np.float32)


def kalman_elems(rs, T, H, N):
    """Pair potentials with an SPD joint (a, b) precision, plane layout."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    plane = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, -1)).astype(np.float32)
    return (
        plane(J[..., :H, :H]), plane(J[..., :H, H:]), plane(J[..., H:, H:]),
        plane(rs.randn(T, N, H)), plane(rs.randn(T, N, H)),
        rs.randn(T, N).astype(np.float32),
    )


def jax_scan(combine, elems, reverse):
    """The Pallas kernel, called as ops/chunked_scan.py:auto_scan calls it
    (a reverse scan runs the swapped combine, giving chain order)."""
    fn = swapped_combine(combine) if reverse else combine
    return pallas_chunked_scan(fn, elems, reverse=reverse, interpret=True)


@pytest.mark.parametrize("T,N", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_logsemiring_scan_matches_pallas(T, N, reverse):
    M = semiring_elems(np.random.RandomState(T + N), T, 4, N)
    ref = np.asarray(jax_scan(jax_logmatmul_plane, M, reverse))
    out = scan.logsemiring_scan(torch.from_numpy(M), reverse=reverse).numpy()
    assert np.array_equal(np.isneginf(out), np.isneginf(ref))
    assert not np.isnan(out).any()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,N", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_kalman_plane_scan_matches_pallas(T, N, reverse):
    elems = kalman_elems(np.random.RandomState(T * N), T, 6, N)
    ref = jax_scan(jax_combine_plane, elems, reverse)
    out = scan.kalman_plane_scan(tuple(torch.from_numpy(e) for e in elems), reverse)
    for i, (o, r) in enumerate(zip(out, ref)):
        o, r = o.numpy(), np.asarray(r)
        if i < 5:
            np.testing.assert_allclose(o, r, rtol=TOL, atol=TOL)
        else:  # logw, relative to its scale
            assert np.abs(o - r).max() / np.abs(r).max() <= TOL


def test_scans_are_in_chain_order():
    """Reverse scans compose later elements on the right: S[t] = M_t (x)
    S[t+1], not S[t+1] (x) M_t (log-matmul of distinct matrices does not
    commute)."""
    M = torch.from_numpy(semiring_elems(np.random.RandomState(3), 5, 4, 3))
    combine = lambda a, b: torch.logsumexp(
        a.permute(2, 0, 1)[..., :, :, None] + b.permute(2, 0, 1)[..., None, :, :], -2
    ).permute(1, 2, 0)
    fwd = scan.logsemiring_scan(M)
    rev = scan.logsemiring_scan(M, reverse=True)
    P, S = M[0], M[-1]
    for t in range(1, 5):
        P = combine(P, M[t])
        S = combine(M[4 - t], S)
    fin = torch.isfinite(P)
    assert torch.allclose(fwd[-1][fin], P[fin], rtol=1e-5, atol=1e-5)
    fin = torch.isfinite(S)
    assert torch.allclose(rev[0][fin], S[fin], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(P[torch.isfinite(P) & torch.isfinite(S)],
                              S[torch.isfinite(P) & torch.isfinite(S)])


def test_cpu_tensors_take_the_plain_version_and_count_it():
    M = torch.from_numpy(semiring_elems(np.random.RandomState(4), 6, 4, 5))
    before = (scan.LOGSEMIRING.plain_calls, scan.LOGSEMIRING.launches)
    out = scan.logsemiring_scan(M)
    assert torch.equal(out, scan.plain_logsemiring_scan(M))
    assert scan.LOGSEMIRING.plain_calls == before[0] + 2
    assert scan.LOGSEMIRING.launches == before[1]


@pytest.mark.parametrize("which", ["logsemiring", "kalman", "lane"])
def test_kernel_refuses_sizes_it_was_not_built_for(which):
    """A K or H outside the kernel's range (logsemiring K = 0, plane Kalman
    H > 32, lane Kalman H > 3) raises before anything is built or run; there
    is no fallback to the plain version."""
    rs = np.random.RandomState(5)
    if which == "logsemiring":
        s = scan.LOGSEMIRING
        leaves = (torch.zeros((4, 0, 0, 3)),)
    elif which == "kalman":
        s, leaves = scan.KALMAN_PLANE, tuple(
            torch.from_numpy(e) for e in kalman_elems(rs, 4, 33, 3)
        )
    else:  # lane leaves at H=4: 10 symmetric components, 16 general
        s, leaves = scan.KALMAN_LANE, tuple(
            torch.zeros(shape) for shape in scan.KALMAN_LANE.leaf_shapes(4, 4, 3)
        )
    calls = s.plain_calls
    with pytest.raises(ValueError, match="outside the kernel's range"):
        s.kernel(leaves)
    assert s.plain_calls == calls


@pytest.mark.parametrize("which,size", [("logsemiring", 1), ("logsemiring", 8),
                                        ("logsemiring", 40), ("logsemiring", 121),
                                        ("logsemiring", 200), ("kalman", 1),
                                        ("kalman", 16), ("kalman", 32)])
def test_check_takes_every_size_in_range(which, size):
    """Every K >= 1 and every plane H from 1 to 32 passes the launch check
    (the check runs before the kernels are built)."""
    rs = np.random.RandomState(size)
    if which == "logsemiring":
        s, leaves = scan.LOGSEMIRING, (torch.from_numpy(semiring_elems(rs, 3, size, 2)),)
    else:
        s, leaves = scan.KALMAN_PLANE, tuple(
            torch.from_numpy(e) for e in kalman_elems(rs, 3, size, 2))
    assert s.check(leaves) == (3, size, 2)


def test_other_devices_raise():
    M = torch.empty((4, 4, 4, 3), device="meta")
    with pytest.raises(ValueError, match="no version for device"):
        scan.logsemiring_scan(M)
