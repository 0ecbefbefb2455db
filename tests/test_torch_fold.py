"""The port's time-folded scans (pyvbmp_tpu_torch/ops/scan.py) against the
JAX package's: ``pallas_chunked_scan`` with the fold forced on, whose phase
1 is the Pallas kernel ``_build_folded_call`` in interpret mode, as
tests/test_pallas_scan.py runs it.

On the CPU the port's folded route is its plain version (the three phases in
torch ops), so these tests hold it to the TPU kernel's contract for the
three combines: the (log,+) matmul with masked (-inf) transitions at K = 4
and 14, the plane Kalman combine at H = 4 and 14, the lane Kalman combine at
h = 2; forward, and reverse in chain order (JAX: the swapped combine with
``reverse=True``); an exact fold (T = 20: Cp = 2, L = 10) and a ragged one
(T = 37: Cp = 2, L = 19, one padding row).  float32 (the Pallas kernel is
f32-only).  Bounds: semiring rtol = atol = 1e-4 with the -inf pattern
identical; Kalman leaves max |port - jax| <= 5e-5 of max |jax|.  The fold
decision (``_time_fold_cp``, ``_time_fold_ok``) is held to the JAX
package's on a grid of (T, N, switch)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyvbmp_tpu.ops import pallas_scan
from pyvbmp_tpu.ops import parallel_hmm as jax_hmm
from pyvbmp_tpu.ops import parallel_kalman as jax_pk
from pyvbmp_tpu.ops import smallmat as jax_sm
from pyvbmp_tpu.ops.chunked_scan import swapped_combine
from pyvbmp_tpu.ops.pallas_scan import pallas_chunked_scan
from pyvbmp_tpu_torch.ops import scan

N_LANES = 12
tree_leaves = jax.tree_util.tree_leaves


@pytest.fixture(autouse=True)
def _fold_on(monkeypatch):
    """The fold on both sides at test sizes, and several Pallas time blocks
    per chunk with a ragged tail."""
    monkeypatch.setattr(pallas_scan, "TIME_FOLD", "auto")
    monkeypatch.setattr(pallas_scan, "TIME_FOLD_MIN_T", 8)
    monkeypatch.setattr(pallas_scan, "PALLAS_SCAN_CHUNK", 8)
    monkeypatch.setattr(scan, "TIME_FOLD", "auto")
    monkeypatch.setattr(scan, "TIME_FOLD_MIN_T", 8)


def semiring_elems(rs, T, K, N):
    """(T, K, K, N) log transition + observation logits, two transitions
    masked to -inf."""
    trans = np.log(rs.dirichlet(np.ones(K), (K, N)))  # (K, N, K)
    trans[0, :, K - 1] = -np.inf
    trans[K - 1, :, 0] = -np.inf
    M = trans.transpose(1, 0, 2)[None] + rs.randn(T, N, 1, K)
    return np.ascontiguousarray(M.transpose(0, 2, 3, 1)).astype(np.float32)


def potentials(rs, T, H, N):
    """Dense pair potentials (T, N, ...) whose joint (a, b) precision is
    SPD, so every prefix and suffix is a proper potential."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    return (J[..., :H, :H], J[..., :H, H:], J[..., H:, H:],
            rs.randn(T, N, H), rs.randn(T, N, H), rs.randn(T, N))


def plane_elems(rs, T, H, N):
    """The potentials in plane layout: (T, H, H, N), (T, H, N), (T, N)."""
    plane = lambda x: np.ascontiguousarray(np.moveaxis(x, 1, -1)).astype(np.float32)
    return tuple(plane(x) for x in potentials(rs, T, H, N))


def lane_elems(rs, T, H, N):
    """The potentials as JAX component dicts / lists of (T, N) arrays."""
    Jaa, Jab, Jbb, ha, hb, w = potentials(rs, T, H, N)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    return (
        {(i, j): f32(Jaa[..., i, j]) for (i, j) in jax_sm.sym_idx(H)},
        {(i, j): f32(Jab[..., i, j]) for i in range(H) for j in range(H)},
        {(i, j): f32(Jbb[..., i, j]) for (i, j) in jax_sm.sym_idx(H)},
        [f32(ha[..., i]) for i in range(H)],
        [f32(hb[..., i]) for i in range(H)],
        f32(w),
    )


def packed(tree):
    """A JAX component dict / list -> the port's packed (T, C, N) leaf."""
    return np.stack([np.asarray(x) for x in tree_leaves(tree)], 1)


def jax_scan(combine, elems, reverse):
    """The JAX package's folded scan, called as ops/chunked_scan.py:auto_scan
    calls the Pallas path (a reverse scan runs the swapped combine, giving
    chain order)."""
    leaves = tree_leaves(elems)
    T, N = leaves[0].shape[0], leaves[0].shape[-1]
    assert pallas_scan._time_fold_ok(leaves, T, N)
    fn = swapped_combine(combine) if reverse else combine
    return pallas_chunked_scan(fn, elems, reverse=reverse, interpret=True)


def port_scan(s, leaves, reverse):
    """The port's scan through its public dispatch; asserts that it took the
    folded route."""
    folded, plain = s.folded.plain_calls, s.plain_calls
    out = s(tuple(torch.from_numpy(np.array(x)) for x in leaves), reverse)
    assert s.folded.plain_calls == folded + 1 and s.plain_calls == plain
    return [o.numpy() for o in out]


def assert_kalman_close(out, ref):
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert np.abs(o - r).max() <= 5e-5 * np.abs(r).max()


CASES = [("semiring", 4), ("semiring", 14), ("plane", 4), ("plane", 14), ("lane", 2)]


@pytest.mark.parametrize("T", [20, 37])  # exact and ragged folds
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("combine,size", CASES)
def test_folded_scan_matches_jax(combine, size, reverse, T):
    rs = np.random.RandomState(size * 100 + T)
    assert scan.fold_shape(T, N_LANES) == ((2, 10) if T == 20 else (2, 19))
    if combine == "semiring":
        M = semiring_elems(rs, T, size, N_LANES)
        ref = np.asarray(jax_scan(jax_hmm._logmatmul_plane, M, reverse))
        out = port_scan(scan.LOGSEMIRING, (M,), reverse)[0]
        assert np.array_equal(np.isneginf(out), np.isneginf(ref))
        assert not np.isnan(out).any()
        fin = np.isfinite(ref)
        np.testing.assert_allclose(out[fin], ref[fin], rtol=1e-4, atol=1e-4)
    elif combine == "plane":
        elems = plane_elems(rs, T, size, N_LANES)
        ref = [np.asarray(x) for x in jax_scan(jax_pk._combine_plane, elems, reverse)]
        assert_kalman_close(port_scan(scan.KALMAN_PLANE, elems, reverse), ref)
    else:  # the lane form folds only under TIME_FOLD = "1"
        elems = lane_elems(rs, T, size, N_LANES)
        ref = jax_scan(lambda a, b: jax_pk._combine_lane(size, a, b), elems, reverse)
        ref = [packed(e) for e in ref[:5]] + [np.asarray(ref[5])]
        leaves = [packed(e) for e in elems[:5]] + [np.asarray(elems[5])]
        scan.TIME_FOLD = "1"  # restored by the fixture's monkeypatch
        assert_kalman_close(port_scan(scan.KALMAN_LANE, leaves, reverse), ref)


def test_lane_scan_folds_only_when_forced():
    """Under "auto" a lane scan runs one pass, as the JAX package's
    automatic dispatch never sends a small-N lane layout to the kernel."""
    T, N = 40, 8
    assert scan.KALMAN_PLANE.fold_plan(T, N) == (2, 20)
    assert scan.KALMAN_LANE.fold_plan(T, N) is None
    scan.TIME_FOLD = "1"
    assert scan.KALMAN_LANE.fold_plan(T, N) == (2, 20)
    scan.TIME_FOLD = "0"
    assert all(s.fold_plan(T, N) is None for s in scan.SCANS)


GRID_T = [1, 2, 3, 8, 16, 31, 32, 33, 63, 64, 95, 96, 127, 128, 150, 399, 1000]
GRID_N = [1, 20, 240, 256, 257, 4000]


@pytest.mark.parametrize("switch", ["0", "auto", "1"])
def test_fold_decisions_match_jax(switch, monkeypatch):
    """``_time_fold_cp``, ``_time_fold_ok`` and whether the scan folds at
    all (the JAX package also runs unfolded when L < 2) agree with the JAX
    package's at its default thresholds."""
    for mod in (pallas_scan, scan):
        monkeypatch.setattr(mod, "TIME_FOLD", switch)
        monkeypatch.setattr(mod, "TIME_FOLD_MIN_T", 96)
    for T in GRID_T:
        for N in GRID_N:
            cp = pallas_scan._time_fold_cp(T, N)
            ok = pallas_scan._time_fold_ok(None, T, N)
            assert scan._time_fold_cp(T, N) == cp
            assert scan._time_fold_ok(None, T, N) == ok
            jax_folds = ok and -(-T // cp) >= 2
            assert (scan.LOGSEMIRING.fold_plan(T, N) is not None) == jax_folds, (T, N)
    # the Flocking scans: roles over 20 x 12 lanes, the latent chain over 20
    monkeypatch.setattr(scan, "TIME_FOLD", "auto")
    assert scan.LOGSEMIRING.fold_plan(150, 240) == (8, 19)
    assert scan.KALMAN_PLANE.fold_plan(150, 20) == (8, 19)


@pytest.mark.parametrize("T", [16, 37, 100, 150, 4096])
@pytest.mark.parametrize("reverse", [False, True])
def test_fold_launch_covers_every_row_once(T, reverse):
    """The folded kernels' launch arguments (scan.fold_args): chunk c
    holds rows [c L + offset, (c + 1) L + offset) clipped to [0, T); the
    chunks cover every row once, none is empty, and the one short chunk is
    the last in chain order, whose total no other chunk needs."""
    a = scan.fold_args(T, 3, reverse)
    C, L, offset = a["chunks"], a["L"], a["offset"]
    assert (C, L) == scan.fold_shape(T, 3)
    spans = [(max(c * L + offset, 0), min((c + 1) * L + offset, T)) for c in range(C)]
    assert [t for b, e in spans for t in range(b, e)] == list(range(T))
    sizes = [e - b for b, e in spans]
    last = 0 if reverse else C - 1  # the last chunk in chain order
    assert min(sizes) >= 1
    assert all(n == L for c, n in enumerate(sizes) if c != last)
