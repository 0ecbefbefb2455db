"""The port's lane (component) form against the JAX package's.

- ``ops/smallmat.py``: packing order and the closed-form algebra, against
  pyvbmp_tpu/ops/smallmat.py in float64 (bound 1e-12 relative);
- the plain lane Kalman scan (the CPU side of ``csrc/kalman_lane_scan.cu``)
  against the Pallas scan kernel running ``parallel_kalman._combine_lane`` in
  interpret mode, as tests/test_pallas_scan.py runs it: h = 1, 2, 3, forward
  and reverse, a ragged shape and a sublane-folded one (N = 1024);
- the plain logsemiring scan against the Pallas kernel running
  ``parallel_hmm._logmatmul_lane`` (the lane form of the role-chain combine,
  which ``csrc/logsemiring_scan.cu`` serves in plane layout).

The scans are float32 (the Pallas kernel is f32-only) with rtol = atol =
1e-4, logw relative to its scale."""
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
from pyvbmp_tpu.ops.pallas_scan import eligible, pallas_chunked_scan
from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.ops import smallmat as sm

TOL = 1e-4
tree_leaves = jax.tree_util.tree_leaves


@pytest.fixture(autouse=True)
def _small_chunk(monkeypatch):
    """Several time chunks with a ragged tail, at a fraction of the
    interpret-mode cost."""
    monkeypatch.setattr(pallas_scan, "PALLAS_SCAN_CHUNK", 8)


def packed(tree):
    """A JAX component dict / list -> the port's packed (T, C, N) tensor:
    the components stacked in ``tree_leaves`` order."""
    return torch.from_numpy(np.stack([np.asarray(x) for x in tree_leaves(tree)], 1))


def lane_elems(rs, T, H, N):
    """Lane-form pair potentials (JAX component dicts) whose joint (a, b)
    precision is SPD, so every prefix and suffix is a proper potential."""
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    Jaa, Jab, Jbb = J[..., :H, :H], J[..., :H, H:], J[..., H:, H:]
    ha, hb = rs.randn(T, N, H), rs.randn(T, N, H)
    return (
        {(i, j): f32(Jaa[..., i, j]) for (i, j) in jax_sm.sym_idx(H)},
        {(i, j): f32(Jab[..., i, j]) for i in range(H) for j in range(H)},
        {(i, j): f32(Jbb[..., i, j]) for (i, j) in jax_sm.sym_idx(H)},
        [f32(ha[..., i]) for i in range(H)],
        [f32(hb[..., i]) for i in range(H)],
        f32(rs.randn(T, N)),
    )


def jax_scan(combine, elems, reverse):
    """The Pallas kernel, called as ops/chunked_scan.py:auto_scan calls it
    (a reverse scan runs the swapped combine, giving chain order)."""
    fn = swapped_combine(combine) if reverse else combine
    return pallas_chunked_scan(fn, elems, reverse=reverse, interpret=True)


@pytest.mark.parametrize("T,N", [(13, 37), (10, 1024)])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h", [1, 2, 3])
def test_lane_kalman_scan_matches_pallas(h, reverse, T, N):
    elems = lane_elems(np.random.RandomState(10 * h + T), T, h, N)
    if N == 1024:  # the sublane-folded (T, 8, N/8) path of the TPU kernel
        assert eligible(elems)
    ref = jax_scan(lambda a, b: jax_pk._combine_lane(h, a, b), elems, reverse)
    leaves = [packed(e) for e in elems[:5]] + [torch.from_numpy(np.array(elems[5]))]
    out = scan.kalman_lane_scan(leaves, reverse)
    for i, (o, r) in enumerate(zip(out, ref)):
        o, r = o.numpy(), (packed(r) if i < 5 else torch.from_numpy(np.array(r))).numpy()
        assert o.shape == r.shape
        if i < 5:
            np.testing.assert_allclose(o, r, rtol=TOL, atol=TOL)
        else:  # logw, relative to its scale
            assert np.abs(o - r).max() / np.abs(r).max() <= TOL


@pytest.mark.parametrize("reverse", [False, True])
def test_logsemiring_scan_matches_pallas_lane_form(reverse):
    """The plain (log,+) scan the CUDA kernel is held to, against the
    Pallas kernel running the lane-form combine ``_logmatmul_lane``."""
    K, T, N = 4, 13, 37
    rs = np.random.RandomState(7)
    trans = np.log(rs.dirichlet(np.ones(K), (K, N)))  # (K, N, K)
    trans[0, :, K - 1] = trans[K - 1, :, 0] = -np.inf
    M = trans.transpose(1, 0, 2)[None] + rs.randn(T, N, 1, K)  # (T, N, K, K)
    M = np.ascontiguousarray(M.transpose(0, 2, 3, 1)).astype(np.float32)
    lane = {(i, j): jnp.asarray(M[:, i, j]) for i in range(K) for j in range(K)}
    ref = jax_scan(jax_hmm._lane_combine(K), lane, reverse)
    ref = np.stack([np.asarray(ref[(i, j)]) for i in range(K) for j in range(K)], 1)
    ref = ref.reshape(T, K, K, N)
    out = scan.logsemiring_scan(torch.from_numpy(M), reverse=reverse).numpy()
    assert np.array_equal(np.isneginf(out), np.isneginf(ref))
    assert not np.isnan(out).any()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=TOL, atol=TOL)


# ------------------------------------------------------------------ smallmat
def spd(rs, h, n):
    W = rs.randn(n, h, h)
    return np.einsum("nij,nkj->nik", W, W) + h * np.eye(h)


def comp(tree):
    """A JAX component dict / list of (n,) arrays -> packed (C, n)."""
    return torch.from_numpy(np.stack([np.asarray(x) for x in tree_leaves(tree)], 0))


def to_port(A):
    """(N, h, h) dense -> the port's (C, N) packed upper triangle."""
    return sm.sym_pack(torch.from_numpy(A[None]))[0]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("h", [1, 2, 3])
def test_smallmat_matches_jax(h):
    rs = np.random.RandomState(h)
    n = 11
    A, B = spd(rs, h, n), rs.randn(n, h, h)
    x = rs.randn(n, h)
    with jax.enable_x64(True):
        jA, jB = jax_sm.sym_pack(jnp.asarray(A)), jax_sm.gen_pack(jnp.asarray(B))
        jx = [jnp.asarray(x[:, i]) for i in range(h)]
        jinv, jld = jax_sm.sym_inv_and_logdet(h, jA)
        ref = dict(
            inv=comp(jinv), logdet=np.asarray(jld),
            mm=comp(jax_sm.mm(h, jinv, jB, sym_a=True, t_b=True)),
            mm_sym=comp(jax_sm.mm(h, jB, jB, t_a=True, sym_out=True)),
            mv=comp(jax_sm.mv(h, jB, jx, t_a=True)),
            vdot=np.asarray(jax_sm.vdot(jx, jx)),
            unpacked=np.asarray(jax_sm.sym_unpack(jinv, h)),
        )
    pA = to_port(A)
    pB = sm.gen_pack(torch.from_numpy(B[None]))[0]
    px = sm.vec_pack(torch.from_numpy(x[None, ..., None]))[0]
    # packing order is tree_leaves order of the JAX dicts
    assert torch.equal(pA, comp(jA))
    assert torch.equal(pB, comp(jB))
    inv, ld = sm.sym_inv_and_logdet(h, pA)
    out = dict(
        inv=inv, logdet=ld,
        mm=sm.mm(h, inv, pB, sym_a=True, t_b=True),
        mm_sym=sm.mm(h, pB, pB, t_a=True, sym_out=True),
        mv=sm.mv(h, pB, px, t_a=True),
        vdot=sm.vdot(px, px),
        unpacked=sm.sym_unpack(inv[None], h, (n,))[0],
    )
    for k in ref:
        assert rel(out[k], ref[k]) <= 1e-12, k
    # unpack inverts pack, and the inverse is the dense inverse
    assert torch.equal(sm.sym_unpack(pA[None], h, (n,))[0], torch.from_numpy(A))
    assert rel(out["unpacked"], np.linalg.inv(A)) <= 1e-12


def test_smallmat_refuses_h_above_3():
    with pytest.raises(ValueError, match="h <= 3"):
        sm.sym_inv_and_logdet(4, torch.ones(10, 5))
