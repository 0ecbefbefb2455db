"""The batched SPD inverse (``ops/spd_inverse.py``, ``csrc/spd_inverse.cu``).

On the CPU (tier 1): the three entry points that route through it
(``utils/linalg.py:psd_inv``, ``psd_inv_and_logdet``,
``ops/planemat.py:bsym_inv_and_logdet``) give bit for bit what the
``cholesky_ex`` + ``cholesky_inverse`` code they replaced gives, and the
kernel's view of a batch (``batch_args``) addresses every matrix of any
strided input in order.

On the card (marked ``gpu``, skipped without one; a CUDA kernel has no CPU
mode): the kernel against its plain version in float32 and in float64 for
every n from 1 to 32 in both layouts, strided and broadcast inputs, batch
sizes around the blocks', the symmetrizing and lower-triangle readings, a
failed factorization, no host sync at the cells' shapes, and the counters.
Run them there with ``python -m pytest --noconftest
tests/test_torch_spd_inverse.py``.

Tolerance on the card: max |kernel - reference| / max |reference| <= 1e-4
per output, the repository's kernel bound (the inputs' condition numbers are
below ~20, so float32 gives ~1e-6); and the kernel no less accurate than the
library's float32 route: its error against float64 at most 4 times the
library's, plus 1e-6 (the two sum in different orders).
"""
import numpy as np
import pytest
import torch

from pyvbmp_tpu_torch.ops import planemat
from pyvbmp_tpu_torch.ops import spd_inverse as si
from pyvbmp_tpu_torch.utils import linalg

TOL = 1e-4
gpu = pytest.mark.gpu


# ------------------------------------------------------------- references
def old_chol(A, jitter):
    """utils/linalg.py:chol as the entry points used it."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky_ex(0.5 * (A + A.transpose(-1, -2))).L


def old_logdet(L):
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


def old_psd_inv(A, jitter):
    return torch.cholesky_inverse(old_chol(A, jitter))


def old_psd_inv_and_logdet(A, jitter):
    L = old_chol(A, jitter)
    return torch.cholesky_inverse(L), old_logdet(L)


def old_bsym_inv_and_logdet(A):
    L = torch.linalg.cholesky_ex(A.movedim(-1, -3)).L
    return torch.cholesky_inverse(L).movedim(-3, -1), old_logdet(L)


def spd(rs, batch, n, dtype=torch.float64, device="cpu"):
    """Dense (batch..., n, n) SPD matrices, eigenvalues ~0.5-5."""
    X = rs.randn(*batch, n, n)
    A = X @ np.swapaxes(X, -1, -2) / n + 0.5 * np.eye(n)
    return torch.tensor(A, dtype=dtype, device=device)


def to_plane(A):
    """(..., N, n, n) -> contiguous (..., n, n, N)."""
    return A.movedim(-3, -1).contiguous()


# ------------------------------------------------------------- CPU (tier 1)
# bsym_inv_and_logdet adds no jitter
ENTRIES = [("psd_inv", 0.0), ("psd_inv", 1e-3), ("psd_inv_and_logdet", 0.0),
           ("psd_inv_and_logdet", 1e-3), ("bsym_inv_and_logdet", 0.0)]


@pytest.mark.parametrize("n", [1, 2, 6, 7, 26, 27, 33])
@pytest.mark.parametrize("entry,jitter", ENTRIES)
def test_cpu_route_is_the_library_code_bit_for_bit(n, entry, jitter, monkeypatch):
    monkeypatch.setattr(linalg, "PSD_JITTER", jitter)
    rs = np.random.RandomState(n)
    for dtype in (torch.float64, torch.float32):
        A = spd(rs, (3, 4), n, dtype)
        A = A + 1e-3 * torch.tensor(rs.randn(n, n), dtype=dtype)  # not symmetric
        before = si.SPD_INVERSE.plain_calls
        if entry == "psd_inv":
            got, want = (linalg.psd_inv(A),), (old_psd_inv(A, jitter),)
        elif entry == "psd_inv_and_logdet":
            got, want = linalg.psd_inv_and_logdet(A), old_psd_inv_and_logdet(A, jitter)
        else:
            P = to_plane(A)
            got, want = planemat.bsym_inv_and_logdet(P), old_bsym_inv_and_logdet(P)
        assert si.SPD_INVERSE.plain_calls == before + 1
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert torch.equal(g, w)


def storage_view(x):
    """x's whole storage as a flat tensor, and x's offset into it."""
    flat = torch.empty(0, dtype=x.dtype).set_(
        x.untyped_storage(), 0, (x.untyped_storage().nbytes() // x.element_size(),))
    return flat, x.storage_offset()


def addressed(x, n, lanes, sb, sl, sr, sc, count):
    """The (count, n, n) matrices the kernel reads from x's storage: matrix g
    = b * lanes + l at b * sb + l * sl, entry (i, j) at + i * sr + j * sc."""
    flat, off = storage_view(x)
    g = torch.arange(count)
    base = (g // lanes) * sb + (g % lanes) * sl
    i = torch.arange(n)
    idx = off + base[:, None, None] + i[None, :, None] * sr + i[None, None, :] * sc
    return flat[idx]


def layouts():
    """(label, A, plane): dense and plane inputs, contiguous and not."""
    rs = np.random.RandomState(0)
    n = 3
    D = spd(rs, (4, 5), n)
    P = to_plane(spd(rs, (6, 7), n))
    return [
        ("dense", D, False),
        ("dense one matrix", D[1, 2], False),
        ("dense transposed batch", D.transpose(0, 1), False),
        ("dense transposed matrices", D.transpose(-1, -2), False),
        ("dense broadcast", D[:, :1].expand(4, 5, n, n), False),
        ("dense three batch dims, strided", spd(rs, (2, 3, 4), n)[:, ::2], False),
        ("plane", P, True),
        ("plane one row", P[:1], True),
        ("plane sliced rows", P[::2], True),
        ("plane sliced lanes", P[..., 1:6], True),
        ("plane lanes not minor", spd(rs, (6, 7), n).permute(0, 2, 3, 1), True),
        ("plane two leading dims", to_plane(spd(rs, (2, 3, 5), n)), True),
        ("plane broadcast leading", P[:1].expand(3, n, n, 7), True),
        ("plane permuted leading", to_plane(spd(rs, (2, 3, 5), n)).transpose(0, 1), True),
    ]


@pytest.mark.parametrize("case", range(len(layouts())), ids=[c[0] for c in layouts()])
def test_batch_args_address_every_matrix_in_order(case):
    _, A, plane = layouts()[case]
    n = A.shape[-2]
    out = si.output(A, plane)
    A2, (lanes, sb, sl, sr, sc), (ob, ol, o_r, oc) = si.batch_args(A, out, plane)
    want = A.movedim(-1, -3) if plane else A
    want = want.reshape(-1, n, n)
    count = want.shape[0]
    assert torch.equal(addressed(A2, n, lanes, sb, sl, sr, sc, count), want)
    out.copy_(torch.arange(out.numel(), dtype=out.dtype).reshape(out.shape))
    got = addressed(out, n, lanes, ob, ol, o_r, oc, count)
    assert torch.equal(got, (out.movedim(-1, -3) if plane else out).reshape(-1, n, n))
    # the kernel reads A in place unless its batch merges to more than two dims
    copied = A2.data_ptr() != A.data_ptr()
    assert copied == (len(si._coalesce(*si._batch_dims(A, out, plane))) > 2)


# ------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def rel(out, ref):
    return ((out.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def check(A, plane, symmetrize):
    """The kernel against the float32 library route and float64, inverse and
    log-determinant."""
    inv, ld = si.SPD_INVERSE.kernel(A, plane, symmetrize, logdet=True)
    inv32, ld32 = si.spd_inverse_plain(A, plane, symmetrize, logdet=True)
    inv64, ld64 = si.spd_inverse_plain(A.double(), plane, symmetrize, logdet=True)
    # each matrix contiguous, as the library route lays them out (plane: a
    # (..., n, n, N) view of (..., N, n, n)), so the callers' reshapes stay views
    assert inv.shape == A.shape and (inv.movedim(-1, -3) if plane else inv).is_contiguous()
    assert ld.shape == ld64.shape
    for got, lib, ref in ((inv, inv32, inv64), (ld, ld32, ld64)):
        assert torch.isfinite(got).all()
        assert rel(got, lib) <= TOL
        assert rel(got, ref) <= TOL
        assert rel(got, ref) <= max(4 * rel(lib, ref), 1e-6)
    assert torch.equal(inv, inv.transpose(-3, -2) if plane else inv.transpose(-1, -2))


@gpu
@pytest.mark.parametrize("n", range(1, 33))
@pytest.mark.parametrize("layout", ["dense", "plane"])
def test_kernel_matches_plain_and_float64(cuda, n, layout):
    rs = np.random.RandomState(n)
    if layout == "dense":
        check(spd(rs, (3, 5), n, torch.float32, cuda), False, True)
    else:
        check(to_plane(spd(rs, (4, 37), n, torch.float32, cuda)), True, False)


@gpu
@pytest.mark.parametrize("n", [2, 6, 8, 9, 16, 17, 26, 27, 32])
@pytest.mark.parametrize("case", ["dense transposed", "dense broadcast", "plane sliced",
                                  "plane lanes not minor", "plane broadcast", "plane permuted"])
def test_kernel_reads_strided_and_broadcast_inputs(cuda, n, case):
    rs = np.random.RandomState(n)
    D = spd(rs, (4, 6), n, torch.float32, cuda)
    P = to_plane(spd(rs, (6, 40), n, torch.float32, cuda))
    A, plane = {
        "dense transposed": (D.transpose(0, 1), False),
        "dense broadcast": (D[:, :1].expand(4, 6, n, n), False),
        "plane sliced": (P[1::2, ..., 3:35], True),
        "plane lanes not minor": (spd(rs, (5, 9), n, torch.float32, cuda).permute(0, 2, 3, 1), True),
        "plane broadcast": (P[:1].expand(3, n, n, 40), True),
        "plane permuted": (to_plane(spd(rs, (2, 3, 33), n, torch.float32, cuda)).transpose(0, 1),
                           True),
    }[case]
    assert not A.is_contiguous()
    check(A, plane, not plane)


@gpu
@pytest.mark.parametrize("n", [1, 6, 8, 9, 26, 32])
@pytest.mark.parametrize("count", [1, 7, 9, 127, 129, 1000])
@pytest.mark.parametrize("layout", ["dense", "plane"])
def test_kernel_at_batch_sizes_around_the_blocks(cuda, n, count, layout):
    """128 matrices a block at n <= 8, 8 above: a batch of one, of fewer
    than a block, and of a block and a part."""
    rs = np.random.RandomState(count)
    A = spd(rs, (count,), n, torch.float32, cuda)
    check(to_plane(A) if layout == "plane" else A, layout == "plane", layout == "dense")


@gpu
def test_kernel_at_the_lorenz_b1000_plane_batch(cuda):
    """lorenz.b1000's latent smoother: (399, 6, 6, 1000) plane matrices."""
    rs = np.random.RandomState(1000)
    X = torch.tensor(rs.randn(399, 6, 6, 1000), dtype=torch.float32, device=cuda)
    A = torch.einsum("tikn,tjkn->tijn", X, X) / 6 + 0.5 * torch.eye(6, device=cuda)[..., None]
    check(A, True, False)


@gpu
@pytest.mark.parametrize("n", [1, 3, 6, 8, 9, 26, 27, 32])
def test_symmetrize_and_jitter_against_the_lower_triangle(cuda, n, monkeypatch):
    """psd_inv* read (A + A^T) / 2 + PSD_JITTER I, bsym_inv_and_logdet A's
    lower triangle: an upper triangle that differs tells them apart."""
    rs = np.random.RandomState(n)
    A = spd(rs, (5, 11), n, torch.float32, cuda)
    skew = torch.tensor(np.triu(rs.randn(5, 11, n, n), 1), dtype=torch.float32, device=cuda)
    # the lower triangle is SPD A's, the upper is not; (A + A^T) / 2 stays
    # SPD (the symmetric perturbation's norm ~0.2, A's least eigenvalue >= 0.5)
    A = A + 0.2 / n ** 0.5 * skew
    jitter, default = 0.05, linalg.PSD_JITTER
    monkeypatch.setattr(linalg, "PSD_JITTER", jitter)
    check(A, False, True)
    sym = 0.5 * (A + A.transpose(-1, -2)) + jitter * torch.eye(n, device=cuda)
    inv, ld = si.SPD_INVERSE.kernel(A, symmetrize=True, logdet=True)
    inv64, ld64 = si.spd_inverse_plain(sym.double(), logdet=True)
    assert rel(inv, inv64) <= TOL and rel(ld, ld64) <= TOL
    monkeypatch.setattr(linalg, "PSD_JITTER", default)
    P = to_plane(A)
    check(P, True, False)
    lower = torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)
    inv, ld = planemat.bsym_inv_and_logdet(P)
    inv64, ld64 = si.spd_inverse_plain(to_plane(lower).double(), plane=True, logdet=True)
    assert rel(inv, inv64) <= TOL and rel(ld, ld64) <= TOL
    if n > 1:
        assert rel(linalg.psd_inv(A), inv64.movedim(-1, -3)) > 10 * TOL


@gpu
@pytest.mark.parametrize("n", [1, 2, 6, 8, 9, 26, 32])
@pytest.mark.parametrize("layout", ["dense", "plane"])
@pytest.mark.parametrize("bad", ["negative pivot", "nan"])
def test_a_failed_factorization_is_nan_in_its_own_slot(cuda, n, layout, bad):
    rs = np.random.RandomState(n)
    A = spd(rs, (140,), n, torch.float32, cuda)
    slot = 130
    if bad == "negative pivot":
        A[slot, n - 1, n - 1] = -1.0
    else:
        A[slot, 0, 0] = float("nan")
    plane = layout == "plane"
    inv, ld = si.SPD_INVERSE.kernel(to_plane(A) if plane else A, plane, not plane, logdet=True)
    if plane:
        inv = inv.movedim(-1, -3)
    assert torch.isnan(inv[slot]).all() and torch.isnan(ld[slot])
    keep = torch.arange(140, device=cuda) != slot
    inv64, ld64 = si.spd_inverse_plain(A[keep].double(), logdet=True)
    assert torch.isfinite(inv[keep]).all() and torch.isfinite(ld[keep]).all()
    assert rel(inv[keep], inv64) <= TOL and rel(ld[keep], ld64) <= TOL


# the shapes of a DMBD sweep's 14 calls in the four cells: the observation
# update's dense ones (roles, n, n), the latent M-step's, the smoother's plane
CELL_SHAPES = [
    ("psd_inv", (4, 7, 7)), ("psd_inv_and_logdet", (4, 2, 2)), ("psd_inv_and_logdet", (1, 6, 6)),
    ("psd_inv", (1, 7, 7)), ("psd_inv", (26, 27, 27)), ("psd_inv_and_logdet", (26, 4, 4)),
    ("psd_inv_and_logdet", (26, 27, 27)), ("psd_inv_and_logdet", (1, 26, 26)),
    ("bsym", (399, 6, 6, 100)), ("bsym", (1, 6, 6, 100)), ("bsym", (399, 6, 6, 1000)),
    ("bsym", (150, 26, 26, 20)), ("bsym", (1, 26, 26, 20)), ("bsym", (1200, 26, 26, 4)),
]


@gpu
def test_the_entry_points_make_no_host_sync_at_the_cells_shapes(cuda):
    rs = np.random.RandomState(0)
    inputs = []
    for entry, shape in CELL_SHAPES:
        if entry == "bsym":
            A = to_plane(spd(rs, shape[:1] + shape[-1:], shape[1], torch.float32, cuda))
        else:
            A = spd(rs, shape[:1], shape[1], torch.float32, cuda)
        inputs.append((entry, A))
    fns = {"psd_inv": linalg.psd_inv, "psd_inv_and_logdet": linalg.psd_inv_and_logdet,
           "bsym": planemat.bsym_inv_and_logdet}
    fns["psd_inv"](inputs[0][1])  # the library is built and loaded outside the check
    torch.cuda.synchronize()
    before = si.SPD_INVERSE.launches, si.SPD_INVERSE.library_calls
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [fns[entry](A) for entry, A in inputs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert si.SPD_INVERSE.launches == before[0] + len(inputs)
    assert si.SPD_INVERSE.library_calls == before[1]
    for out in outs:
        for x in out if isinstance(out, tuple) else (out,):
            assert torch.isfinite(x).all()


@gpu
@pytest.mark.parametrize("case", ["float32 n=32", "float32 n=1", "float32 n=33", "float64 n=6"])
def test_the_counters(cuda, case):
    dtype, n = case.split(" n=")
    n = int(n)
    A = spd(np.random.RandomState(n), (3,), n, getattr(torch, dtype), cuda)
    c = si.SPD_INVERSE
    before = c.launches, c.library_calls, c.plain_calls
    linalg.psd_inv(A)
    planemat.bsym_inv_and_logdet(to_plane(A))
    kernel = dtype == "float32" and n <= si.MAX_N
    assert (c.launches, c.library_calls, c.plain_calls) == (
        before[0] + 2 * kernel, before[1] + 2 * (not kernel), before[2])
