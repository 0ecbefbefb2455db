"""The port's CUDA kernels (the scans, one pass and time-folded, and the
weighted scatter) against their plain PyTorch versions, on the card.  A CUDA
kernel has no interpret mode, so these tests need a GPU (and nvcc): they are
marked ``gpu`` and skip on a machine without one.  Run them on the card with
``python -m pytest --noconftest tests/test_torch_kernels.py``.

float32 on both sides; tolerance max |kernel - plain| / max |plain| <= 1e-4
per output (the kernel's plane Kalman combine uses Cholesky factors where
the plain one uses an explicit inverse; the lane combine uses the same
adjugate as its plain version).  The weighted scatter is held to its plain
version computed in float64 on the card, at the same bound."""
import numpy as np
import pytest
import torch

from pyvbmp_tpu_torch.ops import scan
from pyvbmp_tpu_torch.ops import weighted_scatter as ws

pytestmark = pytest.mark.gpu
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scan kernels have no CPU mode")
    return torch.device("cuda")


def semiring(rs, T, K, N, device):
    trans = np.log(rs.dirichlet(np.ones(K), K))
    trans[0, K - 1] = trans[K - 1, 0] = -np.inf
    M = trans[None, None] + rs.randn(T, N, 1, K) * 2.0
    return (torch.tensor(M.transpose(0, 2, 3, 1).copy(), dtype=torch.float32,
                         device=device),)


def kalman(rs, T, H, N, device):
    W = rs.randn(T, N, 2 * H, 2 * H)
    J = np.einsum("tnij,tnkj->tnik", W, W) / (2 * H) + np.eye(2 * H)
    leaves = (J[..., :H, :H], J[..., :H, H:], J[..., H:, H:],
              rs.randn(T, N, H), rs.randn(T, N, H))
    out = tuple(np.moveaxis(x, 1, -1).copy() for x in leaves) + (rs.randn(T, N),)
    return tuple(torch.tensor(x, dtype=torch.float32, device=device) for x in out)


def lane(rs, T, H, N, device):
    """The potentials of ``kalman``, packed by components (ops/smallmat.py)."""
    from pyvbmp_tpu_torch.ops import smallmat as sm

    Jaa, Jab, Jbb, ha, hb, w = kalman(rs, T, H, N, "cpu")
    dense = lambda x: x.permute(0, 3, 1, 2)  # (T, H, H, N) -> (T, N, H, H)
    out = (sm.sym_pack(dense(Jaa)), sm.gen_pack(dense(Jab)), sm.sym_pack(dense(Jbb)),
           ha, hb, w)
    return tuple(x.contiguous().to(device) for x in out)


def rel_err(out, ref):
    assert not torch.isnan(out).any()
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    return ((out[fin] - ref[fin]).abs().max() / ref[fin].abs().max()).item()


CASES = [("logsemiring", 4), ("logsemiring", 7), ("logsemiring", 14), ("kalman", 6),
         ("kalman", 10), ("kalman", 14), ("lane", 1), ("lane", 2), ("lane", 3)]
MAKERS = {"logsemiring": (scan.LOGSEMIRING, semiring),
          "kalman": (scan.KALMAN_PLANE, kalman), "lane": (scan.KALMAN_LANE, lane)}


@pytest.mark.parametrize("which,size", CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain(cuda, which, size, reverse):
    rs = np.random.RandomState(size)
    s, make = MAKERS[which]
    leaves = make(rs, 37, size, 45, cuda)
    launches = s.launches
    out = s.kernel(leaves, reverse)
    torch.cuda.synchronize()
    assert s.launches == launches + 1
    ref = s.plain(leaves, reverse)
    for o, r in zip(out, ref):
        assert rel_err(o, r) <= TOL


# the Flocking scans (T=150: Cp=8, L=19, two rows short) and a ragged T=37
# (Cp=2, L=19, one row short) at every instantiated size
FOLD_CASES = ([("logsemiring", 14, 150, 240), ("kalman", 14, 150, 20)]
              + [(w, k, 37, 45) for w, k in CASES])


@pytest.mark.parametrize("which,size,T,N", FOLD_CASES)
@pytest.mark.parametrize("reverse", [False, True])
def test_folded_kernel_matches_folded_plain(cuda, which, size, T, N, reverse):
    rs = np.random.RandomState(size + T)
    s, make = MAKERS[which]
    leaves = make(rs, T, size, N, cuda)
    launches, one_pass = s.folded.launches, s.launches
    out = s.folded.kernel(leaves, reverse)
    torch.cuda.synchronize()
    assert s.folded.launches == launches + 1 and s.launches == one_pass
    ref = s.folded.plain(leaves, reverse)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert rel_err(o, r) <= TOL


# the warp-per-lane plane Kalman kernels at H=14: lane counts that are not a
# multiple of the block's lanes, one and two rows, and folds with a short
# chunk, each against the one-pass plain scan
PLANE14 = [(T, C, N) for N in (1, 5, 20, 33)
           for T, C in ((1, 1), (2, 1), (2, 2), (150, 1), (150, 8), (150, 7))]


@pytest.mark.parametrize("T,C,N", PLANE14)
@pytest.mark.parametrize("reverse", [False, True])
def test_plane_kalman_h14_edges(cuda, T, C, N, reverse):
    s = scan.KALMAN_PLANE
    leaves = kalman(np.random.RandomState(T * 100 + N), T, 14, N, cuda)
    L = -(-T // C)
    assert C * L - T < L  # every chunk non-empty
    out = s.launch(leaves, reverse, chunks=C, L=L, offset=T - C * L if reverse else 0)
    torch.cuda.synchronize()
    ref = s.plain(leaves, reverse)
    for o, r in zip(out, ref):
        assert rel_err(o, r) <= TOL


def test_cuda_tensors_launch_the_kernel(cuda):
    M = semiring(np.random.RandomState(0), 9, 4, 5, cuda)[0]
    launches, plain = scan.LOGSEMIRING.launches, scan.LOGSEMIRING.plain_calls
    scan.logsemiring_scan(M)
    assert scan.LOGSEMIRING.launches == launches + 1
    assert scan.LOGSEMIRING.plain_calls == plain


def test_kernel_refuses_what_it_does_not_take(cuda):
    M = semiring(np.random.RandomState(1), 9, 4, 5, cuda)[0]
    with pytest.raises(TypeError):
        scan.logsemiring_scan(M.double())
    with pytest.raises(ValueError):
        scan.logsemiring_scan(M.transpose(1, 2))


def test_dmbd_sweep_runs_four_kernel_launches(cuda):
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery

    rs = np.random.RandomState(2)
    y = torch.tensor(rs.randn(30, 6, 3, 2), dtype=torch.float32, device=cuda)
    m = DynamicMarkovBlanketDiscovery(
        (3, 2), (1, 2, 1), (2, 2, 2),
        generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device=cuda,
    )
    before = [s.launches for s in scan.SCANS]
    plain = [s.plain_calls for s in scan.SCANS]
    m.update(y, iters=2)
    assert [s.launches - b for s, b in zip(scan.SCANS, before)] == [4, 4, 0]
    assert [s.plain_calls for s in scan.SCANS] == plain
    assert np.isfinite(m.ELBO_save).all()


@pytest.mark.parametrize("fold", ["0", "auto"])
def test_dmbd_flocking_sweep_launches_per_route(cuda, fold, monkeypatch):
    """Three objects (K = H = 14): four one-pass launches a sweep with the
    fold off, four folded launches with it on, never a plain scan."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.simulations import Flocking

    monkeypatch.setattr(scan, "TIME_FOLD", fold)
    monkeypatch.setattr(scan, "TIME_FOLD_MIN_T", 8)
    g = torch.Generator().manual_seed(0)
    y = Flocking(n_birds=5, Tmax=40, batch_size=3).simulate(g, torch.float32).to(cuda)
    m = DynamicMarkovBlanketDiscovery(
        (5, 4), (2, 2, 2), (2, 2, 2), number_of_objects=3, generator=g,
        dtype=torch.float32, device=cuda,
    )
    counters = [*scan.SCANS, *scan.FOLDED_SCANS]
    before = [c.launches for c in counters]
    plain = [c.plain_calls for c in counters]
    m.update(y, iters=2)
    want = [4, 4, 0, 0, 0, 0] if fold == "0" else [0, 0, 0, 4, 4, 0]
    assert [c.launches - b for c, b in zip(counters, before)] == want
    assert [c.plain_calls for c in counters] == plain
    assert np.isfinite(m.ELBO_save).all()
    assert m.particular_assignment().shape == (40, 3, 5)


def test_mixlds_sweep_runs_two_lane_kernel_launches(cuda):
    from pyvbmp_tpu_torch.models import MixtureofLinearDynamicalSystems

    rs = np.random.RandomState(3)
    y = torch.tensor(np.cumsum(rs.randn(30, 16, 3) * 0.3, 0), dtype=torch.float32,
                     device=cuda)
    m = MixtureofLinearDynamicalSystems(
        4, (3,), 2, 0, 0, parallel_scan=True,
        generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device=cuda,
    )
    before = [s.launches for s in scan.SCANS]
    plain = [s.plain_calls for s in scan.SCANS]
    m.update(y)
    assert [s.launches - b for s, b in zip(scan.SCANS, before)] == [0, 0, 2]
    assert [s.plain_calls for s in scan.SCANS] == plain
    assert np.isfinite(m.ELBO_save).all()
    assert m.p.shape == (16, 4) and torch.isfinite(m.p).all()


def test_mixlds_sweep_folds_the_lane_scans_only_when_forced(cuda, monkeypatch):
    """TIME_FOLD="1" sends the lane scans to the folded kernel; "auto" does
    not (the JAX package never folds a lane scan automatically)."""
    from pyvbmp_tpu_torch.models import MixtureofLinearDynamicalSystems

    monkeypatch.setattr(scan, "TIME_FOLD_MIN_T", 8)
    rs = np.random.RandomState(3)
    y = torch.tensor(np.cumsum(rs.randn(40, 16, 3) * 0.3, 0), dtype=torch.float32,
                     device=cuda)
    counters = [*scan.SCANS, *scan.FOLDED_SCANS]
    for fold, want in (("auto", [0, 0, 2, 0, 0, 0]), ("1", [0, 0, 0, 0, 0, 2])):
        monkeypatch.setattr(scan, "TIME_FOLD", fold)
        m = MixtureofLinearDynamicalSystems(
            4, (3,), 2, 0, 0, parallel_scan=True,
            generator=torch.Generator().manual_seed(0), dtype=torch.float32,
            device=cuda,
        )
        before = [c.launches for c in counters]
        plain = [c.plain_calls for c in counters]
        m.update(y)
        assert [c.launches - b for c, b in zip(counters, before)] == want
        assert [c.plain_calls for c in counters] == plain
        assert np.isfinite(m.ELBO_save).all()


# ---------------------------------------------------------- weighted scatter
def scatter_inputs(S, p, K, device):
    rs = np.random.RandomState(S * 7 + p + K)
    X = torch.tensor(rs.randn(S, p), dtype=torch.float32, device=device)
    W = torch.tensor(rs.rand(S, K), dtype=torch.float32, device=device)
    return X, W


@pytest.mark.parametrize("p", [1, 31, 32, 33, 65, 257])
@pytest.mark.parametrize("K", [1, 9, 16, 17])
@pytest.mark.parametrize("S", [1, 37, 1347])  # none a multiple of a stage
def test_weighted_outer_matches_plain(cuda, S, p, K):
    X, W = scatter_inputs(S, p, K, cuda)
    launches = ws.WEIGHTED_OUTER.launches
    out = ws.WEIGHTED_OUTER.kernel(X, W)
    torch.cuda.synchronize()
    assert ws.WEIGHTED_OUTER.launches == launches + 1
    ref = ws.weighted_outer_einsum(X.double(), W.double())
    err = ((out.double() - ref).abs().max() / ref.abs().max()).item()
    assert err <= TOL
    assert torch.equal(out, out.transpose(1, 2))


@pytest.mark.parametrize("S,p,K", [(100003, 33, 17), (100003, 32, 16), (60000, 65, 9)])
def test_weighted_outer_repeats_bit_for_bit(cuda, S, p, K):
    """Many S-chunks (the last one short), every class group, both copy
    widths (p = 32 takes the 16-byte copies): within TOL of the float64
    plain version, exactly symmetric, and the same bits on every run."""
    X, W = scatter_inputs(S, p, K, cuda)
    first = ws.weighted_outer(X, W)
    ref = ws.weighted_outer_einsum(X.double(), W.double())
    assert ((first.double() - ref).abs().max() / ref.abs().max()).item() <= TOL
    assert torch.equal(first, first.transpose(1, 2))
    assert all(torch.equal(first, ws.weighted_outer(X, W)) for _ in range(3))


def test_weighted_outer_unaligned_rows(cuda):
    """X starting 4 bytes past a 16-byte boundary takes the 4-byte copies."""
    X, W = scatter_inputs(2000, 33, 5, cuda)
    Xu = X.reshape(-1)[1:1 + 2000 * 32].reshape(2000, 32)
    assert Xu.is_contiguous() and Xu.data_ptr() % 16 != 0
    out = ws.weighted_outer(Xu, W)
    ref = ws.weighted_outer_einsum(Xu.double(), W.double())
    assert ((out.double() - ref).abs().max() / ref.abs().max()).item() <= TOL


def test_weighted_outer_refuses_what_it_does_not_take(cuda):
    X, W = scatter_inputs(40, 5, 3, cuda)
    with pytest.raises(TypeError):
        ws.weighted_outer(X.double(), W.double())
    with pytest.raises(ValueError):
        ws.weighted_outer(X.t(), W[:5])
    with pytest.raises(ValueError):
        ws.weighted_outer(X, W[:39])


def test_mnlr_fit_runs_the_scatter_kernel(cuda):
    from pyvbmp_tpu_torch.transforms import MultiNomialLogisticRegression

    rs = np.random.RandomState(4)
    y = rs.randint(0, 4, 500)
    X = torch.tensor(rs.randn(4, 6)[y] * 2 + rs.randn(500, 6), dtype=torch.float32,
                     device=cuda)
    Y = torch.tensor(np.eye(4)[y], dtype=torch.float32, device=cuda)
    m = MultiNomialLogisticRegression(
        4, 6, generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device=cuda,
    )
    launches, plain = ws.WEIGHTED_OUTER.launches, ws.WEIGHTED_OUTER.plain_calls
    for _ in range(3):
        m.raw_update(X, Y, iters=2)
    assert ws.WEIGHTED_OUTER.launches == launches + 6
    assert ws.WEIGHTED_OUTER.plain_calls == plain
    acc = (m.predict(X).argmax(-1).cpu().numpy() == y).mean()
    assert acc > 0.9
