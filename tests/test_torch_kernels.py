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
    if K > 1:  # masked transitions (at K = 1 the one entry stays finite)
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


# every rung of the logsemiring kernel (K <= 4, 8, 16, 32) at its edges and
# inside, and the generic K > 32 (past any shared-memory size at K = 121);
# the plane Kalman kernel from H = 1 to 32, at its rungs and padded up to
# them, across its one-solve-per-thread (H <= 14) and looped (H >= 15)
# designs
CASES = ([("logsemiring", k)
          for k in (1, 2, 3, 4, 6, 7, 8, 10, 14, 16, 17, 32, 33, 40, 121)]
         + [("kalman", h) for h in (1, 4, 5, 6, 8, 10, 12, 14, 15, 16, 17, 24, 32)]
         + [("lane", 1), ("lane", 2), ("lane", 3)])
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


# the scans of the HMM-core (and dHMM), Cradle, Flame, ARHMM, NLDS, life,
# artificial-life and LDS-core (a pad_X observation model) paths at the
# shapes those paths give them (size, T, lanes): ragged lane blocks at every
# one, and the lane kernel's per-lane copy path (N = 8, below a warp; N =
# 100, not a multiple of 32)
MAIN_PATH = [("logsemiring", 8, 200, 200), ("logsemiring", 6, 200, 50),
             ("logsemiring", 3, 100, 12), ("kalman", 6, 200, 10), ("kalman", 4, 100, 1),
             ("logsemiring", 4, 200, 200), ("lane", 2, 200, 8),
             ("logsemiring", 12, 128, 384), ("logsemiring", 10, 199, 16),
             ("lane", 2, 200, 100)]


@pytest.mark.parametrize("which,size,T,N", MAIN_PATH)
@pytest.mark.parametrize("reverse", [False, True])
def test_kernel_matches_plain_at_main_path_shapes(cuda, which, size, T, N, reverse):
    s, make = MAKERS[which]
    leaves = make(np.random.RandomState(size + T + N), T, size, N, cuda)
    out = s.kernel(leaves, reverse)
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


# the logsemiring kernel at K=14 (four lanes a block): lane counts that are
# not a multiple of the block's lanes, one and two rows, and folds with a
# short chunk, each against the one-pass plain scan
LOG14 = [(T, C, N) for N in (1, 3, 5, 17, 240)
         for T, C in ((1, 1), (2, 1), (2, 2), (150, 1), (150, 8), (150, 7))]


@pytest.mark.parametrize("T,C,N", LOG14)
@pytest.mark.parametrize("reverse", [False, True])
def test_logsemiring_k14_edges(cuda, T, C, N, reverse):
    s = scan.LOGSEMIRING
    leaves = semiring(np.random.RandomState(T * 100 + N), T, 14, N, cuda)
    L = -(-T // C)
    assert C * L - T < L  # every chunk non-empty
    out = s.launch(leaves, reverse, chunks=C, L=L, offset=T - C * L if reverse else 0)
    torch.cuda.synchronize()
    ref = s.plain(leaves, reverse)
    assert rel_err(out[0], ref[0]) <= TOL


# the lane kernels (H = 1, 2, 3), one pass and folded into Cp = 2, 4, 8
# chunks (a short chunk wherever Cp does not divide T), forward and reverse:
# lane counts of one lane, a warp's 32 and either side of it, 36, and the
# MixLDS 4000 (16-byte chunks shared over the warp at 32 and 4000, where
# every block is full; per-lane copies otherwise); walks of one and two
# rows, one row either side of the ring depth, and 100 rows; each against
# the one-pass plain scan
LANE_RING = {1: 32, 2: 16, 3: 8}  # csrc/kalman_lane_scan.cu:kRing


def _folds(T):
    """The chunk counts a T-row lane walk is cut into: 1, and each Cp in 2,
    4, 8 whose chunks of L = ceil(T / Cp) rows are all non-empty."""
    return [C for C in (1, 2, 4, 8) if C == 1 or (C <= T and C * -(-T // C) - T < -(-T // C))]


LANE_EDGES = [(H, T, C, N) for H in (1, 2, 3) for N in (1, 31, 32, 33, 36, 4000)
              for T in sorted({1, 2, LANE_RING[H] - 1, LANE_RING[H] + 1, 100})
              for C in _folds(T)]


@pytest.mark.parametrize("H,T,C,N", LANE_EDGES)
@pytest.mark.parametrize("reverse", [False, True])
def test_lane_kalman_edges(cuda, H, T, C, N, reverse):
    s = scan.KALMAN_LANE
    leaves = lane(np.random.RandomState(H * 1000 + T * 10 + C), T, H, N, cuda)
    L = -(-T // C)
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
        (3, 2), (1, 2, 1), (2, 2, 2), parallel_scan=True,
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
    y = Flocking(n_birds=5, Tmax=40, batch_size=3).simulate(g, torch.float32, device=cuda)
    m = DynamicMarkovBlanketDiscovery(
        (5, 4), (2, 2, 2), (2, 2, 2), number_of_objects=3, parallel_scan=True,
        generator=g, dtype=torch.float32, device=cuda,
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


# the Newton's-cradle widths (K = 6, h = 6) and the Flame widths (K = 3,
# h = 4), sizes no earlier slice's kernels took
DMBD_WIDTHS = {
    "cradle": dict(obs_shape=(5, 2), role_dims=(2, 2, 2), hidden_dims=(2, 2, 2)),
    "flame": dict(obs_shape=(12, 1), role_dims=(1, 1, 1), hidden_dims=(2, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(DMBD_WIDTHS))
def test_dmbd_fit_on_the_card_follows_the_cpu(cuda, name):
    """3 sweeps from one state: the card in float32 (two launches a sweep of
    each scan kernel, no plain scan) within relative 1e-4 of the CPU in
    float64 (the plain scans)."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    cfg = DMBD_WIDTHS[name]
    rs = np.random.RandomState(5)
    y = np.cumsum(rs.randn(60, 4, *cfg["obs_shape"]) * 0.3, 0)
    y = torch.tensor((y - y.mean()) / y.std())
    state = dmbd_state(DynamicMarkovBlanketDiscovery(
        **cfg, parallel_scan=True, generator=torch.Generator().manual_seed(0),
        dtype=torch.float64, device="cpu"))
    gpu = dmbd_from_state(state, device=cuda, dtype=torch.float32)
    cpu = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    before = [s.launches for s in scan.SCANS]
    plain = [s.plain_calls for s in scan.SCANS]
    gpu.update(y.to(cuda, torch.float32), iters=3)
    assert [s.launches - b for s, b in zip(scan.SCANS, before)] == [6, 6, 0]
    assert [s.plain_calls for s in scan.SCANS] == plain
    cpu.update(y, iters=3)
    e_gpu, e_cpu = np.asarray(gpu.ELBO_save), np.asarray(cpu.ELBO_save)
    assert (np.abs(e_gpu - e_cpu) / np.abs(e_cpu)).max() <= TOL


def test_dense_kalman_dmbd_on_the_card_follows_the_cpu(cuda):
    """H = 33 (hidden_dims (11, 11, 11)): the Kalman leg takes the dense
    form on both devices (two logsemiring launches a sweep, no Kalman
    kernel, no plain scan); 3 sweeps card f32 within relative 1e-4 of the
    CPU in float64."""
    from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
    from pyvbmp_tpu_torch.utils.convert import dmbd_from_state, dmbd_state

    rs = np.random.RandomState(8)
    y = np.cumsum(rs.randn(40, 3, 3, 2) * 0.3, 0)
    y = torch.tensor((y - y.mean()) / y.std())
    state = dmbd_state(DynamicMarkovBlanketDiscovery(
        (3, 2), (1, 1, 1), (11, 11, 11), parallel_scan=True,
        generator=torch.Generator().manual_seed(0), dtype=torch.float64, device="cpu"))
    gpu = dmbd_from_state(state, device=cuda, dtype=torch.float32)
    cpu = dmbd_from_state(state, device="cpu", dtype=torch.float64)
    counters = [*scan.SCANS, *scan.FOLDED_SCANS]
    before = [(c.launches, c.plain_calls) for c in counters]
    gpu.update(y.to(cuda, torch.float32), iters=3)
    launched = [c.launches - b[0] for c, b in zip(counters, before)]
    assert launched == [6, 0, 0, 0, 0, 0]
    assert [c.plain_calls for c in counters] == [b[1] for b in before]
    cpu.update(y, iters=3)
    e_gpu, e_cpu = np.asarray(gpu.ELBO_save), np.asarray(cpu.ELBO_save)
    assert (np.abs(e_gpu - e_cpu) / np.abs(e_cpu)).max() <= TOL


def test_gmm_on_the_card_follows_the_cpu(cuda):
    """GaussianMixtureModel(8, 3) on 5000 points: no kernel, and 3 iterations
    card f32 within relative 1e-4 of the CPU in float64."""
    from pyvbmp_tpu_torch.models import GaussianMixtureModel
    from pyvbmp_tpu_torch.utils.convert import gmm_from_state, gmm_state

    rs = np.random.RandomState(9)
    X = torch.tensor((rs.randn(8, 3) * 4)[rs.randint(0, 8, 5000)] + rs.randn(5000, 3))
    m = GaussianMixtureModel(8, 3, generator=torch.Generator().manual_seed(0),
                             dtype=torch.float64, device="cpu")
    m.initialize(X, generator=torch.Generator().manual_seed(1))
    state = gmm_state(m)
    counters = [*scan.SCANS, *scan.FOLDED_SCANS, ws.WEIGHTED_OUTER]
    before = [c.launches for c in counters]
    gpu = gmm_from_state(state, device=cuda, dtype=torch.float32)
    gpu.update(X.to(cuda, torch.float32), iters=3)
    assert [c.launches for c in counters] == before
    cpu = gmm_from_state(state, device="cpu", dtype=torch.float64)
    cpu.update(X, iters=3)
    e_gpu, e_cpu = np.asarray(gpu.ELBO_save), np.asarray(cpu.ELBO_save)
    assert (np.abs(e_gpu - e_cpu) / np.abs(e_cpu)).max() <= TOL


@pytest.mark.parametrize("name", ["Lorenz", "Flocking", "NewtonsCradle", "Flame",
                                  "cartthingy", "Forager"])
def test_simulators_on_the_card_follow_the_cpu(cuda, name):
    """The same seed gives the same data on the card as on the CPU (the
    draws are made on the CPU; float64 integration on each device)."""
    from pyvbmp_tpu_torch import simulations as S

    def run(device):
        g = torch.Generator().manual_seed(0)
        if name == "Lorenz":
            sim = S.Lorenz()
            sim.num_steps = 200
            return sim.simulate(3, generator=g, device=device)
        if name == "Flocking":
            return S.Flocking(n_birds=5, Tmax=30, batch_size=2).simulate(g, device=device)
        if name == "NewtonsCradle":
            sim = S.NewtonsCradle(5, 0.2, 100, 3, 1, 0.01, 0.05, include_string=2)
            return sim.generate_data("1 + 1", g, device=device)[0]
        if name == "Flame":
            return S.FlameSimulator(100, 0.02, 0.5, 0.45, 12, generator=g,
                                    device=device).simulate()[0]
        if name == "cartthingy":
            return S.cartthingy.simulate(3, g, device=device)
        return S.Forager().simulate_batches(2, seed=0, device=device)[0]

    out, ref = run(cuda), run("cpu")
    assert out.device.type == "cuda" and out.dtype == ref.dtype
    assert ((out.cpu() - ref).abs().max() / ref.abs().max()).item() <= 1e-9


def test_sequential_dmbd_and_hmm_launch_no_kernel(cuda):
    """parallel_scan=False (the JAX default) runs the sequential smoothers:
    no scan kernel and no plain scan on the card."""
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import HMM, DynamicMarkovBlanketDiscovery

    g = torch.Generator().manual_seed(0)
    rs = np.random.RandomState(6)
    counters = [*scan.SCANS, *scan.FOLDED_SCANS]
    before = [(c.launches, c.plain_calls) for c in counters]
    m = DynamicMarkovBlanketDiscovery((3, 2), (1, 2, 1), (2, 2, 2), generator=g,
                                      dtype=torch.float32, device=cuda)
    m.update(torch.tensor(rs.randn(30, 4, 3, 2), dtype=torch.float32, device=cuda), iters=2)
    h = HMM(NormalInverseWishart.create((4,), (8,), generator=g), generator=g,
            dtype=torch.float32, device=cuda)
    h.update(torch.tensor(rs.randn(30, 5, 4), dtype=torch.float32, device=cuda), iters=2)
    assert [(c.launches, c.plain_calls) for c in counters] == before
    assert np.isfinite(m.ELBO_save).all() and np.isfinite(h.ELBO_save).all()


def test_hmm_with_the_scan_smoother_launches_the_kernel(cuda):
    """The core_hmm widths (K = 8, d = 4): two logsemiring launches a sweep."""
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import HMM

    g = torch.Generator().manual_seed(0)
    y = torch.tensor(np.random.RandomState(7).randn(40, 6, 4), dtype=torch.float32,
                     device=cuda)
    h = HMM(NormalInverseWishart.create((4,), (8,), generator=g), parallel_scan=True,
            generator=g, dtype=torch.float32, device=cuda)
    launches, plain = scan.LOGSEMIRING.launches, scan.LOGSEMIRING.plain_calls
    h.update(y, iters=3)
    assert scan.LOGSEMIRING.launches == launches + 6
    assert scan.LOGSEMIRING.plain_calls == plain
    assert np.isfinite(h.ELBO_save).all()
    assert h.p.shape == (40, 6, 8)


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


def ar_pairs(rs, T, B):
    """Two AR regimes switching every 10 steps: X and Y (T, B, 1, 2, 1)."""
    rot = np.asarray([[0.0, -0.9], [0.9, 0.0]])
    x = rs.randn(B, 2)
    X, Y = [], []
    for t in range(T):
        y = x @ (0.9 * np.eye(2) if (t // 10) % 2 == 0 else rot).T + 0.05 * rs.randn(B, 2)
        X.append(x)
        Y.append(y)
        x = y
    return tuple(torch.tensor(np.stack(a)[..., None, :, None]) for a in (X, Y))


def chain_models():
    """name -> (state, convert.*_from_state, update arguments on the CPU in
    float64, want launches a sweep of the scans (one pass))."""
    from pyvbmp_tpu_torch.dists import NormalInverseWishart
    from pyvbmp_tpu_torch.models import ARHMM, NLDS, dHMM
    from pyvbmp_tpu_torch.utils import convert

    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, dtype=torch.float64, device="cpu")
    rs = np.random.RandomState(9)
    arhmm = ARHMM(4, 2, 2, **kw)
    arhmm.parallel_scan = True
    dhmm = dHMM(NormalInverseWishart.create((2,), (3,), generator=g), 2,
                parallel_scan=True, **kw)
    nlds = NLDS((3,), 2, 2, **kw)
    nlds.p = torch.tensor(rs.dirichlet(np.ones(2), (60, 4)))
    y = np.cumsum(rs.randn(60, 4, 3) * 0.3, 0)
    return {
        "ARHMM": (convert.arhmm_state(arhmm), convert.arhmm_from_state,
                  (ar_pairs(rs, 60, 4),), [2, 0, 0]),
        "dHMM": (convert.dhmm_state(dhmm), convert.dhmm_from_state,
                 (torch.tensor(rs.randn(60, 4, 2)), torch.tensor(rs.randn(60, 4, 2))),
                 [2, 0, 0]),
        "NLDS": (convert.nlds_state(nlds), convert.nlds_from_state,
                 (torch.tensor(y),), [0, 0, 2]),
    }


def to_each(fn, tree):
    """``fn`` on every tensor of nested tuples."""
    if isinstance(tree, tuple):
        return tuple(to_each(fn, t) for t in tree)
    return fn(tree)


@pytest.mark.parametrize("name", ["ARHMM", "dHMM", "NLDS"])
def test_chain_model_fit_on_the_card_follows_the_cpu(cuda, name):
    """3 sweeps from one state: the card in float32 (the scan kernels a sweep
    as the model's path gives them, no plain scan) within relative 1e-4 of
    the CPU in float64 (the plain scans)."""
    state, from_state, args, want = chain_models()[name]
    gpu = from_state(state, device=cuda, dtype=torch.float32)
    cpu = from_state(state, device="cpu", dtype=torch.float64)
    on_card = to_each(lambda a: a.to(cuda, torch.float32), args)
    before = [s.launches for s in scan.SCANS]
    plain = [s.plain_calls for s in scan.SCANS]
    gpu.update(*on_card, iters=3)
    assert [s.launches - b for s, b in zip(scan.SCANS, before)] == [3 * w for w in want]
    assert [s.plain_calls for s in scan.SCANS] == plain
    cpu.update(*args, iters=3)
    e_gpu, e_cpu = np.asarray(gpu.ELBO_save), np.asarray(cpu.ELBO_save)
    assert (np.abs(e_gpu - e_cpu) / np.abs(e_cpu)).max() <= TOL


def test_node_suite_on_the_card_follows_the_cpu(cuda):
    """chip_smoke.py's phase-30 node suite at batch 8: every node ported with
    the tensor HMMs, one update, its KL and expectations, card float32
    within relative 1e-4 of CPU float64."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    worst = chip_smoke.node_suite(batch=8)
    assert len(worst) == 15 and max(worst.values()) <= TOL, worst
