"""The port's CUDA scan kernels against their plain PyTorch versions, on the
card.  A CUDA kernel has no interpret mode, so these tests need a GPU (and
nvcc): they are marked ``gpu`` and skip on a machine without one.  Run them
on the card with ``python -m pytest tests/test_torch_kernels.py``.

float32 on both sides; tolerance max |kernel - plain| / max |plain| <= 1e-4
per output (the kernel's plane Kalman combine uses Cholesky factors where
the plain one uses an explicit inverse; the lane combine uses the same
adjugate as its plain version)."""
import numpy as np
import pytest
import torch

from pyvbmp_tpu_torch.ops import scan

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


CASES = [("logsemiring", 4), ("logsemiring", 7), ("kalman", 6), ("kalman", 10),
         ("lane", 1), ("lane", 2), ("lane", 3)]
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
