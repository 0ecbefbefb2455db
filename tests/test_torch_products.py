"""``utils/linalg.py:product``: each route against ``torch.matmul`` on the
layouts DMBD's sweep hands it, the size rule that sends a product back to
``torch.matmul``, the route counter, and a DMBD sweep in which no product
over the data's axes reaches a batched GEMM of one problem an entry."""
import math

import pytest
import torch

from pyvbmp_tpu_torch.models import DynamicMarkovBlanketDiscovery
from pyvbmp_tpu_torch.utils import linalg

T, B, O, K = 6, 3, 4, 4  # 72 entries of (time, batch, object), above MATMUL_MAX_BATCH


def _data(*shape, dtype):
    return torch.randn(shape, dtype=dtype, generator=torch.Generator().manual_seed(sum(shape)))


# (name, route, A's shape, B's shape, how A and B are laid out)
CASES = [
    # outer products: y y^T, x x^T, y x^T; a parameter column times the regressor
    ("outer y x^T", "broadcast", (T, B, O, 1, 2, 1), (T, B, O, 1, 1, 7), None),
    ("outer parameter column", "broadcast", (K, 6, 1), (T, B, O, 1, 1, 1), None),
    # both vary per entry: the role-wise row times x, the role average of messages
    ("matvec per entry", "broadcast", (T, B, O, K, 1, 7), (T, B, O, 1, 7, 1), None),
    ("row per entry", "broadcast", (T, B, O, 1, K), (T, B, O, K, 6), None),
    ("full per entry", "broadcast", (T * B * O, 3, 4), (T * B * O, 4, 2), None),
    # a (K, a, b) parameter against (T, B, O, K, b, 1) data: one GEMM a role
    ("parameter by role", "folded_gemm", (K, 2, 2), (T, B, O, K, 2, 1), None),
    ("parameter by role, data permuted", "folded_gemm", (K, 6, 2), (T, B, O, K, 2, 1), "permuted"),
    # the data's rows against a parameter stack: one GEMM
    ("rows by parameter", "folded_gemm", (T, B, O, 1, 1, 2), (K, 2, 7), None),
    # (T*B*O, K) weights against a (K, a*b) parameter: the role average
    ("weights by parameter", "folded_gemm", (T * B * O, 1, K), (K, 36), None),
    # a layout the GEMM cannot write in place; an operand expanded over O
    ("rows and columns interleaved", "folded_gemm", (T * B * O, 1, 3, 4), (1, 5, 4, 2), None),
    ("parameter by expanded data", "folded_gemm", (K, 2, 7), (T, B, O, 1, 7, 1), "expanded"),
    # no data axes: a parameter batch; and the size rule
    ("parameter batch", "matmul", (K, 2, 7), (K, 7, 7), None),
    ("broadcast too large", "matmul", (T * B * O, 16, 16), (T * B * O, 16, 16), None),
]


def _operands(a_shape, b_shape, layout, dtype):
    A, Bm = _data(*a_shape, dtype=dtype), _data(*b_shape, dtype=dtype)
    if layout == "permuted":  # as the role-wise GEMM before it leaves it
        Bm = Bm.permute(3, 4, 0, 1, 2, 5).contiguous().permute(2, 3, 4, 0, 1, 5)
    elif layout == "expanded":  # one latent mean read for every object
        Bm = Bm[:, :, :1].expand(Bm.shape)
    return A, Bm


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name,route,a_shape,b_shape,layout", CASES, ids=[c[0] for c in CASES])
def test_each_route_computes_the_matmul(name, route, a_shape, b_shape, layout, dtype):
    A, Bm = _operands(a_shape, b_shape, layout, dtype)
    before = linalg.PRODUCTS.counts()
    got = linalg.product(A, Bm)
    after = linalg.PRODUCTS.counts()
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    want = torch.matmul(A, Bm)
    assert got.shape == want.shape and got.dtype == want.dtype
    if a_shape[-1] == 1 or route == "matmul":  # one term an output, or matmul itself
        assert torch.equal(got, want)
    else:
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= (1e-14 if dtype == torch.float64 else 1e-6), rel


def test_outer_and_the_counter():
    u, v = _data(T, B, O, 1, 7, 1, dtype=torch.float32), _data(T, B, O, 1, 2, 1, dtype=torch.float32)
    linalg.PRODUCTS.reset()
    assert linalg.PRODUCTS.counts() == {"broadcast": 0, "folded_gemm": 0, "matmul": 0}
    assert torch.equal(linalg.outer(u, v), u @ linalg.mT(v))
    linalg.product(_data(K, 2, 7, dtype=torch.float32), _data(K, 7, 1, dtype=torch.float32))
    assert linalg.PRODUCTS.counts() == {"broadcast": 1, "folded_gemm": 0, "matmul": 1}
    with pytest.raises(ValueError):
        linalg.product(torch.zeros(3, 2, 2), torch.zeros(4, 2, 1))


def test_the_size_rule_reads_the_broadcast_elements():
    """Broadcast at most BROADCAST_MAX_RATIO times the elements of the operands
    and result: (N, m, k) by (N, k, n) holds N m k n against N (m k + k n + m
    n)."""
    N = T * B * O
    for m, k, n in ((8, 16, 8), (16, 16, 16), (2, 40, 2), (1, 300, 1)):
        route, _ = linalg._route((N, m, k), (m * k, k, 1), (N, k, n), (k * n, n, 1))
        ratio = m * k * n / (m * k + k * n + m * n)
        assert route == ("broadcast" if ratio <= linalg.BROADCAST_MAX_RATIO else "matmul")


@pytest.mark.parametrize("role_dims,hidden_dims,obs_shape,objects", [
    ((1, 2, 1), (2, 2, 2), (3, 2), 1),   # dmbd-lorenz, K = 4, H = 6
    ((2, 2, 2), (2, 2, 2), (12, 4), 6),  # dmbd-flocking, K = H = 26
], ids=["lorenz", "flocking"])
def test_a_dmbd_sweep_hands_cublas_no_batch_of_entries(role_dims, hidden_dims, obs_shape, objects):
    """A model's first sweep at T = 22, batch 3 (T*B above MATMUL_MAX_BATCH,
    as on the card's cells): no bmm batches T*B*O or more problems, and the
    products take each route as often as there."""
    Tn, Bn = 22, 3
    model = DynamicMarkovBlanketDiscovery(obs_shape, role_dims, hidden_dims,
                                          number_of_objects=objects, parallel_scan=True,
                                          dtype=torch.float32, device="cpu")
    y = _data(Tn, Bn, *obs_shape, dtype=torch.float32)
    linalg.PRODUCTS.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True) as prof:
        model.update(y, iters=1, lr=0.5)
    assert linalg.PRODUCTS.counts() == {"broadcast": 11, "folded_gemm": 4, "matmul": 0}
    entries = Tn * Bn * obs_shape[0]
    batches = [e.input_shapes[0][0] for e in prof.events()
               if e.name in ("aten::bmm", "aten::baddbmm") and e.input_shapes]
    assert batches and max(batches) < entries, (max(batches), entries)
    assert math.isfinite(model.ELBO_last)
