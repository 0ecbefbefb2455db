"""The smoothers' prefix and suffix scans: three CUDA kernels and their plain
PyTorch versions (counterpart of pyvbmp_tpu/ops/chunked_scan.py:auto_scan and
the Pallas kernel pyvbmp_tpu/ops/pallas_scan.py:_build_call).

All three are inclusive scans over axis 0 of an associative combine with no
identity element, in chain order:

    forward: out[t] = e[0] o e[1] o ... o e[t]
    reverse: out[t] = e[t] o e[t+1] o ... o e[T-1]

- ``logsemiring_scan(M)``: M is (T, K, K, N), the combine is
  ``parallel_hmm._logmatmul_plane`` (the role chain);
- ``kalman_plane_scan((Jaa, Jab, Jbb, ha, hb, logw))``: Gaussian pair
  potentials in plane layout, the combine is
  ``parallel_kalman._combine_plane`` (the latent chain, h > 3);
- ``kalman_lane_scan((Jaa, Jab, Jbb, ha, hb, logw))``: the same potentials
  packed by components (``ops/smallmat.py``), the combine is
  ``parallel_kalman._combine_lane`` (the latent chain, h <= 3).

Dispatch is by the device of the input: a CPU tensor goes through the plain
version (a sequential left fold of the combine), a CUDA tensor launches the
kernel and raises on anything the kernel does not take.  There is no
fallback from one to the other.

The kernels are built and loaded by ``ops/_cuda.py``.
"""
from __future__ import annotations

import torch

from ._cuda import load_library


def _logmatmul_plane(a, b):
    from .parallel_hmm import _logmatmul_plane as combine

    return combine(a, b)


def _combine_plane(e1, e2):
    from .parallel_kalman import _combine_plane as combine

    return combine(e1, e2)


def _combine_lane(e1, e2):
    from .parallel_kalman import _combine_lane as combine

    return combine(e1[3].shape[-2], e1, e2)


class Scan:
    """One scan: its kernel, its plain version and their counts.

    ``launches`` counts kernel launches and nothing else; ``plain_calls``
    counts runs of the plain version."""

    def __init__(self, name, symbol, source, replaces, sizes, combine,
                 leaf_shapes, size_of):
        self.name = name
        self.symbol = symbol
        self.source = source
        self.replaces = replaces
        self.sizes = tuple(sizes)  # instantiated K or H
        self.combine = combine
        self.leaf_shapes = leaf_shapes  # (T, size, N) -> shape of each leaf
        self.size_of = size_of  # leaves -> K or H
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, leaves, reverse=False):
        device = leaves[0].device
        if device.type == "cpu":
            return self.plain(leaves, reverse)
        if device.type == "cuda":
            return self.kernel(leaves, reverse)
        raise ValueError(f"{self.name}: no version for device {device}")

    def plain(self, leaves, reverse=False):
        """Sequential left fold in the kernel's association order."""
        self.plain_calls += 1
        T = leaves[0].shape[0]
        out = [torch.empty_like(x) for x in leaves]
        carry = None
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            e = tuple(x[t] for x in leaves)
            if carry is None:
                carry = e
            elif reverse:
                carry = self.combine(e, carry)
            else:
                carry = self.combine(carry, e)
            for o, c in zip(out, carry):
                o[t] = c
        return out

    def kernel(self, leaves, reverse=False):
        T, N = leaves[0].shape[0], leaves[0].shape[-1]
        size = self.size_of(leaves)
        if size not in self.sizes:
            raise ValueError(
                f"{self.name}: size {size} is not instantiated (have {self.sizes})"
            )
        want = self.leaf_shapes(T, size, N)
        if len(leaves) != len(want):
            raise ValueError(f"{self.name}: want {len(want)} leaves, got {len(leaves)}")
        device = leaves[0].device
        for x, shape in zip(leaves, want):
            if x.device != device or x.dtype != torch.float32:
                raise TypeError(f"{self.name}: leaves must be float32 on {device}")
            if tuple(x.shape) != shape or not x.is_contiguous():
                raise ValueError(
                    f"{self.name}: want contiguous {shape}, got {tuple(x.shape)}"
                )
        if T < 1 or N < 1:
            raise ValueError(f"{self.name}: empty scan (T={T}, N={N})")
        lib = load_library()
        out = [torch.empty_like(x) for x in leaves]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = getattr(lib, self.symbol)(
                *(x.data_ptr() for x in leaves), *(o.data_ptr() for o in out),
                T, size, N, int(bool(reverse)), stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        self.launches += 1
        return out


LOGSEMIRING = Scan(
    "logsemiring_scan",
    "logsemiring_scan_f32",
    "pyvbmp_tpu_torch/csrc/logsemiring_scan.cu",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=(4, 7),
    combine=lambda a, b: (_logmatmul_plane(a[0], b[0]),),
    leaf_shapes=lambda T, K, N: [(T, K, K, N)],
    size_of=lambda leaves: leaves[0].shape[1],
)
KALMAN_PLANE = Scan(
    "kalman_plane_scan",
    "kalman_plane_scan_f32",
    "pyvbmp_tpu_torch/csrc/kalman_plane_scan.cu",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=(6, 10),
    combine=_combine_plane,
    leaf_shapes=lambda T, H, N: [(T, H, H, N)] * 3 + [(T, H, N)] * 2 + [(T, N)],
    size_of=lambda leaves: leaves[0].shape[1],
)
KALMAN_LANE = Scan(
    "kalman_lane_scan",
    "kalman_lane_scan_f32",
    "pyvbmp_tpu_torch/csrc/kalman_lane_scan.cu",
    "pyvbmp_tpu/ops/pallas_scan.py:219",
    sizes=(1, 2, 3),
    combine=_combine_lane,
    leaf_shapes=lambda T, H, N: (
        [(T, H * (H + 1) // 2, N), (T, H * H, N), (T, H * (H + 1) // 2, N)]
        + [(T, H, N)] * 2 + [(T, N)]
    ),
    size_of=lambda leaves: leaves[3].shape[1] if len(leaves) > 3 else None,
)
SCANS = (LOGSEMIRING, KALMAN_PLANE, KALMAN_LANE)


def logsemiring_scan(M, reverse=False):
    """Inclusive (log,+) matrix scan of M (T, K, K, N) in chain order."""
    return LOGSEMIRING((M,), reverse)[0]


def kalman_plane_scan(elems, reverse=False):
    """Inclusive scan of Gaussian pair potentials (Jaa, Jab, Jbb, ha, hb,
    logw) in plane layout, chain order."""
    return tuple(KALMAN_PLANE(tuple(elems), reverse))


def kalman_lane_scan(elems, reverse=False):
    """Inclusive scan of Gaussian pair potentials (Jaa, Jab, Jbb, ha, hb,
    logw) packed by components (ops/smallmat.py), chain order."""
    return tuple(KALMAN_LANE(tuple(elems), reverse))


def plain_logsemiring_scan(M, reverse=False):
    return LOGSEMIRING.plain((M,), reverse)[0]


def plain_kalman_plane_scan(elems, reverse=False):
    return tuple(KALMAN_PLANE.plain(tuple(elems), reverse))
