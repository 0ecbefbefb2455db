"""Weighted per-class scatter O[k] = sum_s W[s,k] x_s x_s^T: one CUDA kernel
and its plain PyTorch version (counterpart of
pyvbmp_tpu/ops/weighted_scatter.py, whose Pallas kernel is
``weighted_outer_pallas``).

``weighted_outer(X, W)`` dispatches on the device of X: a CPU tensor goes
through ``weighted_outer_einsum``, a CUDA tensor launches
``csrc/weighted_outer.cu`` and raises on anything the kernel does not take.
There is no fallback from one to the other, and no ``force``/``interpret``
switch: the device is the switch.
"""
from __future__ import annotations

import torch

from ._cuda import load_library

TILE = 32  # the kernel's output tile edge (csrc/weighted_outer.cu:kTile)
MIN_SPLIT_ROWS = 4 * TILE  # fewest sample rows worth a block of their own
BLOCKS_PER_SM = 4  # pass-1 blocks to aim for on each SM


def weighted_outer_einsum(X, W):
    """Matmul formulation: A = W (x) X reshaped (S, K*p); O = A^T X."""
    S, p = X.shape
    K = W.shape[-1]
    A = (W[:, :, None] * X[:, None, :]).reshape(S, K * p)
    return (A.T @ X).reshape(K, p, p)


def _splits(S, K, p, device):
    """(n_splits, rows_per_split, upper tiles per class): S-chunks enough to
    give each SM about BLOCKS_PER_SM pass-1 blocks, none shorter than
    MIN_SPLIT_ROWS."""
    n_tiles = -(-p // TILE)
    blocks = K * n_tiles * (n_tiles + 1) // 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(-(-BLOCKS_PER_SM * sms // blocks), -(-S // MIN_SPLIT_ROWS)))
    rows = -(-S // want)
    rows = -(-rows // TILE) * TILE
    return -(-S // rows), rows, blocks // K


class WeightedOuter:
    """The kernel, its plain version and their counts: ``launches`` counts
    kernel launches and nothing else, ``plain_calls`` runs of the plain
    version."""

    name = "weighted_outer"
    symbol = "weighted_outer_f32"
    source = "pyvbmp_tpu_torch/csrc/weighted_outer.cu"
    replaces = "pyvbmp_tpu/ops/weighted_scatter.py:54"

    def __init__(self):
        self.launches = 0
        self.plain_calls = 0

    def __call__(self, X, W):
        if X.device.type == "cpu":
            return self.plain(X, W)
        if X.device.type == "cuda":
            return self.kernel(X, W)
        raise ValueError(f"{self.name}: no version for device {X.device}")

    def plain(self, X, W):
        self.plain_calls += 1
        return weighted_outer_einsum(X, W)

    def kernel(self, X, W):
        if X.ndim != 2 or W.ndim != 2 or X.shape[0] != W.shape[0]:
            raise ValueError(
                f"{self.name}: want X (S, p) and W (S, K), got "
                f"{tuple(X.shape)} and {tuple(W.shape)}"
            )
        S, p = X.shape
        K = W.shape[1]
        if S < 1 or p < 1 or K < 1:
            raise ValueError(f"{self.name}: empty input (S={S}, p={p}, K={K})")
        for x in (X, W):
            if x.device != X.device or x.dtype != torch.float32:
                raise TypeError(f"{self.name}: X and W must be float32 on {X.device}")
            if not x.is_contiguous():
                raise ValueError(f"{self.name}: X and W must be contiguous")
        n_splits, rows, n_upper = _splits(S, K, p, X.device)
        lib = load_library()
        out = torch.empty((K, p, p), dtype=torch.float32, device=X.device)
        partial = torch.empty(
            (n_splits, K, n_upper, TILE, TILE), dtype=torch.float32, device=X.device
        )
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = getattr(lib, self.symbol)(
                X.data_ptr(), W.data_ptr(), out.data_ptr(), partial.data_ptr(),
                S, p, K, n_splits, rows, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        self.launches += 1
        return out


WEIGHTED_OUTER = WeightedOuter()


def weighted_outer(X, W):
    """X (S, p), W (S, K) -> (K, p, p): O[k] = sum_s W[s,k] x_s x_s^T."""
    return WEIGHTED_OUTER(X, W)
