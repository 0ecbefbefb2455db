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

from typing import NamedTuple

import torch

from ._cuda import load_library

TILE = 32  # the kernel's output tile edge (csrc/weighted_outer.cu:kTile)
STAGE_ROWS = 64  # S rows per stage (kRows)
MAX_GROUP = 16  # classes per block (kMaxGroup); the block has 16 threads per class
REGS_PER_THREAD = 128  # the launch bound's cap: 2 blocks of 256 threads per SM
REGS_PER_SM = 65536
MAX_BLOCKS_PER_SM = 32


def weighted_outer_einsum(X, W):
    """Matmul formulation: A = W (x) X reshaped (S, K*p); O = A^T X."""
    S, p = X.shape
    K = W.shape[-1]
    A = (W[:, :, None] * X[:, None, :]).reshape(S, K * p)
    return (A.T @ X).reshape(K, p, p)


class Plan(NamedTuple):
    """The kernel's launch: ``n_splits`` S-chunks of ``rows`` rows, the
    classes in ``n_groups`` groups of ``group``, ``n_upper`` upper tiles per
    class; pass 1 writes ``scratch`` floats of partials."""

    n_splits: int
    rows: int
    group: int
    n_groups: int
    n_upper: int
    threads: int
    blocks_per_sm: int
    scratch: int


def _plan(S, K, p, sms):
    """The launch for X (S, p), W (S, K) on a card with ``sms`` SMs: class
    groups as even as 16 classes a block allow, then S-chunks of whole
    stages, as few stages each as one wave of every SM's resident blocks
    allows (a block's time is its stage count)."""
    n_tiles = -(-p // TILE)
    n_upper = n_tiles * (n_tiles + 1) // 2
    n_groups = -(-K // MAX_GROUP)
    group = -(-K // n_groups)
    threads = 16 * group
    warps = -(-threads // 32)
    blocks_per_sm = min(MAX_BLOCKS_PER_SM, REGS_PER_SM // (warps * 32 * REGS_PER_THREAD))
    want = max(1, sms * blocks_per_sm // (n_upper * n_groups))
    rows = -(-S // (want * STAGE_ROWS)) * STAGE_ROWS
    n_splits = -(-S // rows)
    scratch = n_splits * n_groups * n_upper * group * TILE * TILE
    return Plan(n_splits, rows, group, n_groups, n_upper, threads, blocks_per_sm, scratch)


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
        sms = torch.cuda.get_device_properties(X.device).multi_processor_count
        plan = _plan(S, K, p, sms)
        vec = int(p % 4 == 0 and X.data_ptr() % 16 == 0)
        lib = load_library()
        out = torch.empty((K, p, p), dtype=torch.float32, device=X.device)
        partial = torch.empty(plan.scratch, dtype=torch.float32, device=X.device)
        with torch.cuda.device(X.device):
            stream = torch.cuda.current_stream(X.device).cuda_stream
            rc = getattr(lib, self.symbol)(
                X.data_ptr(), W.data_ptr(), out.data_ptr(), partial.data_ptr(),
                S, p, K, plan.n_splits, plan.rows, plan.group, vec, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.name}: launch failed, cudaError {rc}")
        self.launches += 1
        return out


WEIGHTED_OUTER = WeightedOuter()


def weighted_outer(X, W):
    """X (S, p), W (S, K) -> (K, p, p): O[k] = sum_s W[s,k] x_s x_s^T."""
    return WEIGHTED_OUTER(X, W)
