// Weighted per-class scatter O[k] = sum_s W[s,k] x_s x_s^T in FP32 FMA.
//
// Replaces pyvbmp_tpu/ops/weighted_scatter.py:weighted_outer_pallas (body
// _kernel): the per-class scatter of the Polya-Gamma MNLR update
// (transforms/mnlr.py:_raw_update_fast).
//
// Layout: X is (S, p), W is (S, K), O is (K, p, p), all float32 and
// contiguous; S and p are ragged, K >= 1.
//
// Design.  O[k] is cut into 32 x 32 tiles and only the upper-triangle tiles
// (ti <= tj) are computed.  Pass 1 gives one block to each (upper tile, k,
// S-chunk): the block walks its chunk in 32-row stages, staging the two X
// column slices (the row slice pre-multiplied by W[:, k]) in shared memory,
// and each of its 64 threads accumulates a 4 x 4 register micro-tile with
// FP32 FMA.  The S-chunks ("splits") exist to fill the card when K times the
// tile count is small (digits: K=9, 6 tiles of 65^2, 54 blocks).  Pass 2 sums
// the per-split partials in a fixed order (no atomics, so a fit repeats bit
// for bit) and writes both triangles from the upper one, so O[k] is exactly
// symmetric.  No tensor cores and no TF32: the Polya-Gamma fixed point is
// cancellation-sensitive (it collapses to chance accuracy at reduced matmul
// precision), and the plain version it is held to is a float32 SGEMM.
//
// What bounds it on an H100: the FLOPs, 2 S K p^2 (half of them are skipped
// by the triangle), against ~60 TFLOP/s of FP32 FMA; shared-memory traffic is
// 8 float4-sized loads per 16 FMAs.  X is re-read once per class, mostly from
// L2.  The TPU kernel's 128-lane padding of p and K, one-hot lane select of
// class k and 512-row tile are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;     // output tile edge
constexpr int kRows = 32;     // S rows staged per step
constexpr int kThreads = 64;  // 8 x 8 threads, 4 x 4 outputs each
constexpr int kMicro = 4;

__global__ void __launch_bounds__(kThreads)
weighted_outer_partial(const float* __restrict__ X, const float* __restrict__ W,
                       float* __restrict__ partial, int S, int p, int K,
                       int n_tiles, int rows_per_split) {
  const int tile = blockIdx.x;  // index among the upper-triangle tiles
  const int k = blockIdx.y;
  const int split = blockIdx.z;
  // (ti, tj) of the tile-th upper tile, row-major over ti <= tj
  int ti = 0, rem = tile;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int i0 = ti * kTile, j0 = tj * kTile;

  __shared__ __align__(16) float xa[kRows][kTile];  // W[s,k] * X[s, i0 + i]
  __shared__ __align__(16) float xb[kRows][kTile];  // X[s, j0 + j]

  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[kMicro][kMicro] = {};

  const int s_begin = split * rows_per_split;
  const int s_end = min(S, s_begin + rows_per_split);
  const int col = threadIdx.x % kTile;
  for (int s0 = s_begin; s0 < s_end; s0 += kRows) {
    for (int r = threadIdx.x / kTile; r < kRows; r += kThreads / kTile) {
      const int s = s0 + r;
      const bool row_ok = s < s_end;
      const float w = row_ok ? W[static_cast<size_t>(s) * K + k] : 0.0f;
      const float* xs = X + static_cast<size_t>(s) * p;
      xa[r][col] = (row_ok && i0 + col < p) ? w * xs[i0 + col] : 0.0f;
      xb[r][col] = (row_ok && j0 + col < p) ? xs[j0 + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xa[r][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&xb[r][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  float* out = partial +
               ((static_cast<size_t>(split) * K + k) * n_upper + tile) * kTile * kTile;
#pragma unroll
  for (int u = 0; u < kMicro; ++u)
#pragma unroll
    for (int v = 0; v < kMicro; ++v)
      out[(ty * kMicro + u) * kTile + tx * kMicro + v] = acc[u][v];
}

// One thread per output entry (k, i, j): the sum over splits, in split
// order, of the upper-triangle entry (min(i,j), max(i,j)).
__global__ void weighted_outer_reduce(const float* __restrict__ partial,
                                      float* __restrict__ O, int p, int K,
                                      int n_tiles, int n_splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(K) * p * p;
  if (idx >= total) return;
  const int k = static_cast<int>(idx / (static_cast<size_t>(p) * p));
  const int ij = static_cast<int>(idx % (static_cast<size_t>(p) * p));
  int i = ij / p, j = ij % p;
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  const int ti = i / kTile, tj = j / kTile;
  // rows ti' < ti hold n_tiles - ti' upper tiles each
  const int tile = ti * n_tiles - ti * (ti - 1) / 2 + (tj - ti);
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  const size_t split_stride = static_cast<size_t>(K) * n_upper * kTile * kTile;
  const float* src = partial +
                     (static_cast<size_t>(k) * n_upper + tile) * kTile * kTile +
                     (i % kTile) * kTile + (j % kTile);
  float sum = 0.0f;
  for (int s = 0; s < n_splits; ++s) sum += src[s * split_stride];
  O[idx] = sum;
}

}  // namespace

// partial is scratch of n_splits * K * (n_tiles (n_tiles + 1) / 2) * 32 * 32
// floats, n_tiles = ceil(p / 32); split s covers rows
// [s * rows_per_split, (s + 1) * rows_per_split) of S.  Returns 0 on a clean
// launch of both passes, the cudaGetLastError() code otherwise.
extern "C" int weighted_outer_f32(const void* X, const void* W, void* O,
                                  void* partial, int S, int p, int K,
                                  int n_splits, int rows_per_split,
                                  void* stream) {
  if (S < 1 || p < 1 || K < 1 || n_splits < 1 || rows_per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (p + kTile - 1) / kTile;
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  const dim3 grid(n_upper, K, n_splits);
  weighted_outer_partial<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(W),
      static_cast<float*>(partial), S, p, K, n_tiles, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(K) * p * p;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  weighted_outer_reduce<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(O), p, K, n_tiles,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}
