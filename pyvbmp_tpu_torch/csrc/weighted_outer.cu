// Weighted per-class scatter O[k] = sum_s W[s,k] x_s x_s^T in FP32 FMA.
//
// Replaces pyvbmp_tpu/ops/weighted_scatter.py:weighted_outer_pallas (body
// _kernel): the per-class scatter of the Polya-Gamma MNLR update
// (transforms/mnlr.py:_raw_update_fast).
//
// Layout: X is (S, p), W is (S, K), O is (K, p, p), all float32 and
// contiguous; S and p are ragged, K >= 1.
//
// Design: a GEMM whose A operand is the Khatri-Rao product W (.) X (M = K p
// rows, N = p columns, reduction over S), formed in registers while the
// stages are consumed.  O[k] is cut into 32 x 32 tiles and only the
// upper-triangle tiles (ti <= tj) are computed.
//   - Pass 1 gives one block to each (upper tile, class group, S-chunk).  A
//     group holds G <= 16 classes, so each S-stage of X and W is read once
//     for all its classes (K <= 16: once in all).  The block has 16 G
//     threads; each owns an 8 x 8 register micro-tile (one class, 8 rows i,
//     8 columns j) fed by float4 shared-memory loads: 64 FMAs and 8 FMULs
//     (the weight) per 4 float4 and 1 scalar load.
//   - Stages of 64 rows (X's two column slices and W's group columns) are
//     copied with cp.async into a double buffer: the next stage loads while
//     the current one is consumed, with one barrier per stage.  Copies are
//     16 bytes where X's rows are 16-byte aligned (p % 4 == 0), 4 bytes
//     otherwise; the ragged edges (rows past the chunk, columns past p,
//     classes past K) are zero-filled by the copy itself.
//   - In a diagonal tile the micro-tiles wholly below the diagonal are never
//     read; the threads are ordered so that those fall into whole warps,
//     which skip the FMAs (10 of 16 micro-tiles are computed).  So do the
//     micro-tiles wholly past p in the last tile row and column.
//   - The S-chunks ("splits") fill the card (ops/weighted_scatter.py:_plan
//     sizes them from the SM count).  Pass 2 sums the per-split partials in
//     a fixed order (no atomics, so a fit repeats bit for bit) and writes
//     both triangles from the upper one, so O[k] is exactly symmetric.
// No tensor cores and no TF32: the Polya-Gamma fixed point is
// cancellation-sensitive (it collapses to chance accuracy at reduced matmul
// precision), and the plain version it is held to is a float32 SGEMM.
//
// What bounds it on an H100: the FLOPs, 2 S K p(p+1)/2 on the triangle,
// against 67 TFLOP/s of FP32 FMA; X and W are read from device memory about
// once (the tiles of one S-chunk run side by side and share them in L2).
// The TPU kernel's 128-lane padding of p and K, one-hot lane select of class
// k and 512-row tile are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // output tile edge
constexpr int kRows = 64;      // S rows per stage
constexpr int kSub = 8;        // micro-tile edge
constexpr int kMaxGroup = 16;  // classes per block
constexpr int kMaxThreads = 16 * kMaxGroup;

// Micro-tile (row, column) of each of the 16 thread slots of a class: the
// 10 on or above the diagonal first, so in a diagonal tile the 6 below it
// are the last threads of the block.
__constant__ unsigned char kPairI[16] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 1, 2, 2, 3, 3, 3};
__constant__ unsigned char kPairJ[16] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3, 0, 0, 1, 0, 1, 2};

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Stage {
  float x[2][kRows][kTile];  // X[s, i0 + c] and X[s, j0 + c]
  float w[kRows][kMaxGroup];  // W[s, g0 + c]
};

// grid (upper tiles, class groups, splits), 16 G threads
__global__ void __launch_bounds__(kMaxThreads, 2)
weighted_outer_partial(const float* __restrict__ X, const float* __restrict__ W,
                       float* __restrict__ partial, int S, int p, int K,
                       int n_tiles, int G, int rows_per_split, int vec) {
  __shared__ __align__(16) Stage stage[2];

  // (ti, tj) of the blockIdx.x-th upper tile, row-major over ti <= tj
  int ti = 0, rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int i0 = ti * kTile, j0 = tj * kTile, g0 = blockIdx.y * G;
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int g = t % G, slot = t / G;
  const int isub = kPairI[slot], jsub = kPairJ[slot];
  // a micro-tile is computed unless nothing of it is read: below the
  // diagonal, a class past K, or rows or columns wholly past p
  const bool active = !(diag && isub > jsub) && g0 + g < K && i0 + isub * kSub < p &&
                      j0 + jsub * kSub < p;

  const int s_begin = blockIdx.z * rows_per_split;
  const int s_end = min(S, s_begin + rows_per_split);
  const int n_stages = (s_end - s_begin + kRows - 1) / kRows;

  // Each thread copies fixed columns at rows r0, r0 + rstep, ...: X in
  // 16-byte pieces (8 threads per 32-float row slice) or, unaligned, 4-byte
  // ones (16 threads per slice, two columns 16 apart each); W's group
  // columns one class per thread (16 threads per row, as 16 G threads
  // make G per row).
  const int xcol = vec ? (t & 7) * 4 : (t & 15);
  const int xr0 = vec ? t >> 3 : t >> 4;
  const int xstep = vec ? nthreads >> 3 : nthreads >> 4;
  const int wr0 = t / G, wc = t % G;
  auto issue = [&](int st) {
    Stage& dst = stage[st & 1];
    const int s0 = s_begin + st * kRows;
    for (int half = 0; half < (diag ? 1 : 2); ++half) {
      const int col = (half ? j0 : i0) + xcol;
      const float* src = X + static_cast<size_t>(s0 + xr0) * p + col;
      const size_t src_step = static_cast<size_t>(xstep) * p;
      for (int r = xr0; r < kRows; r += xstep, src += src_step) {
        const bool row_ok = s0 + r < s_end;
        if (vec) {
          cp_async16(&dst.x[half][r][xcol], row_ok && col < p ? src : X, row_ok && col < p);
        } else {
          cp_async4(&dst.x[half][r][xcol], row_ok && col < p ? src : X, row_ok && col < p);
          cp_async4(&dst.x[half][r][xcol + 16], row_ok && col + 16 < p ? src + 16 : X,
                    row_ok && col + 16 < p);
        }
      }
    }
    const float* wsrc = W + static_cast<size_t>(s0 + wr0) * K + g0 + wc;
    for (int r = wr0; r < kRows; r += 16, wsrc += static_cast<size_t>(16) * K) {
      const bool ok = s0 + r < s_end && g0 + wc < K;
      cp_async4(&dst.w[r][wc], ok ? wsrc : W, ok);
    }
    cp_async_commit();
  };

  float acc[kSub][kSub] = {};
  issue(0);
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait_all();
    __syncthreads();  // stage st landed for all; stage st - 1 consumed by all
    if (st + 1 < n_stages) issue(st + 1);
    if (!active) continue;
    const Stage& cur = stage[st & 1];
    const float(*a)[kTile] = cur.x[0];
    const float(*b)[kTile] = cur.x[diag ? 0 : 1];
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a[r][isub * kSub]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a[r][isub * kSub + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b[r][jsub * kSub]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b[r][jsub * kSub + 4]);
      const float w = cur.w[r][g];
      const float av[kSub] = {w * a0.x, w * a0.y, w * a0.z, w * a0.w,
                              w * a1.x, w * a1.y, w * a1.z, w * a1.w};
      const float bv[kSub] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int v = 0; v < kSub; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
  }
  if (!active) return;

  // partial[split][group][tile][g] is one 32 x 32 tile
  float* out = partial +
               (((static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x) * G + g) * kTile * kTile;
#pragma unroll
  for (int u = 0; u < kSub; ++u) {
    float4* row = reinterpret_cast<float4*>(out + (isub * kSub + u) * kTile + jsub * kSub);
    row[0] = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    row[1] = make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
  }
}

// One thread per output entry (k, i, j): the sum over splits of the
// upper-triangle entry (min(i,j), max(i,j)), in a fixed order (eight
// interleaved running sums, then their pairwise tree).
__global__ void weighted_outer_reduce(const float* __restrict__ partial,
                                      float* __restrict__ O, int p, int K,
                                      int n_tiles, int G, int n_groups,
                                      int n_splits) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(K) * p * p;
  if (idx >= total) return;
  const int k = static_cast<int>(idx / (static_cast<size_t>(p) * p));
  const int ij = static_cast<int>(idx % (static_cast<size_t>(p) * p));
  int i = ij / p, j = ij % p;
  if (i > j) {
    const int tmp = i;
    i = j;
    j = tmp;
  }
  const int ti = i / kTile, tj = j / kTile;
  // rows ti' < ti hold n_tiles - ti' upper tiles each
  const int tile = ti * n_tiles - ti * (ti - 1) / 2 + (tj - ti);
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  const size_t split_stride = static_cast<size_t>(n_groups) * n_upper * G * kTile * kTile;
  const float* src = partial +
                     ((static_cast<size_t>(k / G) * n_upper + tile) * G + k % G) * kTile * kTile +
                     (i % kTile) * kTile + (j % kTile);
  constexpr int kWays = 8;
  float acc[kWays] = {};
  int s = 0;
  for (; s + kWays <= n_splits; s += kWays)
#pragma unroll
    for (int u = 0; u < kWays; ++u) acc[u] += src[(s + u) * split_stride];
  for (; s < n_splits; ++s) acc[0] += src[s * split_stride];
#pragma unroll
  for (int width = kWays / 2; width > 0; width /= 2)
#pragma unroll
    for (int u = 0; u < width; ++u) acc[u] += acc[u + width];
  O[idx] = acc[0];
}

}  // namespace

// partial is scratch of n_splits * n_groups * (n_tiles (n_tiles + 1) / 2) *
// group * 32 * 32 floats, n_tiles = ceil(p / 32), n_groups = ceil(K /
// group); split s covers rows [s * rows_per_split, (s + 1) *
// rows_per_split) of S (its last stage may be short).  group is the
// classes per block (1..16); vec says X's rows are 16-byte aligned (p % 4 ==
// 0 and X 16-byte aligned).  Returns 0 on a clean launch of both passes, the
// cudaGetLastError() code otherwise.
extern "C" int weighted_outer_f32(const void* X, const void* W, void* O,
                                  void* partial, int S, int p, int K,
                                  int n_splits, int rows_per_split, int group,
                                  int vec, void* stream) {
  if (S < 1 || p < 1 || K < 1 || n_splits < 1 || rows_per_split < 1 || group < 1 ||
      group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (p + kTile - 1) / kTile;
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  const int n_groups = (K + group - 1) / group;
  const dim3 grid(n_upper, n_groups, n_splits);
  weighted_outer_partial<<<grid, 16 * group, 0, st>>>(
      static_cast<const float*>(X), static_cast<const float*>(W),
      static_cast<float*>(partial), S, p, K, n_tiles, group, rows_per_split, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(K) * p * p;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  weighted_outer_reduce<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(O), p, K, n_tiles,
      group, n_groups, n_splits);
  return static_cast<int>(cudaGetLastError());
}
