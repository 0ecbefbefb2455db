// Inclusive scan of the (log, +) matrix semiring over time, walked in one
// pass or folded into time chunks, with a group of threads per batch lane.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call (one pass) and
// pyvbmp_tpu/ops/pallas_scan.py:_build_folded_call (the time fold) with the
// combine pyvbmp_tpu/ops/parallel_hmm.py:_logmatmul_plane: the prefix and
// suffix scans of the role-chain forward-backward (_hmm_plane_core).
//
// Layout: M and out are (T, K, K, N) float32, contiguous, batch lane n minor.
//   forward: out[t] = M[0] (x) M[1] (x) ... (x) M[t]
//   reverse: out[t] = M[t] (x) M[t+1] (x) ... (x) M[T-1]
// Both are in chain order; (x) is the log-matmul with the -inf guard of
// _logmatmul_plane: m = max_k(a_ik + b_kj), m := 0 where m is not finite,
// result m + log(sum_k exp(a_ik + b_kj - m)).  Masked role transitions give
// -inf entries, which stay -inf (exp(-inf - 0) = 0, log(0) = -inf), never NaN.
//
// The time fold (C > 1) is the three-phase block scan.  Chunk c holds rows
// [c L + offset, (c + 1) L + offset) clipped to [0, T); offset is 0 forward
// and C L - T rows to the left in reverse, so the one short chunk is the one
// whose total no other chunk needs (the JAX package pads that chunk with
// copies of its edge element instead; the outputs are the same).
//   logsemiring_scan_kernel, grid (lane blocks, C): phase 1, the in-chunk
//     inclusive scan, and each chunk's total into totals (C, K, K, N);
//   logsemiring_fixup_kernel, grid (lane blocks, C, row groups): phases 2-3
//     fused.  Each block folds the totals of the chunks before its chunk
//     (after it, in reverse) into the carry-in, then combines the carry-in
//     with its group of the chunk's rows, in place; the row groups of one
//     chunk run in parallel.
// The one-pass scan is C = 1, L = T: phase 1 alone.
//
// What bounds it on an H100: one scan reads each element once and writes
// each prefix once (Flocking, K=14, T=150, N=240: 28 MB both ways, ~8 us at
// 3.35 TB/s); the K^3 terms of a combine need an add, an exp and a max each.
// The bound in practice is the chain of T dependent combines, so the design
// cuts the latency of one combine:
//   - a block owns kLanes lanes and a group of G threads per lane; thread g
//     of a group computes the output entries q = g, g + G, ... (q = i K + j)
//     of its lane, so one combine is K^2 independent K-term reductions spread
//     over the group rather than K^3 serial terms on one thread;
//   - the carry and the incoming element live in shared memory, in
//     (entry, lane) order so the threads of a warp read neighbouring words,
//     padded to the template's rung KP (4, 8, 16, 32) with -inf rows and
//     columns: the padded terms are -inf and leave the real block exact, and
//     the loops over k unroll at the rung's size; nothing sits in local memory;
//   - the carry is double-buffered and the elements sit in a ring of
//     kStages buffers: steps s + 1 .. s + kStages - 1 are copied with
//     cp.async (coalesced over the block's lanes) while step s combines, so
//     a step costs one block barrier and no wait on device memory;
//   - K > 32 takes the generic path, which takes any K: one launch per step
//     of the walk (their order on the stream is the barrier between steps),
//     each block one 16 x 16 tile of the product for 8 lanes, the operands
//     streamed through shared memory in 16 x 16 tiles over k, twice (the
//     max, then the sum); the carry is the previous prefix, read back from
//     out.  The fold's phases 2-3 go chunk by chunk in chain order: each
//     row is combined with the last row before its chunk (a complete prefix
//     by then) into the totals scratch and copied back.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
// the generic path (K > 32): the tile's side, lanes per block (minor in each
// warp, so that a warp's reads of one entry are coalesced), and threads per
// block (32 a lane, each one row and 8 columns of the tile)
constexpr int kTile = 16;
constexpr int kTileLanes = 8;
constexpr int kTileThreads = 32 * kTileLanes;

// Per rung: lanes per block, output entries per thread, and element
// buffers (the elements of steps s + 1 .. s + kStages - 1 are in flight
// while step s combines).
template <int KP> struct Rung;
template <> struct Rung<4> { static constexpr int kLanes = 8, kEpt = 1, kStages = 4; };
template <> struct Rung<8> { static constexpr int kLanes = 4, kEpt = 1, kStages = 4; };
template <> struct Rung<16> { static constexpr int kLanes = 2, kEpt = 2, kStages = 4; };
template <> struct Rung<32> { static constexpr int kLanes = 2, kEpt = 4, kStages = 3; };

// A block's view of the problem.  Shared matrices have KP rows and columns;
// entry (i, j) of lane l of buffer b sits at sm[b * buf + (i * KP + j) *
// kLanes + l].
struct Geo {
  int K, N, G, buf;
};

template <int KP>
__device__ __forceinline__ Geo geometry(int K, int N) {
  constexpr int lanes = Rung<KP>::kLanes;
  Geo g;
  g.K = K;
  g.N = N;
  g.buf = KP * KP * lanes;
  g.G = blockDim.x / lanes;
  return g;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Entry (i, j) of a (x) b for lane l, a and b shared matrices of this block.
template <int KP>
__device__ __forceinline__ float logmatmul_entry(const float* a, const float* b, int i, int j,
                                                 int l) {
  constexpr int lanes = Rung<KP>::kLanes;
  float m = -INFINITY;
  float s = 0.0f;
  float terms[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    terms[k] = a[(i * KP + k) * lanes + l] + b[(k * KP + j) * lanes + l];
    m = fmaxf(m, terms[k]);
  }
  if (!isfinite(m)) m = 0.0f;
#pragma unroll
  for (int k = 0; k < KP; ++k) s += expf(terms[k] - m);
  return m + logf(s);
}

// Every buffer entry of the block to -inf (the padding stays so).
__device__ __forceinline__ void fill_neg_inf(float* sm, int count) {
  for (int q = threadIdx.x; q < count; q += blockDim.x) sm[q] = -INFINITY;
}

// The rows [begin, end) of chunk c.
__device__ __forceinline__ void chunk_rows(int c, int T, int L, int offset, int& begin,
                                           int& end) {
  begin = max(c * L + offset, 0);
  end = min((c + 1) * L + offset, T);
}

// Offset of entry q of matrix t, lane n, in a (., K, K, N) array.
__device__ __forceinline__ size_t gidx(int t, int q, const Geo& g, int n) {
  return (static_cast<size_t>(t) * g.K * g.K + q) * g.N + n;
}

template <int KP>
__device__ __forceinline__ int sidx(int q, const Geo& g, int l) {
  const int i = q / g.K, j = q - (q / g.K) * g.K;
  return (i * KP + j) * Rung<KP>::kLanes + l;
}

// This thread's entries of matrix t of `src` into shared `dst`: cp.async
// (committed by the caller) or synchronous.
template <int KP, bool kAsync>
__device__ __forceinline__ void load_mine(float* dst, const float* src, int t, const Geo& g,
                                          int gi, int l, int n) {
  if (n >= g.N) return;
  for (int q = gi; q < g.K * g.K; q += g.G) {
    if constexpr (kAsync)
      cp_async4(dst + sidx<KP>(q, g, l), src + gidx(t, q, g, n));
    else
      dst[sidx<KP>(q, g, l)] = src[gidx(t, q, g, n)];
  }
}

// This thread's entries of a (x) b: into shared `keep` (unless null) and
// into matrix t of `dst` (unless null).
template <int KP>
__device__ __forceinline__ void combine_mine(const float* a, const float* b, float* keep,
                                             float* dst, int t, const Geo& g, int gi, int l,
                                             int n) {
  constexpr int lanes = Rung<KP>::kLanes;
  constexpr int ept = Rung<KP>::kEpt;
  const bool live = n < g.N;
  const int KK = g.K * g.K;
#pragma unroll(ept <= 2 ? ept : 1)
  for (int r = 0; r < ept; ++r) {
    const int q = gi + r * g.G;
    if (q < KK) {
      const int i = q / g.K, j = q - i * g.K;
      const float v = logmatmul_entry<KP>(a, b, i, j, l);
      if (keep != nullptr) keep[(i * KP + j) * lanes + l] = v;
      if (dst != nullptr && live) dst[gidx(t, q, g, n)] = v;
    }
  }
}

// grid (ceil(N / kLanes), C): the block's lanes walk the rows of chunk
// blockIdx.y.  Shared memory: carry[2], element[kStages].
template <int KP>
__global__ void __launch_bounds__(kMaxThreads)
logsemiring_scan_kernel(const float* __restrict__ M, float* __restrict__ out,
                        float* __restrict__ totals, int T, int K, int N, int L, int offset,
                        int reverse) {
  extern __shared__ __align__(16) float sm[];
  constexpr int lanes = Rung<KP>::kLanes;
  const Geo g = geometry<KP>(K, N);
  const int l = threadIdx.x % lanes, gi = threadIdx.x / lanes;
  const int n = blockIdx.x * lanes + l;
  constexpr int stages = Rung<KP>::kStages;
  // carry b at sm + b buf, element b at sm + (2 + b) buf (offsets, not an
  // array of pointers, which would live on the stack)
  auto carry = [&](int b) { return sm + b * g.buf; };
  auto elem = [&](int b) { return sm + (2 + b % stages) * g.buf; };
  int begin, end;
  chunk_rows(blockIdx.y, T, L, offset, begin, end);
  const int steps = end - begin;
  auto row = [&](int s) { return reverse ? end - 1 - s : begin + s; };

  fill_neg_inf(sm, (2 + stages) * g.buf);
  __syncthreads();
  // step 0: the carry is the first element, and so is the first prefix
  load_mine<KP, false>(carry(0), M, row(0), g, gi, l, n);
  if (n < N)
    for (int q = gi; q < K * K; q += g.G) out[gidx(row(0), q, g, n)] = M[gidx(row(0), q, g, n)];
  // one commit group per element, empty past the chunk's end, so that
  // "at most stages - 2 pending" always means "element s has landed"
  for (int p = 1; p < stages; ++p) {
    if (p < steps) load_mine<KP, true>(elem(p), M, row(p), g, gi, l, n);
    cp_async_commit();
  }
  int cur = 0;
  for (int s = 1; s < steps; ++s) {
    cp_async_wait<stages - 2>();
    __syncthreads();  // element s landed; carry s - 1 complete; element s - 1 read
    if (s + stages - 1 < steps)
      load_mine<KP, true>(elem(s + stages - 1), M, row(s + stages - 1), g, gi, l, n);
    cp_async_commit();
    const float* e = elem(s);
    if (reverse)
      combine_mine<KP>(e, carry(cur), carry(cur ^ 1), out, row(s), g, gi, l, n);
    else
      combine_mine<KP>(carry(cur), e, carry(cur ^ 1), out, row(s), g, gi, l, n);
    cur ^= 1;
  }
  // the chunk's total: the entries this thread wrote last
  if (totals != nullptr && n < N)
    for (int q = gi; q < K * K; q += g.G)
      totals[gidx(blockIdx.y, q, g, n)] = carry(cur)[sidx<KP>(q, g, l)];
}

// grid (ceil(N / kLanes), C, row groups): phases 2-3 for the block's lanes,
// chunk blockIdx.y, rows [begin + z R, begin + (z + 1) R) of it (R = rows
// per group).  Shared memory: acc[2], row element.
template <int KP>
__global__ void __launch_bounds__(kMaxThreads)
logsemiring_fixup_kernel(float* __restrict__ out, const float* __restrict__ totals, int T,
                         int K, int N, int L, int offset, int C, int rows_per_group,
                         int reverse) {
  extern __shared__ __align__(16) float sm[];
  constexpr int lanes = Rung<KP>::kLanes;
  const int c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (c == (reverse ? C - 1 : 0)) return;
  int begin, end;
  chunk_rows(blockIdx.y, T, L, offset, begin, end);
  const int lo = begin + blockIdx.z * rows_per_group;
  const int hi = min(lo + rows_per_group, end);
  if (lo >= hi) return;
  const Geo g = geometry<KP>(K, N);
  const int l = threadIdx.x % lanes, gi = threadIdx.x / lanes;
  const int n = blockIdx.x * lanes + l;
  auto acc = [&](int b) { return sm + b * g.buf; };
  float* e = sm + 2 * g.buf;

  fill_neg_inf(sm, 3 * g.buf);
  __syncthreads();
  // phase 2: acc = totals[0] (x) ... (x) totals[c-1], or in reverse
  // totals[c+1] (x) ... (x) totals[C-1]
  load_mine<KP, false>(acc(0), totals, reverse ? C - 1 : 0, g, gi, l, n);
  const int before = reverse ? C - 1 - c : c;
  int cur = 0;
  for (int s = 1; s < before; ++s) {
    load_mine<KP, false>(e, totals, reverse ? C - 1 - s : s, g, gi, l, n);
    __syncthreads();
    if (reverse)
      combine_mine<KP>(e, acc(cur), acc(cur ^ 1), nullptr, 0, g, gi, l, n);
    else
      combine_mine<KP>(acc(cur), e, acc(cur ^ 1), nullptr, 0, g, gi, l, n);
    __syncthreads();
    cur ^= 1;
  }
  // phase 3: the carry-in with each of the group's rows, in place (the row
  // is read into shared memory before any of it is written)
  for (int t = lo; t < hi; ++t) {
    load_mine<KP, false>(e, out, t, g, gi, l, n);
    __syncthreads();
    if (reverse)
      combine_mine<KP>(e, acc(cur), nullptr, out, t, g, gi, l, n);
    else
      combine_mine<KP>(acc(cur), e, nullptr, out, t, g, gi, l, n);
    __syncthreads();
  }
}

// The block's tile of dst = a (x) b, all three (K, K, N) matrices in device
// memory: blockIdx.x is (tile, lane group), tile = (row tile, column tile).
// Out-of-range entries of the operand tiles are -inf, which leaves the real
// ones exact; thread (l, g) computes row g / 2 and the columns 2 c + g % 2.
__device__ __forceinline__ void tile_product(const float* a, const float* b, float* dst, int K,
                                             int N) {
  __shared__ float as[kTile][kTile + 1][kTileLanes];  // padded: no bank conflicts
  __shared__ float bs[kTile][kTile][kTileLanes];
  const int groups = (N + kTileLanes - 1) / kTileLanes, tiles = (K + kTile - 1) / kTile;
  const int tile = blockIdx.x / groups, n0 = (blockIdx.x - tile * groups) * kTileLanes;
  const int i0 = tile / tiles * kTile, j0 = (tile - tile / tiles * tiles) * kTile;
  const int l = threadIdx.x % kTileLanes, g = threadIdx.x / kTileLanes;
  const int r = g / 2, c0 = g % 2;
  float m[kTile / 2], sum[kTile / 2];
#pragma unroll
  for (int c = 0; c < kTile / 2; ++c) m[c] = -INFINITY, sum[c] = 0.0f;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < K; k0 += kTile) {
      __syncthreads();  // the previous tiles consumed
      for (int e = threadIdx.x; e < kTile * kTile * kTileLanes; e += kTileThreads) {
        const int ll = e % kTileLanes, q = e / kTileLanes, x = q / kTile, y = q % kTile;
        const int n = n0 + ll;
        as[x][y][ll] = n < N && i0 + x < K && k0 + y < K
                           ? a[(static_cast<size_t>(i0 + x) * K + k0 + y) * N + n]
                           : -INFINITY;
        bs[x][y][ll] = n < N && k0 + x < K && j0 + y < K
                           ? b[(static_cast<size_t>(k0 + x) * K + j0 + y) * N + n]
                           : -INFINITY;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        const float av = as[r][k][l];
#pragma unroll
        for (int c = 0; c < kTile / 2; ++c) {
          const float x = av + bs[k][2 * c + c0][l];
          if (pass == 0)
            m[c] = fmaxf(m[c], x);
          else
            sum[c] += expf(x - m[c]);
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int c = 0; c < kTile / 2; ++c)
        if (!isfinite(m[c])) m[c] = 0.0f;
    }
  }
  const int n = n0 + l, i = i0 + r;
  if (n >= N || i >= K) return;
#pragma unroll
  for (int c = 0; c < kTile / 2; ++c) {
    const int jj = j0 + 2 * c + c0;
    if (jj < K) dst[(static_cast<size_t>(i) * K + jj) * N + n] = m[c] + logf(sum[c]);
  }
}

// K > 32, grid (tiles x lane groups, C): step s >= 1 of every chunk's walk.
__global__ void __launch_bounds__(kTileThreads)
logsemiring_generic_step_kernel(const float* __restrict__ M, float* __restrict__ out, int T,
                                int K, int N, int L, int offset, int s, int reverse) {
  int begin, end;
  chunk_rows(blockIdx.y, T, L, offset, begin, end);
  if (s >= end - begin) return;
  const size_t plane = static_cast<size_t>(K) * K * N;  // one (K, K, N) matrix
  const int t = reverse ? end - 1 - s : begin + s;
  const int prev = reverse ? t + 1 : t - 1;
  if (reverse)
    tile_product(M + t * plane, out + prev * plane, out + t * plane, K, N);
  else
    tile_product(out + prev * plane, M + t * plane, out + t * plane, K, N);
}

// K > 32, grid tiles x lane groups: dst = a (x) b.
__global__ void __launch_bounds__(kTileThreads)
logsemiring_generic_product_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ dst, int K, int N) {
  tile_product(a, b, dst, K, N);
}

int launch_generic(const float* M, float* out, float* totals, int T, int K, int N, int C, int L,
                   int offset, int reverse, cudaStream_t stream) {
  const size_t plane = static_cast<size_t>(K) * K * N;
  const long long tiles = (K + kTile - 1) / kTile;
  const long long blocks = tiles * tiles * ((N + kTileLanes - 1) / kTileLanes);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), C);
  auto copy = [&](float* to, const float* from) {
    return cudaMemcpyAsync(to, from, plane * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  };
  // phase 1: each chunk's first row in chain order is its first prefix
  for (int c = 0; c < C; ++c) {
    const int first = reverse ? min((c + 1) * L + offset, T) - 1 : max(c * L + offset, 0);
    const cudaError_t err = copy(out + first * plane, M + first * plane);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int s = 1; s < L; ++s)
    logsemiring_generic_step_kernel<<<grid, kTileThreads, 0, stream>>>(M, out, T, K, N, L,
                                                                       offset, s, reverse);
  // phases 2-3, chunk by chunk in chain order
  for (int step = 1; step < C; ++step) {
    const int c = reverse ? C - 1 - step : step;
    const int begin = max(c * L + offset, 0), end = min((c + 1) * L + offset, T);
    const float* carry = out + (reverse ? end : begin - 1) * plane;
    for (int t = begin; t < end; ++t) {
      float* row = out + t * plane;
      if (reverse)
        logsemiring_generic_product_kernel<<<grid.x, kTileThreads, 0, stream>>>(row, carry,
                                                                               totals, K, N);
      else
        logsemiring_generic_product_kernel<<<grid.x, kTileThreads, 0, stream>>>(carry, row,
                                                                               totals, K, N);
      const cudaError_t err = copy(row, totals);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int kFixRows = 4;  // rows of a chunk per fix-up block

template <int KP>
int launch(const float* M, float* out, float* totals, int T, int K, int N, int C, int L,
           int offset, int reverse, cudaStream_t stream) {
  constexpr int lanes = Rung<KP>::kLanes;
  const int threads = lanes * ((K * K + Rung<KP>::kEpt - 1) / Rung<KP>::kEpt);
  const size_t bytes = sizeof(float) * (2 + Rung<KP>::kStages) * KP * KP * lanes;
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(logsemiring_scan_kernel<KP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    cudaFuncSetAttribute(logsemiring_fixup_kernel<KP>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  }
  const int blocks = (N + lanes - 1) / lanes;
  logsemiring_scan_kernel<KP><<<dim3(blocks, C), threads, bytes, stream>>>(
      M, out, totals, T, K, N, L, offset, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  const int groups = (L + kFixRows - 1) / kFixRows;
  logsemiring_fixup_kernel<KP><<<dim3(blocks, C, groups), threads, bytes, stream>>>(
      out, totals, T, K, N, L, offset, C, kFixRows, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One-pass scan: C = 1, L = T, offset = 0, totals may be NULL.  Time fold:
// C > 1 chunks of L rows (C L >= T, every chunk non-empty), offset as above,
// totals a (C, K, K, N) scratch array.  Any K >= 1.  Returns 0 on a clean
// launch, the cudaGetLastError() code otherwise, and cudaErrorInvalidValue
// for K < 1 or a fold without totals (the Python wrapper checks both first).
extern "C" int logsemiring_scan_f32(const void* M, void* out, void* totals, int T, int K, int N,
                                    int C, int L, int offset, int reverse, void* stream) {
  if ((C > 1 && totals == nullptr) || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* m = static_cast<const float*>(M);
  float* o = static_cast<float*>(out);
  float* tot = static_cast<float*>(totals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 4) return launch<4>(m, o, tot, T, K, N, C, L, offset, reverse, s);
  if (K <= 8) return launch<8>(m, o, tot, T, K, N, C, L, offset, reverse, s);
  if (K <= 16) return launch<16>(m, o, tot, T, K, N, C, L, offset, reverse, s);
  if (K <= 32) return launch<32>(m, o, tot, T, K, N, C, L, offset, reverse, s);
  return launch_generic(m, o, tot, T, K, N, C, L, offset, reverse, s);
}
