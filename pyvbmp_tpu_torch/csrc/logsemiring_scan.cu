// Inclusive scan of the (log, +) matrix semiring over time, one thread per
// batch lane, walked in one pass or folded into time chunks.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call (one pass) and
// pyvbmp_tpu/ops/pallas_scan.py:_build_folded_call (the time fold) with the
// combine pyvbmp_tpu/ops/parallel_hmm.py:_logmatmul_plane: the prefix and
// suffix scans of the role-chain forward-backward (_hmm_plane_core).
//
// Layout: M and out are (T, K, K, N) float32, contiguous, batch lane n minor,
// so the threads of a warp read and write neighbouring addresses.
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
//   logsemiring_fixup_kernel, grid (lane blocks, C): phases 2-3 fused.  Each
//     chunk folds the totals of the chunks before it (after it, in reverse)
//     into its carry-in, then combines the carry-in with each of its rows in
//     place.
// The one-pass scan is C = 1, L = T: phase 1 alone.
//
// What bounds it on an H100: at DMBD-Lorenz (T=399, K=4, N=300) one scan
// reads and writes 2 * 399*16*300*4 B = 7.7 MB, a few microseconds at
// 3.35 TB/s.  The bound is the serial walk of dependent combines (K^3 exp,
// K^2 log each) on N threads, which fill a few warps.  The fold cuts the walk
// from T steps to L + (C - 1) + L and spreads the lanes over C times as many
// warps.  At K <= 7 the carry lives in registers and the combine is fully
// unrolled; at K = 14 (Flocking, three objects) the product has 2744 terms,
// so its row loop stays rolled and it is one out-of-line function shared by
// every call site (the matrices live in local memory either way).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;

template <int K>
__device__ __forceinline__ void logmatmul_body(const float (&a)[K][K],
                                               const float (&b)[K][K],
                                               float (&out)[K][K]) {
#pragma unroll (K <= 7 ? K : 1)
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) m = fmaxf(m, a[i][k] + b[k][j]);
      if (!isfinite(m)) m = 0.0f;
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) s += expf(a[i][k] + b[k][j] - m);
      out[i][j] = m + logf(s);
    }
  }
}

template <int K>
__device__ __noinline__ void logmatmul_outlined(const float (&a)[K][K],
                                                const float (&b)[K][K],
                                                float (&out)[K][K]) {
  logmatmul_body<K>(a, b, out);
}

// out = a (x) b; out is never a or b.
template <int K>
__device__ __forceinline__ void logmatmul(const float (&a)[K][K],
                                          const float (&b)[K][K],
                                          float (&out)[K][K]) {
  if constexpr (K <= 7)
    logmatmul_body<K>(a, b, out);
  else
    logmatmul_outlined<K>(a, b, out);
}

// Matrix t of a (., K, K, N) array, lane n.
template <int K>
__device__ __forceinline__ void load(float (&x)[K][K], const float* base,
                                     int t, int N, int n) {
  const float* src = base + static_cast<size_t>(t) * K * K * N + n;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) x[i][j] = src[(i * K + j) * N];
}

template <int K>
__device__ __forceinline__ void store(const float (&x)[K][K], float* base,
                                      int t, int N, int n) {
  float* dst = base + static_cast<size_t>(t) * K * K * N + n;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) dst[(i * K + j) * N] = x[i][j];
}

template <int K>
__device__ __forceinline__ void copy(float (&dst)[K][K],
                                     const float (&src)[K][K]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) dst[i][j] = src[i][j];
}

// The rows [begin, end) of this block's chunk.
__device__ __forceinline__ void chunk_rows(int T, int L, int offset,
                                           int& begin, int& end) {
  const int c = blockIdx.y;
  begin = max(c * L + offset, 0);
  end = min((c + 1) * L + offset, T);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
logsemiring_scan_kernel(const float* __restrict__ M, float* __restrict__ out,
                        float* __restrict__ totals, int T, int N, int L,
                        int offset, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  float carry[K][K], e[K][K], next[K][K];
  for (int s = 0; s < end - begin; ++s) {
    const int t = reverse ? end - 1 - s : begin + s;
    load<K>(e, M, t, N, n);
    if (s == 0) {
      copy<K>(carry, e);
    } else {
      if (reverse)
        logmatmul<K>(e, carry, next);
      else
        logmatmul<K>(carry, e, next);
      copy<K>(carry, next);
    }
    store<K>(carry, out, t, N, n);
  }
  if (totals != nullptr) store<K>(carry, totals, blockIdx.y, N, n);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
logsemiring_fixup_kernel(float* __restrict__ out,
                         const float* __restrict__ totals, int T, int N,
                         int L, int offset, int C, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (n >= N || c == (reverse ? C - 1 : 0)) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  float acc[K][K], e[K][K], next[K][K];
  // phase 2: acc = totals[0] (x) ... (x) totals[c-1], or in reverse
  // totals[c+1] (x) ... (x) totals[C-1]
  load<K>(acc, totals, reverse ? C - 1 : 0, N, n);
  const int before = reverse ? C - 1 - c : c;
  for (int s = 1; s < before; ++s) {
    load<K>(e, totals, reverse ? C - 1 - s : s, N, n);
    if (reverse)
      logmatmul<K>(e, acc, next);
    else
      logmatmul<K>(acc, e, next);
    copy<K>(acc, next);
  }
  // phase 3: every row of the chunk takes the carry-in
  for (int t = begin; t < end; ++t) {
    load<K>(e, out, t, N, n);
    if (reverse)
      logmatmul<K>(e, acc, next);
    else
      logmatmul<K>(acc, e, next);
    store<K>(next, out, t, N, n);
  }
}

template <int K>
int launch(const float* M, float* out, float* totals, int T, int N, int C,
           int L, int offset, int reverse, cudaStream_t stream) {
  const dim3 grid((N + kThreads - 1) / kThreads, C);
  logsemiring_scan_kernel<K><<<grid, kThreads, 0, stream>>>(
      M, out, totals, T, N, L, offset, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  logsemiring_fixup_kernel<K><<<grid, kThreads, 0, stream>>>(
      out, totals, T, N, L, offset, C, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One-pass scan: C = 1, L = T, offset = 0, totals may be NULL.  Time fold:
// C > 1 chunks of L rows (C L >= T, every chunk non-empty), offset as above,
// totals a (C, K, K, N) scratch array.  Returns 0 on a clean launch, the
// cudaGetLastError() code otherwise, and cudaErrorInvalidValue for a K that
// is not instantiated or a fold without totals (the Python wrapper checks
// both first).
extern "C" int logsemiring_scan_f32(const void* M, void* out, void* totals,
                                    int T, int K, int N, int C, int L,
                                    int offset, int reverse, void* stream) {
  if (C > 1 && totals == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* m = static_cast<const float*>(M);
  float* o = static_cast<float*>(out);
  float* tot = static_cast<float*>(totals);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return launch<4>(m, o, tot, T, N, C, L, offset, reverse, s);
    case 7: return launch<7>(m, o, tot, T, N, C, L, offset, reverse, s);
    case 14: return launch<14>(m, o, tot, T, N, C, L, offset, reverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
