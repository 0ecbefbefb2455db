// Inclusive scan of the (log, +) matrix semiring over time, one thread per
// batch lane.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call with the combine
// pyvbmp_tpu/ops/parallel_hmm.py:_logmatmul_plane: the prefix and suffix
// scans of the role-chain forward-backward (_hmm_plane_core).
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
// What bounds it on an H100: at DMBD-Lorenz (T=399, K=4, N=300) one scan
// reads and writes 2 * 399*16*300*4 B = 7.7 MB, a few microseconds at
// 3.35 TB/s.  The bound is the serial walk of T-1 dependent combines (K^3
// exp, K^2 log each) on N threads, which fill a few warps.  The design keeps
// the carry in registers and reads each element once; making the walk
// parallel in T (an in-kernel chunked scan) is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;

template <int K>
__device__ __forceinline__ void logmatmul(const float (&a)[K][K],
                                          const float (&b)[K][K],
                                          float (&out)[K][K]) {
#pragma unroll
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
__global__ void __launch_bounds__(kThreads)
logsemiring_scan_kernel(const float* __restrict__ M, float* __restrict__ out,
                        int T, int N, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t step = static_cast<size_t>(K) * K * N;
  float carry[K][K], e[K][K], next[K][K];
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* src = M + t * step + n;
    float* dst = out + t * step + n;
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) e[i][j] = src[(i * K + j) * N];
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) carry[i][j] = e[i][j];
    } else {
      if (reverse)
        logmatmul<K>(e, carry, next);
      else
        logmatmul<K>(carry, e, next);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j) carry[i][j] = next[i][j];
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j) dst[(i * K + j) * N] = carry[i][j];
  }
}

template <int K>
void launch(const float* M, float* out, int T, int N, int reverse,
            cudaStream_t stream) {
  const int blocks = (N + kThreads - 1) / kThreads;
  logsemiring_scan_kernel<K><<<blocks, kThreads, 0, stream>>>(M, out, T, N,
                                                              reverse);
}

}  // namespace

// Returns 0 on a clean launch, the cudaGetLastError() code otherwise, and
// cudaErrorInvalidValue for a K that is not instantiated (the Python wrapper
// checks K first).
extern "C" int logsemiring_scan_f32(const void* M, void* out, int T, int K,
                                    int N, int reverse, void* stream) {
  const float* m = static_cast<const float*>(M);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: launch<4>(m, o, T, N, reverse, s); break;
    case 7: launch<7>(m, o, T, N, reverse, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
