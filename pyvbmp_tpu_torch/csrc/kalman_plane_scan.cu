// Inclusive scan of Gaussian pair potentials over time, one thread per batch
// lane.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call with the combine
// pyvbmp_tpu/ops/parallel_kalman.py:_combine_plane: the prefix and suffix
// scans of the log-depth Kalman smoother (_plane_smoother).
//
// An element is the potential
//   phi(a, b) = exp(-1/2 a'Jaa a - a'Jab b - 1/2 b'Jbb b + ha'a + hb'b + logw)
// stored in plane layout: Jaa, Jab, Jbb as (T, H, H, N), ha, hb as (T, H, N),
// logw as (T, N), float32, contiguous, batch lane n minor.  The combine
// e1 o e2 integrates out the shared middle variable; with
// M = J1bb + J2aa = L L' (Cholesky), A = L^-1 J1ab', B = L^-1 J2ab and
// c = L^-1 (h1b + h2a):
//   Jaa = J1aa - A'A      Jbb = J2bb - B'B      Jab = -A'B
//   ha  = h1a - A'c       hb  = h2b - B'c
//   logw = w1 + w2 + c'c/2 - sum_i log L_ii + H/2 log(2 pi)
// which is _combine_plane's algebra with M^-1 split into its Cholesky
// factors (the TPU used a Schur split only to suit its layout).
//   forward: out[t] = e[0] o ... o e[t]
//   reverse: out[t] = e[t] o ... o e[T-1]
//
// What bounds it on an H100: at DMBD-Lorenz (H=6, T=399, N=100) one scan
// reads each element once and writes each prefix once, 121*4 B * 100 * 399
// = 19 MB each way, a few microseconds at 3.35 TB/s.  The bound is the
// serial walk of T-1 dependent combines (an HxH Cholesky, 2H+1 triangular
// solves and three H^3 products each) on N = 100 threads: four warps.  The carry (3H^2 + 2H + 1 = 121
// floats at H=6) lives in registers and local memory; the combine writes its
// result in place over the carry.  Making the walk parallel in T is later
// work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr float kLog2Pi = 1.8378770664093453f;

template <int H>
struct Potential {
  float Jaa[H][H];
  float Jab[H][H];
  float Jbb[H][H];
  float ha[H];
  float hb[H];
  float w;
};

struct Planes {
  const float* Jaa;
  const float* Jab;
  const float* Jbb;
  const float* ha;
  const float* hb;
  const float* w;
};

struct OutPlanes {
  float* Jaa;
  float* Jab;
  float* Jbb;
  float* ha;
  float* hb;
  float* w;
};

template <int H>
__device__ __forceinline__ void load(Potential<H>& p, const Planes& src,
                                     int t, int N, int n) {
  const size_t mat = static_cast<size_t>(t) * H * H * N + n;
  const size_t vec = static_cast<size_t>(t) * H * N + n;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const size_t o = mat + static_cast<size_t>(i * H + j) * N;
      p.Jaa[i][j] = src.Jaa[o];
      p.Jab[i][j] = src.Jab[o];
      p.Jbb[i][j] = src.Jbb[o];
    }
    p.ha[i] = src.ha[vec + static_cast<size_t>(i) * N];
    p.hb[i] = src.hb[vec + static_cast<size_t>(i) * N];
  }
  p.w = src.w[static_cast<size_t>(t) * N + n];
}

template <int H>
__device__ __forceinline__ void store(const Potential<H>& p,
                                      const OutPlanes& dst, int t, int N,
                                      int n) {
  const size_t mat = static_cast<size_t>(t) * H * H * N + n;
  const size_t vec = static_cast<size_t>(t) * H * N + n;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const size_t o = mat + static_cast<size_t>(i * H + j) * N;
      dst.Jaa[o] = p.Jaa[i][j];
      dst.Jab[o] = p.Jab[i][j];
      dst.Jbb[o] = p.Jbb[i][j];
    }
    dst.ha[vec + static_cast<size_t>(i) * N] = p.ha[i];
    dst.hb[vec + static_cast<size_t>(i) * N] = p.hb[i];
  }
  dst.w[static_cast<size_t>(t) * N + n] = p.w;
}

// out = e1 o e2.  `out` may be the same object as e1 or e2: every input
// entry that an output entry overwrites is read before the write (M, A, B
// and c consume J1bb, J2aa, J1ab, J2ab, h1b, h2a first; the remaining
// outputs read only the same entry of the input they replace).
template <int H>
__device__ __forceinline__ void combine(const Potential<H>& e1,
                                        const Potential<H>& e2,
                                        Potential<H>& out) {
  // Cholesky of M = J1bb + J2aa, lower triangle, in place.
  float L[H][H];
#pragma unroll
  for (int i = 0; i < H; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = e1.Jbb[i][j] + e2.Jaa[i][j];
  float half_logdet = 0.0f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float d = L[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
    d = sqrtf(d);
    L[j][j] = d;
    half_logdet += logf(d);
    const float inv = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < H; ++i) {
      float v = L[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
      L[i][j] = v * inv;
    }
  }
  // Forward substitution: A[:, c] = L^-1 J1ab[c, :]', B[:, c] = L^-1 J2ab[:, c],
  // cv = L^-1 (h1b + h2a).
  float A[H][H], B[H][H], cv[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float inv = 1.0f / L[i][i];
#pragma unroll
    for (int c = 0; c < H; ++c) {
      float a = e1.Jab[c][i];
      float b = e2.Jab[i][c];
#pragma unroll
      for (int k = 0; k < i; ++k) {
        a -= L[i][k] * A[k][c];
        b -= L[i][k] * B[k][c];
      }
      A[i][c] = a * inv;
      B[i][c] = b * inv;
    }
    float v = e1.hb[i] + e2.ha[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= L[i][k] * cv[k];
    cv[i] = v * inv;
  }
  float cc = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) cc += cv[k] * cv[k];
  const float w = e1.w + e2.w + 0.5f * cc - half_logdet + 0.5f * H * kLog2Pi;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float aa = 0.0f, bb = 0.0f, ab = 0.0f;
#pragma unroll
      for (int k = 0; k < H; ++k) {
        aa += A[k][i] * A[k][j];
        bb += B[k][i] * B[k][j];
        ab += A[k][i] * B[k][j];
      }
      out.Jaa[i][j] = e1.Jaa[i][j] - aa;
      out.Jbb[i][j] = e2.Jbb[i][j] - bb;
      out.Jab[i][j] = -ab;
    }
    float ac = 0.0f, bc = 0.0f;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      ac += A[k][i] * cv[k];
      bc += B[k][i] * cv[k];
    }
    out.ha[i] = e1.ha[i] - ac;
    out.hb[i] = e2.hb[i] - bc;
  }
  out.w = w;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
kalman_plane_scan_kernel(Planes in, OutPlanes out, int T, int N,
                         int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  Potential<H> carry, e;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    if (s == 0) {
      load<H>(carry, in, t, N, n);
    } else {
      load<H>(e, in, t, N, n);
      if (reverse)
        combine<H>(e, carry, carry);
      else
        combine<H>(carry, e, carry);
    }
    store<H>(carry, out, t, N, n);
  }
}

template <int H>
void launch(const void* const* in, void* const* out, int T, int N,
            int reverse, cudaStream_t stream) {
  Planes src{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
             static_cast<const float*>(in[4]), static_cast<const float*>(in[5])};
  OutPlanes dst{static_cast<float*>(out[0]), static_cast<float*>(out[1]),
                static_cast<float*>(out[2]), static_cast<float*>(out[3]),
                static_cast<float*>(out[4]), static_cast<float*>(out[5])};
  const int blocks = (N + kThreads - 1) / kThreads;
  kalman_plane_scan_kernel<H><<<blocks, kThreads, 0, stream>>>(src, dst, T, N,
                                                               reverse);
}

}  // namespace

// Inputs and outputs in the order Jaa, Jab, Jbb, ha, hb, logw.  Returns 0 on
// a clean launch, the cudaGetLastError() code otherwise, and
// cudaErrorInvalidValue for an H that is not instantiated (the Python
// wrapper checks H first).
extern "C" int kalman_plane_scan_f32(
    const void* Jaa, const void* Jab, const void* Jbb, const void* ha,
    const void* hb, const void* logw, void* oJaa, void* oJab, void* oJbb,
    void* oha, void* ohb, void* ologw, int T, int H, int N, int reverse,
    void* stream) {
  const void* in[6] = {Jaa, Jab, Jbb, ha, hb, logw};
  void* out[6] = {oJaa, oJab, oJbb, oha, ohb, ologw};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 6: launch<6>(in, out, T, N, reverse, s); break;
    case 10: launch<10>(in, out, T, N, reverse, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
