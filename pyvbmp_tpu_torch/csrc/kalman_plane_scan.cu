// Inclusive scan of Gaussian pair potentials over time, one thread per batch
// lane, walked in one pass or folded into time chunks.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call (one pass) and
// pyvbmp_tpu/ops/pallas_scan.py:_build_folded_call (the time fold) with the
// combine pyvbmp_tpu/ops/parallel_kalman.py:_combine_plane: the prefix and
// suffix scans of the log-depth Kalman smoother (_plane_smoother).
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
// The time fold (C > 1) is the three-phase block scan.  Chunk c holds rows
// [c L + offset, (c + 1) L + offset) clipped to [0, T); offset is 0 forward
// and C L - T rows to the left in reverse, so the one short chunk is the one
// whose total no other chunk needs.
//   kalman_plane_scan_kernel, grid (lane blocks, C): phase 1, the in-chunk
//     inclusive scan, and each chunk's total into the totals planes (C, ...);
//   kalman_plane_fixup_kernel, grid (lane blocks, C): phases 2-3 fused.
//     Each chunk folds the totals of the chunks before it (after it, in
//     reverse) into its carry-in and combines it with each of its rows in
//     place.
// The one-pass scan is C = 1, L = T: phase 1 alone.
//
// What bounds it on an H100: at DMBD-Lorenz (H=6, T=399, N=100) one scan
// reads each element once and writes each prefix once, 121*4 B * 100 * 399
// = 19 MB each way, a few microseconds at 3.35 TB/s.  The bound is the
// serial walk of dependent combines (an HxH Cholesky, 2H+1 triangular solves
// and three H^3 products each) on N = 100 threads: four warps.  The fold
// cuts the walk from T steps to L + (C - 1) + L and spreads the lanes over C
// times as many warps.  At H <= 10 the carry (3H^2 + 2H + 1 = 121 floats at
// H=6) lives in registers and local memory and the combine is fully
// unrolled.  At H = 14 (Flocking, three objects) the carry is 617 floats and
// the combine's factors another 600: everything lives in local memory, so
// the combine's outer loops stay rolled and it is one out-of-line function
// shared by every call site, which keeps compile time and code size in
// bounds.  The fix-up kernel (off the one-pass path) calls the out-of-line
// combine at every H for the same reason.
// The combine writes its result in place over either operand.

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

__host__ __device__ inline Planes readable(const OutPlanes& p) {
  return Planes{p.Jaa, p.Jab, p.Jbb, p.ha, p.hb, p.w};
}

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
// outputs read only the same entry of the input they replace).  The outer
// loops are unrolled up to H = 10.
template <int H>
__device__ __forceinline__ void combine_body(const Potential<H>& e1,
                                             const Potential<H>& e2,
                                             Potential<H>& out) {
  // Cholesky of M = J1bb + J2aa, lower triangle, in place.
  float L[H][H];
#pragma unroll (H <= 10 ? H : 1)
  for (int i = 0; i < H; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) L[i][j] = e1.Jbb[i][j] + e2.Jaa[i][j];
  float half_logdet = 0.0f;
#pragma unroll (H <= 10 ? H : 1)
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
#pragma unroll (H <= 10 ? H : 1)
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
#pragma unroll (H <= 10 ? H : 1)
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
__device__ __noinline__ void combine_outlined(const Potential<H>& e1,
                                              const Potential<H>& e2,
                                              Potential<H>& out) {
  combine_body<H>(e1, e2, out);
}

template <int H>
__device__ __forceinline__ void combine(const Potential<H>& e1,
                                        const Potential<H>& e2,
                                        Potential<H>& out) {
  if constexpr (H <= 10)
    combine_body<H>(e1, e2, out);
  else
    combine_outlined<H>(e1, e2, out);
}

// The rows [begin, end) of this block's chunk.
__device__ __forceinline__ void chunk_rows(int T, int L, int offset,
                                           int& begin, int& end) {
  const int c = blockIdx.y;
  begin = max(c * L + offset, 0);
  end = min((c + 1) * L + offset, T);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
kalman_plane_scan_kernel(Planes in, OutPlanes out, OutPlanes totals, int T,
                         int N, int L, int offset, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  Potential<H> carry, e;
  for (int s = 0; s < end - begin; ++s) {
    const int t = reverse ? end - 1 - s : begin + s;
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
  if (totals.w != nullptr) store<H>(carry, totals, blockIdx.y, N, n);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
kalman_plane_fixup_kernel(OutPlanes out, Planes totals, int T, int N, int L,
                          int offset, int C, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (n >= N || c == (reverse ? C - 1 : 0)) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  Potential<H> acc, e;
  // phase 2: acc = totals[0] o ... o totals[c-1], or in reverse
  // totals[c+1] o ... o totals[C-1]
  load<H>(acc, totals, reverse ? C - 1 : 0, N, n);
  const int before = reverse ? C - 1 - c : c;
  for (int s = 1; s < before; ++s) {
    load<H>(e, totals, reverse ? C - 1 - s : s, N, n);
    if (reverse)
      combine_outlined<H>(e, acc, acc);
    else
      combine_outlined<H>(acc, e, acc);
  }
  // phase 3: every row of the chunk takes the carry-in
  const Planes rows = readable(out);
  for (int t = begin; t < end; ++t) {
    load<H>(e, rows, t, N, n);
    if (reverse)
      combine_outlined<H>(e, acc, e);
    else
      combine_outlined<H>(acc, e, e);
    store<H>(e, out, t, N, n);
  }
}

OutPlanes out_planes(void* const* p) {
  return OutPlanes{static_cast<float*>(p[0]), static_cast<float*>(p[1]),
                   static_cast<float*>(p[2]), static_cast<float*>(p[3]),
                   static_cast<float*>(p[4]), static_cast<float*>(p[5])};
}

template <int H>
int launch(const void* const* in, void* const* out, void* const* totals,
           int T, int N, int C, int L, int offset, int reverse,
           cudaStream_t stream) {
  Planes src{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
             static_cast<const float*>(in[4]), static_cast<const float*>(in[5])};
  const OutPlanes dst = out_planes(out);
  const OutPlanes tot = out_planes(totals);
  const dim3 grid((N + kThreads - 1) / kThreads, C);
  kalman_plane_scan_kernel<H><<<grid, kThreads, 0, stream>>>(
      src, dst, tot, T, N, L, offset, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  kalman_plane_fixup_kernel<H><<<grid, kThreads, 0, stream>>>(
      dst, readable(tot), T, N, L, offset, C, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs, outputs and totals in the order Jaa, Jab, Jbb, ha, hb, logw.
// One-pass scan: C = 1, L = T, offset = 0, totals may be NULL.  Time fold:
// C > 1 chunks of L rows (C L >= T, every chunk non-empty), offset as above,
// totals (C, ...) scratch planes.  Returns 0 on a clean launch, the
// cudaGetLastError() code otherwise, and cudaErrorInvalidValue for an H that
// is not instantiated or a fold without totals (the Python wrapper checks
// both first).
extern "C" int kalman_plane_scan_f32(
    const void* Jaa, const void* Jab, const void* Jbb, const void* ha,
    const void* hb, const void* logw, void* oJaa, void* oJab, void* oJbb,
    void* oha, void* ohb, void* ologw, void* tJaa, void* tJab, void* tJbb,
    void* tha, void* thb, void* tlogw, int T, int H, int N, int C, int L,
    int offset, int reverse, void* stream) {
  const void* in[6] = {Jaa, Jab, Jbb, ha, hb, logw};
  void* out[6] = {oJaa, oJab, oJbb, oha, ohb, ologw};
  void* tot[6] = {tJaa, tJab, tJbb, tha, thb, tlogw};
  if (C > 1)
    for (void* p : tot)
      if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 6: return launch<6>(in, out, tot, T, N, C, L, offset, reverse, s);
    case 10: return launch<10>(in, out, tot, T, N, C, L, offset, reverse, s);
    case 14: return launch<14>(in, out, tot, T, N, C, L, offset, reverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
