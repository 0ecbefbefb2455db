// Inclusive scan of Gaussian pair potentials over time in component ("lane")
// form, one thread per batch lane, for hidden dims H = 1, 2, 3.
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call with the combine
// pyvbmp_tpu/ops/parallel_kalman.py:_combine_lane: the prefix and suffix
// scans of the log-depth Kalman smoother at h <= 3 (_lane_smoother), the
// latent chain of LinearDynamicalSystems and MixtureofLinearDynamicalSystems.
//
// An element is the potential
//   phi(a, b) = exp(-1/2 a'Jaa a - a'Jab b - 1/2 b'Jbb b + ha'a + hb'b + logw)
// packed by components (pyvbmp_tpu_torch/ops/smallmat.py), float32,
// contiguous, batch lane n minor:
//   Jaa, Jbb  (T, H(H+1)/2, N)  upper triangle, row-major
//   Jab       (T, H*H, N)       row-major
//   ha, hb    (T, H, N)
//   logw      (T, N)
// The combine e1 o e2 integrates out the shared middle variable with the
// closed-form adjugate inverse of M = J1bb + J2aa, in _combine_lane's order
// of operations; the symmetric outputs keep the upper triangle only:
//   Jaa = J1aa - J1ab M^-1 J1ab'     Jbb = J2bb - J2ab' M^-1 J2ab
//   Jab = -J1ab M^-1 J2ab
//   ha  = h1a - J1ab M^-1 m          hb  = h2b - J2ab' M^-1 m,  m = h1b + h2a
//   logw = w1 + w2 + m'M^-1 m/2 - log|M|/2 + H/2 log(2 pi)
//   forward: out[t] = e[0] o ... o e[t]
//   reverse: out[t] = e[t] o ... o e[T-1]   (walked t = T-1..0, e_t o carry)
//
// The time fold (C > 1; pyvbmp_tpu/ops/pallas_scan.py:_build_folded_call)
// is the three-phase block scan.  Chunk c holds rows [c L + offset,
// (c + 1) L + offset) clipped to [0, T); offset is 0 forward and C L - T rows
// to the left in reverse, so the one short chunk is the one whose total no
// other chunk needs.  kalman_lane_scan_kernel (grid (lane blocks, C)) runs
// phase 1 and writes each chunk's total; kalman_lane_fixup_kernel runs
// phases 2-3: each chunk folds the totals before it (after it, in reverse)
// into its carry-in and combines it with each of its rows in place.  The
// one-pass scan is C = 1, L = T.
//
// What bounds it on an H100: at the MixLDS bench shape (H=2, T=100,
// N=4000) one scan reads each element once and writes each prefix once,
// 15 floats * 4 B * 4000 * 100 = 24 MB each way, ~15 us at 3.35 TB/s.  The
// bound is the serial walk of T-1 dependent combines per lane.  The carry
// (15 floats at H=2, 28 at H=3) lives in registers, and the next element is
// loaded while the current one is combined.  Blocks of one warp spread the
// 4000 lanes over ~125 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;
constexpr float kLog2Pi = 1.8378770664093453f;

// Position of entry (i, j) (either triangle) of a packed symmetric matrix.
__host__ __device__ constexpr int sym_pos(int h, int i, int j) {
  return i <= j ? i * h - i * (i - 1) / 2 + (j - i)
                : j * h - j * (j - 1) / 2 + (i - j);
}

template <int H>
struct Potential {
  static constexpr int S = H * (H + 1) / 2;
  float Jaa[S];
  float Jab[H * H];
  float Jbb[S];
  float ha[H];
  float hb[H];
  float w;
};

struct Leaves {
  const float* Jaa;
  const float* Jab;
  const float* Jbb;
  const float* ha;
  const float* hb;
  const float* w;
};

struct OutLeaves {
  float* Jaa;
  float* Jab;
  float* Jbb;
  float* ha;
  float* hb;
  float* w;
};

// Offset of component k of a (T, C, N) leaf at time t, lane n.
__device__ __forceinline__ size_t at(int t, int C, int k, int N, int n) {
  return (static_cast<size_t>(t) * C + k) * N + n;
}

template <int H>
__device__ __forceinline__ void load(Potential<H>& p, const Leaves& src, int t,
                                     int N, int n) {
  constexpr int S = Potential<H>::S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    p.Jaa[k] = src.Jaa[at(t, S, k, N, n)];
    p.Jbb[k] = src.Jbb[at(t, S, k, N, n)];
  }
#pragma unroll
  for (int k = 0; k < H * H; ++k) p.Jab[k] = src.Jab[at(t, H * H, k, N, n)];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    p.ha[k] = src.ha[at(t, H, k, N, n)];
    p.hb[k] = src.hb[at(t, H, k, N, n)];
  }
  p.w = src.w[at(t, 1, 0, N, n)];
}

template <int H>
__device__ __forceinline__ void store(const Potential<H>& p,
                                      const OutLeaves& dst, int t, int N,
                                      int n) {
  constexpr int S = Potential<H>::S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    dst.Jaa[at(t, S, k, N, n)] = p.Jaa[k];
    dst.Jbb[at(t, S, k, N, n)] = p.Jbb[k];
  }
#pragma unroll
  for (int k = 0; k < H * H; ++k) dst.Jab[at(t, H * H, k, N, n)] = p.Jab[k];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    dst.ha[at(t, H, k, N, n)] = p.ha[k];
    dst.hb[at(t, H, k, N, n)] = p.hb[k];
  }
  dst.w[at(t, 1, 0, N, n)] = p.w;
}

// Inverse (packed upper triangle) and logdet of a packed symmetric PD
// matrix: the adjugate of smallmat.sym_inv_and_logdet.
template <int H>
__device__ __forceinline__ float sym_inv(const float* A, float* inv) {
  if constexpr (H == 1) {
    const float det = A[0];
    inv[0] = 1.0f / det;
    return logf(det);
  } else if constexpr (H == 2) {
    const float a = A[0], b = A[1], d = A[2];
    const float det = a * d - b * b;
    inv[0] = d / det;
    inv[1] = -b / det;
    inv[2] = a / det;
    return logf(det);
  } else {
    const float a = A[0], b = A[1], c = A[2], e = A[3], f = A[4], i = A[5];
    const float A11 = e * i - f * f;
    const float A12 = -(b * i - c * f);
    const float A13 = b * f - c * e;
    const float A22 = a * i - c * c;
    const float A23 = -(a * f - c * b);
    const float A33 = a * e - b * b;
    const float det = a * A11 + b * A12 + c * A13;
    inv[0] = A11 / det;
    inv[1] = A12 / det;
    inv[2] = A13 / det;
    inv[3] = A22 / det;
    inv[4] = A23 / det;
    inv[5] = A33 / det;
    return logf(det);
  }
}

template <int H>
__device__ __forceinline__ Potential<H> combine(const Potential<H>& e1,
                                                const Potential<H>& e2) {
  constexpr int S = Potential<H>::S;
  float M[S], Minv[S], hmid[H];
#pragma unroll
  for (int k = 0; k < S; ++k) M[k] = e1.Jbb[k] + e2.Jaa[k];
#pragma unroll
  for (int k = 0; k < H; ++k) hmid[k] = e1.hb[k] + e2.ha[k];
  const float logdetM = sym_inv<H>(M, Minv);

  // Minv J1ab', Minv J2ab (general, row-major) and Minv m.
  float MJ1[H * H], MJ2[H * H], Mh[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        s1 += Minv[sym_pos(H, i, m)] * e1.Jab[j * H + m];
        s2 += Minv[sym_pos(H, i, m)] * e2.Jab[m * H + j];
      }
      MJ1[i * H + j] = s1;
      MJ2[i * H + j] = s2;
    }
    float sh = 0.0f;
#pragma unroll
    for (int m = 0; m < H; ++m) sh += Minv[sym_pos(H, i, m)] * hmid[m];
    Mh[i] = sh;
  }

  Potential<H> out;
#pragma unroll
  for (int i = 0; i < H; ++i) {
#pragma unroll
    for (int j = i; j < H; ++j) {
      float aa = 0.0f, bb = 0.0f;
#pragma unroll
      for (int m = 0; m < H; ++m) {
        aa += e1.Jab[i * H + m] * MJ1[m * H + j];
        bb += e2.Jab[m * H + i] * MJ2[m * H + j];
      }
      out.Jaa[sym_pos(H, i, j)] = e1.Jaa[sym_pos(H, i, j)] - aa;
      out.Jbb[sym_pos(H, i, j)] = e2.Jbb[sym_pos(H, i, j)] - bb;
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float ab = 0.0f;
#pragma unroll
      for (int m = 0; m < H; ++m) ab += e1.Jab[i * H + m] * MJ2[m * H + j];
      out.Jab[i * H + j] = -ab;
    }
    float ah = 0.0f, bh = 0.0f;
#pragma unroll
    for (int m = 0; m < H; ++m) {
      ah += e1.Jab[i * H + m] * Mh[m];
      bh += e2.Jab[m * H + i] * Mh[m];
    }
    out.ha[i] = e1.ha[i] - ah;
    out.hb[i] = e2.hb[i] - bh;
  }
  float hMh = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) hMh += hmid[k] * Mh[k];
  out.w = e1.w + e2.w + 0.5f * hMh - 0.5f * logdetM + 0.5f * H * kLog2Pi;
  return out;
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
kalman_lane_scan_kernel(Leaves in, OutLeaves out, OutLeaves totals, int T,
                        int N, int L, int offset, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  const int len = end - begin;
  auto row = [&](int s) { return reverse ? end - 1 - s : begin + s; };
  Potential<H> carry, next;
  load<H>(carry, in, row(0), N, n);
  store<H>(carry, out, row(0), N, n);
  if (len > 1) load<H>(next, in, row(1), N, n);
  for (int s = 1; s < len; ++s) {
    const Potential<H> e = next;
    if (s + 1 < len) load<H>(next, in, row(s + 1), N, n);
    carry = reverse ? combine<H>(e, carry) : combine<H>(carry, e);
    store<H>(carry, out, row(s), N, n);
  }
  if (totals.w != nullptr) store<H>(carry, totals, blockIdx.y, N, n);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
kalman_lane_fixup_kernel(OutLeaves out, Leaves totals, int T, int N, int L,
                         int offset, int C, int reverse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (n >= N || c == (reverse ? C - 1 : 0)) return;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  // phase 2: acc = totals[0] o ... o totals[c-1], or in reverse
  // totals[c+1] o ... o totals[C-1]
  Potential<H> acc, e;
  load<H>(acc, totals, reverse ? C - 1 : 0, N, n);
  const int before = reverse ? C - 1 - c : c;
  for (int s = 1; s < before; ++s) {
    load<H>(e, totals, reverse ? C - 1 - s : s, N, n);
    acc = reverse ? combine<H>(e, acc) : combine<H>(acc, e);
  }
  // phase 3: every row of the chunk takes the carry-in
  const Leaves rows{out.Jaa, out.Jab, out.Jbb, out.ha, out.hb, out.w};
  for (int t = begin; t < end; ++t) {
    load<H>(e, rows, t, N, n);
    store<H>(reverse ? combine<H>(e, acc) : combine<H>(acc, e), out, t, N, n);
  }
}

OutLeaves out_leaves(void* const* p) {
  return OutLeaves{static_cast<float*>(p[0]), static_cast<float*>(p[1]),
                   static_cast<float*>(p[2]), static_cast<float*>(p[3]),
                   static_cast<float*>(p[4]), static_cast<float*>(p[5])};
}

template <int H>
int launch(const void* const* in, void* const* out, void* const* totals,
           int T, int N, int C, int L, int offset, int reverse,
           cudaStream_t stream) {
  Leaves src{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
             static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
             static_cast<const float*>(in[4]), static_cast<const float*>(in[5])};
  const OutLeaves dst = out_leaves(out);
  const OutLeaves tot = out_leaves(totals);
  const dim3 grid((N + kThreads - 1) / kThreads, C);
  kalman_lane_scan_kernel<H><<<grid, kThreads, 0, stream>>>(
      src, dst, tot, T, N, L, offset, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  const Leaves tot_in{tot.Jaa, tot.Jab, tot.Jbb, tot.ha, tot.hb, tot.w};
  kalman_lane_fixup_kernel<H><<<grid, kThreads, 0, stream>>>(
      dst, tot_in, T, N, L, offset, C, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs, outputs and totals in the order Jaa, Jab, Jbb, ha, hb, logw.
// One-pass scan: C = 1, L = T, offset = 0, totals may be NULL.  Time fold:
// C > 1 chunks of L rows (C L >= T, every chunk non-empty), offset as above,
// totals (C, ...) scratch leaves.  Returns 0 on a clean launch, the
// cudaGetLastError() code otherwise, and cudaErrorInvalidValue for an H that
// is not instantiated or a fold without totals (the Python wrapper checks
// both first).
extern "C" int kalman_lane_scan_f32(
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
    case 1: return launch<1>(in, out, tot, T, N, C, L, offset, reverse, s);
    case 2: return launch<2>(in, out, tot, T, N, C, L, offset, reverse, s);
    case 3: return launch<3>(in, out, tot, T, N, C, L, offset, reverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
