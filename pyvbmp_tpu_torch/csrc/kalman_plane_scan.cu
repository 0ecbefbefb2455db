// Inclusive scan of Gaussian pair potentials over time, one warp per batch
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
//   kalman_plane_fixup_kernel, grid (N, C): phases 2-3 fused.  Warp 0 folds
//     the totals of the chunks before it (after it, in reverse) into the
//     chunk's carry-in; then every warp of the block combines it with its
//     own rows of the chunk, in place, at the same time.
// The one-pass scan is C = 1, L = T: phase 1 alone.
//
// What bounds it on an H100: one scan reads each element once and writes
// each prefix once (Flocking, H=14, T=150, N=20: 617 floats * 3000 elements,
// 7.4 MB each way, a few microseconds at 3.35 TB/s).  The bound in practice
// is the chain of T dependent combines (an HxH Cholesky, 2H+1 triangular
// solves, a (2H+1)^2 Gram matrix of the solutions) on few lanes.  So the
// design cuts the latency of one combine:
//   - a warp cooperates on one lane's combine.  Thread i holds row i of M
//     and the Cholesky runs column by column with warp shuffles (the
//     trailing update spread over the rows); the 2H+1 = 29 forward
//     substitutions take one right-hand side per thread, its column in
//     registers; the products A'A, B'B, A'B, A'c, B'c, c'c are rows of the
//     Gram matrix of the solutions, thread r computing row r (29
//     independent dot products) against the solutions read from shared
//     memory as float4 broadcasts, then writing the outputs its row holds;
//   - the carry, the incoming element and the factors live in shared
//     memory (~10 KB per lane at H=14), never in local memory;
//   - each time step's slab for the block's four lanes is copied with
//     cp.async, coalesced over the lanes (the minor axis), double-buffered:
//     step t+1 loads while step t combines; the prefixes are stored the
//     same way;
//   - the fix-up applies the carry-in to a chunk's rows in parallel, one
//     row per warp, instead of walking them in series.
// The combine writes its result in place over either operand.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 4;     // lanes (warps) per block of the scan kernel
constexpr int kFixWarps = 8;  // warps per block of the fix-up kernel

// Offsets of an element's entries in shared memory, in plane order.
template <int H>
struct Layout {
  static constexpr int HH = H * H;
  static constexpr int Jaa = 0, Jab = HH, Jbb = 2 * HH;
  static constexpr int ha = 3 * HH, hb = 3 * HH + H, w = 3 * HH + 2 * H;
  static constexpr int size = 3 * HH + 2 * H + 1;
  static constexpr int padded = (size + 3) & ~3;
};

// A warp's factors: L (rows i, columns k <= i), 1 / L_ii, and the 2H+1
// solutions (A's columns, B's columns, c) as rows of V, padded to whole
// float4s.
template <int H>
struct Work {
  static constexpr int kV = (H + 3) & ~3;
  float L[H][H + 1];
  float inv_d[H];
  __align__(16) float V[2 * H + 1][kV];
};

struct Planes {
  const float* p[6];  // Jaa, Jab, Jbb, ha, hb, logw
};

struct OutPlanes {
  float* p[6];
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// out = e1 o e2 by the 32 threads of a warp (l = lane in the warp).  `out`
// may be e1 or e2: every input entry that an output entry overwrites is
// read before the __syncwarp that precedes the writes (M, the right-hand
// sides and w consume J1bb, J2aa, J1ab, J2ab, h1b, h2a, w1, w2 first; the
// other outputs read only the same entry of the input they replace, in the
// same thread).
template <int H>
__device__ __forceinline__ void combine(const float* e1, const float* e2, float* out,
                                        Work<H>& wk, int l) {
  using Y = Layout<H>;
  constexpr int R = 2 * H + 1;
  static_assert(R <= 32, "one right-hand side per thread");

  // Cholesky of M = J1bb + J2aa: thread i < H holds row i (entries k <= i
  // are the factor's); the other threads follow along on a copy of row 0.
  const int li = l < H ? l : 0;
  float row[H];
#pragma unroll
  for (int k = 0; k < H; ++k) row[k] = e1[Y::Jbb + li * H + k] + e2[Y::Jaa + li * H + k];
  float half_logdet = 0.0f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float djj = __shfl_sync(kFull, row[j], j);  // M_jj less the earlier columns
    const float inv = rsqrtf(djj);
    half_logdet += 0.5f * logf(djj);
    if (l == j) wk.inv_d[j] = inv;
    const float lij = row[j] * inv;  // L_ij for i > j, L_jj for i == j
    row[j] = lij;
#pragma unroll
    for (int k = j + 1; k < H; ++k) row[k] -= lij * __shfl_sync(kFull, lij, k);
  }
  if (l < H) {
#pragma unroll
    for (int k = 0; k < H; ++k)
      if (k <= l) wk.L[l][k] = row[k];
  }
  // right-hand sides: J1ab's row r (r < H), J2ab's column r - H, h1b + h2a
  const int rr = l < R ? l : R - 1;
  const float* src = rr < H ? e1 + Y::Jab + rr * H : e2 + Y::Jab + (rr < 2 * H ? rr - H : 0);
  const int stride = rr < H ? 1 : H;
  float x[H];
#pragma unroll
  for (int i = 0; i < H; ++i)
    x[i] = rr < 2 * H ? src[i * stride] : e1[Y::hb + i] + e2[Y::ha + i];
  const float w12 = e1[Y::w] + e2[Y::w];
  __syncwarp();
  // forward substitution L x = rhs, column by column
#pragma unroll
  for (int i = 0; i < H; ++i) {
    x[i] *= wk.inv_d[i];
#pragma unroll
    for (int k = i + 1; k < H; ++k) x[k] -= wk.L[k][i] * x[i];
  }
  if (l < R) {
#pragma unroll
    for (int i = 0; i < H; ++i) wk.V[l][i] = x[i];
  }
  __syncwarp();
  // Gram row l against every solution (independent dot products, the
  // solutions read as float4 broadcasts), then each thread writes the
  // outputs its row holds: A'A, A'B, A'c (threads < H), B'B, B'c (threads
  // H..2H-1), c'c (thread 2H).
  constexpr int kV = Work<H>::kV;
  float dot[R];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    dot[s] = 0.0f;
#pragma unroll
    for (int k4 = 0; k4 < kV; k4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&wk.V[s][k4]);
      const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k4 + u < H) dot[s] = fmaf(x[k4 + u], vk[u], dot[s]);
    }
  }
  if (l < H) {
#pragma unroll
    for (int s = 0; s < H; ++s) {
      out[Y::Jaa + l * H + s] = e1[Y::Jaa + l * H + s] - dot[s];
      out[Y::Jab + l * H + s] = -dot[H + s];
    }
    out[Y::ha + l] = e1[Y::ha + l] - dot[2 * H];
  } else if (l < 2 * H) {
    const int c = l - H;
#pragma unroll
    for (int s = 0; s < H; ++s) out[Y::Jbb + c * H + s] = e2[Y::Jbb + c * H + s] - dot[H + s];
    out[Y::hb + c] = e2[Y::hb + c] - dot[2 * H];
  } else if (l == 2 * H) {
    out[Y::w] = w12 + 0.5f * dot[2 * H] - half_logdet + 0.5f * H * kLog2Pi;
  }
  __syncwarp();
}

// Element row t of lane n at `src` (planes of `rows` rows) into shared `dst`
// by one warp, synchronously.
template <int H>
__device__ __forceinline__ void warp_load(float* dst, const Planes& src, int t, int N,
                                          int n, int l) {
  using Y = Layout<H>;
  for (int q = l; q < Y::HH; q += 32) {
    const size_t o = (static_cast<size_t>(t) * Y::HH + q) * N + n;
    dst[Y::Jaa + q] = src.p[0][o];
    dst[Y::Jab + q] = src.p[1][o];
    dst[Y::Jbb + q] = src.p[2][o];
  }
  if (l < H) {
    const size_t o = (static_cast<size_t>(t) * H + l) * N + n;
    dst[Y::ha + l] = src.p[3][o];
    dst[Y::hb + l] = src.p[4][o];
  }
  if (l == 0) dst[Y::w] = src.p[5][static_cast<size_t>(t) * N + n];
  __syncwarp();
}

template <int H>
__device__ __forceinline__ void warp_store(const float* e, const OutPlanes& dst, int t, int N,
                                           int n, int l) {
  using Y = Layout<H>;
  for (int q = l; q < Y::HH; q += 32) {
    const size_t o = (static_cast<size_t>(t) * Y::HH + q) * N + n;
    dst.p[0][o] = e[Y::Jaa + q];
    dst.p[1][o] = e[Y::Jab + q];
    dst.p[2][o] = e[Y::Jbb + q];
  }
  if (l < H) {
    const size_t o = (static_cast<size_t>(t) * H + l) * N + n;
    dst.p[3][o] = e[Y::ha + l];
    dst.p[4][o] = e[Y::hb + l];
  }
  if (l == 0) dst.p[5][static_cast<size_t>(t) * N + n] = e[Y::w];
}

// The rows [begin, end) of this block's chunk.
__device__ __forceinline__ void chunk_rows(int T, int L, int offset, int& begin, int& end) {
  const int c = blockIdx.y;
  begin = max(c * L + offset, 0);
  end = min((c + 1) * L + offset, T);
}

template <int H>
struct ScanLane {
  float carry[Layout<H>::padded];
  float e[2][Layout<H>::padded];
  Work<H> wk;
};

// Row t of the block's lanes n0 .. n0 + kLanes - 1, by the whole block:
// consecutive threads take consecutive lanes of one entry.
template <int H>
__device__ __forceinline__ void block_load_async(ScanLane<H>* sm, int buf, const Planes& src,
                                                 int t, int N, int n0) {
  using Y = Layout<H>;
  for (int e = threadIdx.x; e < Y::HH * kLanes; e += blockDim.x) {
    const int q = e / kLanes, w = e % kLanes, n = n0 + w;
    if (n >= N) continue;
    const size_t o = (static_cast<size_t>(t) * Y::HH + q) * N + n;
    float* d = sm[w].e[buf];
    cp_async4(d + Y::Jaa + q, src.p[0] + o);
    cp_async4(d + Y::Jab + q, src.p[1] + o);
    cp_async4(d + Y::Jbb + q, src.p[2] + o);
  }
  for (int e = threadIdx.x; e < H * kLanes; e += blockDim.x) {
    const int q = e / kLanes, w = e % kLanes, n = n0 + w;
    if (n >= N) continue;
    const size_t o = (static_cast<size_t>(t) * H + q) * N + n;
    cp_async4(sm[w].e[buf] + Y::ha + q, src.p[3] + o);
    cp_async4(sm[w].e[buf] + Y::hb + q, src.p[4] + o);
  }
  if (threadIdx.x < kLanes && n0 + threadIdx.x < N)
    cp_async4(sm[threadIdx.x].e[buf] + Y::w, src.p[5] + static_cast<size_t>(t) * N + n0 +
                                                 threadIdx.x);
  cp_async_commit();
}

template <int H>
__device__ __forceinline__ void block_store(const ScanLane<H>* sm, const OutPlanes& dst, int t,
                                            int N, int n0) {
  using Y = Layout<H>;
  for (int e = threadIdx.x; e < Y::HH * kLanes; e += blockDim.x) {
    const int q = e / kLanes, w = e % kLanes, n = n0 + w;
    if (n >= N) continue;
    const size_t o = (static_cast<size_t>(t) * Y::HH + q) * N + n;
    const float* c = sm[w].carry;
    dst.p[0][o] = c[Y::Jaa + q];
    dst.p[1][o] = c[Y::Jab + q];
    dst.p[2][o] = c[Y::Jbb + q];
  }
  for (int e = threadIdx.x; e < H * kLanes; e += blockDim.x) {
    const int q = e / kLanes, w = e % kLanes, n = n0 + w;
    if (n >= N) continue;
    const size_t o = (static_cast<size_t>(t) * H + q) * N + n;
    dst.p[3][o] = sm[w].carry[Y::ha + q];
    dst.p[4][o] = sm[w].carry[Y::hb + q];
  }
  if (threadIdx.x < kLanes && n0 + threadIdx.x < N)
    dst.p[5][static_cast<size_t>(t) * N + n0 + threadIdx.x] = sm[threadIdx.x].carry[Y::w];
}

// grid (ceil(N / kLanes), C), kLanes warps: warp w walks lane
// blockIdx.x * kLanes + w through the rows of chunk blockIdx.y.
template <int H>
__global__ void __launch_bounds__(kLanes * 32)
kalman_plane_scan_kernel(Planes in, OutPlanes out, OutPlanes totals, int T, int N, int L,
                         int offset, int reverse) {
  __shared__ __align__(16) ScanLane<H> sm[kLanes];
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n0 = blockIdx.x * kLanes;
  const bool live = n0 + w < N;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  const int steps = end - begin;
  ScanLane<H>& me = sm[w];
  block_load_async<H>(sm, 0, in, reverse ? end - 1 : begin, N, n0);
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? end - 1 - s : begin + s;
    cp_async_wait_all();
    __syncthreads();  // row t landed for every lane; row t - 1 stored
    if (s + 1 < steps) block_load_async<H>(sm, (s + 1) & 1, in, reverse ? t - 1 : t + 1, N, n0);
    const float* e = me.e[s & 1];
    if (live) {
      if (s == 0) {
        for (int q = l; q < Layout<H>::size; q += 32) me.carry[q] = e[q];
      } else if (reverse) {
        combine<H>(e, me.carry, me.carry, me.wk, l);
      } else {
        combine<H>(me.carry, e, me.carry, me.wk, l);
      }
    }
    __syncthreads();  // every lane's prefix complete
    block_store<H>(sm, out, t, N, n0);
  }
  if (totals.p[5] != nullptr) block_store<H>(sm, totals, blockIdx.y, N, n0);
}

template <int H>
struct FixWarp {
  float e[Layout<H>::padded];
  Work<H> wk;
};

// grid (N, C), kFixWarps warps: phases 2-3 for lane blockIdx.x, chunk
// blockIdx.y.
template <int H>
__global__ void __launch_bounds__(kFixWarps * 32)
kalman_plane_fixup_kernel(OutPlanes out, Planes totals, int T, int N, int L, int offset, int C,
                          int reverse) {
  __shared__ __align__(16) float acc[Layout<H>::padded];
  __shared__ __align__(16) FixWarp<H> fw[kFixWarps];
  const int n = blockIdx.x, c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (c == (reverse ? C - 1 : 0)) return;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  if (w == 0) {
    // phase 2: acc = totals[0] o ... o totals[c-1], or in reverse
    // totals[c+1] o ... o totals[C-1]
    warp_load<H>(acc, totals, reverse ? C - 1 : 0, N, n, l);
    const int before = reverse ? C - 1 - c : c;
    for (int s = 1; s < before; ++s) {
      warp_load<H>(fw[0].e, totals, reverse ? C - 1 - s : s, N, n, l);
      if (reverse)
        combine<H>(fw[0].e, acc, acc, fw[0].wk, l);
      else
        combine<H>(acc, fw[0].e, acc, fw[0].wk, l);
    }
  }
  __syncthreads();
  // phase 3: each warp combines the carry-in with its rows of the chunk
  const Planes rows{{out.p[0], out.p[1], out.p[2], out.p[3], out.p[4], out.p[5]}};
  FixWarp<H>& me = fw[w];
  for (int t = begin + w; t < end; t += kFixWarps) {
    warp_load<H>(me.e, rows, t, N, n, l);
    if (reverse)
      combine<H>(me.e, acc, me.e, me.wk, l);
    else
      combine<H>(acc, me.e, me.e, me.wk, l);
    warp_store<H>(me.e, out, t, N, n, l);
  }
}

OutPlanes out_planes(void* const* p) {
  return OutPlanes{{static_cast<float*>(p[0]), static_cast<float*>(p[1]),
                    static_cast<float*>(p[2]), static_cast<float*>(p[3]),
                    static_cast<float*>(p[4]), static_cast<float*>(p[5])}};
}

Planes readable(const OutPlanes& o) {
  return Planes{{o.p[0], o.p[1], o.p[2], o.p[3], o.p[4], o.p[5]}};
}

template <int H>
int launch(const void* const* in, void* const* out, void* const* totals, int T, int N, int C,
           int L, int offset, int reverse, cudaStream_t stream) {
  const Planes src{{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
                    static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                    static_cast<const float*>(in[4]), static_cast<const float*>(in[5])}};
  const OutPlanes dst = out_planes(out);
  const OutPlanes tot = out_planes(totals);
  const dim3 grid((N + kLanes - 1) / kLanes, C);
  kalman_plane_scan_kernel<H><<<grid, kLanes * 32, 0, stream>>>(src, dst, tot, T, N, L,
                                                                 offset, reverse);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  kalman_plane_fixup_kernel<H><<<dim3(N, C), kFixWarps * 32, 0, stream>>>(
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
