// Inclusive scan of Gaussian pair potentials over time, one warp per batch
// lane, walked in one pass or folded into time chunks.  The templates, at a
// rung H that the potentials of size h <= H are padded to;
// kalman_plane_scan.cu holds the C entry point and the rungs H <= 16,
// kalman_plane_scan_wide.cu the rungs 24 and 32 (two sources, so that nvcc
// builds them in parallel).
//
// Replaces pyvbmp_tpu/ops/pallas_scan.py:_build_call (one pass) and
// pyvbmp_tpu/ops/pallas_scan.py:_build_folded_call (the time fold) with the
// combine pyvbmp_tpu/ops/parallel_kalman.py:_combine_plane: the prefix and
// suffix scans of the log-depth Kalman smoother (_plane_smoother), at every
// plane size 1 <= H <= 32 (parallel_kalman.py's PLANE_KALMAN_MAX_H).
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
//     trailing update spread over the rows);
//   - H <= 15 (R = 2H+1 <= 32 right-hand sides): the forward substitutions
//     take one right-hand side per thread, its column in registers; the
//     products A'A, B'B, A'B, A'c, B'c, c'c are rows of the Gram matrix of
//     the solutions, thread r computing row r (R independent dot products)
//     against the solutions read from shared memory as float4 broadcasts,
//     then writing the outputs its row holds;
//   - 16 <= H <= 32 (R up to 65): each thread solves every 32nd right-hand
//     side in turn, and the outputs are dealt out entry by entry, each one
//     dot product of two solutions (rows of V padded by 4 floats, so the
//     float4 reads of a warp's different rows fall in different banks);
//   - the carry, the incoming element and the factors live in shared
//     memory, never in local memory (dynamic shared memory: ~10 KB a lane at
//     H=14, ~51 KB at H=32);
//   - each time step's slab for the block's lanes (4 at H <= 15, 1 above) is
//     copied with cp.async, coalesced over the lanes (the minor axis),
//     double-buffered: step t+1 loads while step t combines; the prefixes
//     are stored the same way;
//   - the fix-up applies the carry-in to a chunk's rows in parallel, one
//     row per warp, instead of walking them in series.
// The combine writes its result in place over either operand.
//
// Padding h to the rung H is exact.  In shared memory the padded rows and
// columns of Jaa and Jbb hold 1/2 on the diagonal and 0 elsewhere, and Jab,
// ha, hb hold 0 there, so M = J1bb + J2aa is the identity on the padding
// and 0 across it: the Cholesky factor is the identity there (log 1 = 0
// adds nothing to log det), the padded solutions are 0, and every padded
// output entry comes back as it went in.  Only the real h x h block is read
// from and written to device memory, and the constant term takes h.

#include <cuda_runtime.h>
#include <math.h>

namespace kalman_plane {

constexpr float kLog2Pi = 1.8378770664093453f;
constexpr unsigned kFull = 0xffffffffu;

// One right-hand side per thread while R = 2H+1 fits a warp.
template <int H>
constexpr bool kOneRhsPerThread = 2 * H + 1 <= 32;
// lanes (warps) per block of the scan kernel; warps per fix-up block
template <int H>
constexpr int kLanes = kOneRhsPerThread<H> ? 4 : 1;
template <int H>
constexpr int kFixWarps = kOneRhsPerThread<H> ? 8 : 4;

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
// float4s (and by one more float4 where different threads read different
// rows at once).
template <int H>
struct Work {
  static constexpr int kV = (H + 3) & ~3;
  static constexpr int kVS = kOneRhsPerThread<H> ? kV : kV + 4;
  float L[H][H + 1];
  float inv_d[H];
  __align__(16) float V[2 * H + 1][kVS];
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

// Cholesky of M = J1bb + J2aa into wk.L and wk.inv_d by the warp: thread
// i < H holds row i (entries k <= i are the factor's); the other threads
// follow along on a copy of row 0.  Returns sum_i log L_ii (every thread).
template <int H>
__device__ __forceinline__ float cholesky(const float* e1, const float* e2, Work<H>& wk, int l) {
  using Y = Layout<H>;
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
  return half_logdet;
}

// Right-hand side rr into x: J1ab's row rr (rr < H), J2ab's column rr - H
// (rr < 2H), h1b + h2a (rr = 2H); then x = L^-1 x, column by column.
template <int H>
__device__ __forceinline__ void solve(const float* e1, const float* e2, const Work<H>& wk, int rr,
                                      float (&x)[H]) {
  using Y = Layout<H>;
  const float* src = rr < H ? e1 + Y::Jab + rr * H : e2 + Y::Jab + (rr < 2 * H ? rr - H : 0);
  const int stride = rr < H ? 1 : H;
#pragma unroll
  for (int i = 0; i < H; ++i) x[i] = rr < 2 * H ? src[i * stride] : e1[Y::hb + i] + e2[Y::ha + i];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    x[i] *= wk.inv_d[i];
#pragma unroll
    for (int k = i + 1; k < H; ++k) x[k] -= wk.L[k][i] * x[i];
  }
}

// Dot product of the solutions s and u (rows of V) over their H entries.
template <int H>
__device__ __forceinline__ float vdot(const Work<H>& wk, int s, int u) {
  constexpr int kV = Work<H>::kV;
  float acc = 0.0f;
#pragma unroll
  for (int k4 = 0; k4 < kV; k4 += 4) {
    const float4 a = *reinterpret_cast<const float4*>(&wk.V[s][k4]);
    const float4 b = *reinterpret_cast<const float4*>(&wk.V[u][k4]);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (k4 + q < H) acc = fmaf(av[q], bv[q], acc);
  }
  return acc;
}

// out = e1 o e2 by the 32 threads of a warp (l = lane in the warp).  `out`
// may be e1 or e2: every input entry that an output entry overwrites is
// read before the __syncwarp that precedes the writes (M, the right-hand
// sides and w consume J1bb, J2aa, J1ab, J2ab, h1b, h2a, w1, w2 first; the
// other outputs read only the same entry of the input they replace, in the
// same thread).
template <int H>
__device__ __forceinline__ void combine(const float* e1, const float* e2, float* out,
                                        Work<H>& wk, int h, int l) {
  using Y = Layout<H>;
  constexpr int R = 2 * H + 1;
  const float half_logdet = cholesky<H>(e1, e2, wk, l);
  const float w12 = e1[Y::w] + e2[Y::w];
  __syncwarp();
  if constexpr (kOneRhsPerThread<H>) {
    // one right-hand side per thread, kept in registers for the Gram row
    const int rr = l < R ? l : R - 1;
    float x[H];
    solve<H>(e1, e2, wk, rr, x);
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
      out[Y::w] = w12 + 0.5f * dot[2 * H] - half_logdet + 0.5f * h * kLog2Pi;
    }
  } else {
    // every 32nd right-hand side per thread, in turn
    for (int rr = l; rr < R; rr += 32) {
      float x[H];
      solve<H>(e1, e2, wk, rr, x);
#pragma unroll
      for (int i = 0; i < H; ++i) wk.V[rr][i] = x[i];
    }
    __syncwarp();
    const float cc = l == 0 ? vdot<H>(wk, 2 * H, 2 * H) : 0.0f;
    // the outputs entry by entry: (i, s) of A'A, A'B, B'B, then A'c, B'c
    for (int q = l; q < Y::HH; q += 32) {
      const int i = q / H, s = q - (q / H) * H;
      out[Y::Jaa + q] = e1[Y::Jaa + q] - vdot<H>(wk, i, s);
      out[Y::Jab + q] = -vdot<H>(wk, i, H + s);
      out[Y::Jbb + q] = e2[Y::Jbb + q] - vdot<H>(wk, H + i, H + s);
    }
    for (int i = l; i < H; i += 32) {
      out[Y::ha + i] = e1[Y::ha + i] - vdot<H>(wk, i, 2 * H);
      out[Y::hb + i] = e2[Y::hb + i] - vdot<H>(wk, H + i, 2 * H);
    }
    if (l == 0) out[Y::w] = w12 + 0.5f * cc - half_logdet + 0.5f * h * kLog2Pi;
  }
  __syncwarp();
}

// Entry q = (i, j) of an H x H matrix: its offset in an h x h one, or -1
// where it is padding or past the matrix.  The loops below run over the
// H x H entries in a number of slots the compiler knows, so that they unroll
// (up to kUnrollSlots) and what a slot computes here is the same at every
// time step.
template <int H>
__device__ __forceinline__ int real_at(int q, int h) {
  const int i = q / H, j = q - q / H * H;
  return i < h && j < h ? i * h + j : -1;
}

constexpr int kUnrollSlots = 8;

// The padding of the element at `e` (see above), entries from `first` in
// steps of `step`; the real entries are left alone.
template <int H>
__device__ __forceinline__ void pad(float* e, int h, int first, int step) {
  using Y = Layout<H>;
  if (h == H) return;
  for (int x = first; x < Y::w; x += step) {
    if (x < Y::ha) {
      const int q = x % Y::HH, i = q / H, j = q - (q / H) * H;
      if (i >= h || j >= h) e[x] = (x < Y::Jab || x >= Y::Jbb) && i == j ? 0.5f : 0.0f;
    } else if ((x - Y::ha) % H >= h) {
      e[x] = 0.0f;
    }
  }
}

// Element row t of lane n at `src` (planes of `rows` rows) into shared `dst`
// by one warp, synchronously.
template <int H>
__device__ __forceinline__ void warp_load(float* dst, const Planes& src, int t, int h, int N,
                                          int n, int l) {
  using Y = Layout<H>;
  constexpr int slots = (Y::HH + 31) / 32;
#pragma unroll(slots <= kUnrollSlots ? slots : 1)
  for (int k = 0; k < slots; ++k) {
    const int q = l + 32 * k;
    const int r = real_at<H>(q, h);
    if (r < 0) continue;
    const size_t o = (static_cast<size_t>(t) * h * h + r) * N + n;
    dst[Y::Jaa + q] = src.p[0][o];
    dst[Y::Jab + q] = src.p[1][o];
    dst[Y::Jbb + q] = src.p[2][o];
  }
  if (l < h) {  // h <= 32: one entry a thread
    const size_t o = (static_cast<size_t>(t) * h + l) * N + n;
    dst[Y::ha + l] = src.p[3][o];
    dst[Y::hb + l] = src.p[4][o];
  }
  if (l == 0) dst[Y::w] = src.p[5][static_cast<size_t>(t) * N + n];
  __syncwarp();
}

template <int H>
__device__ __forceinline__ void warp_store(const float* e, const OutPlanes& dst, int t, int h,
                                           int N, int n, int l) {
  using Y = Layout<H>;
  constexpr int slots = (Y::HH + 31) / 32;
#pragma unroll(slots <= kUnrollSlots ? slots : 1)
  for (int k = 0; k < slots; ++k) {
    const int q = l + 32 * k;
    const int r = real_at<H>(q, h);
    if (r < 0) continue;
    const size_t o = (static_cast<size_t>(t) * h * h + r) * N + n;
    dst.p[0][o] = e[Y::Jaa + q];
    dst.p[1][o] = e[Y::Jab + q];
    dst.p[2][o] = e[Y::Jbb + q];
  }
  if (l < h) {
    const size_t o = (static_cast<size_t>(t) * h + l) * N + n;
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
                                                 int t, int h, int N, int n0) {
  using Y = Layout<H>;
  constexpr int lanes = kLanes<H>, threads = 32 * lanes;
  constexpr int slots = (Y::HH * lanes + threads - 1) / threads;
#pragma unroll(slots <= kUnrollSlots ? slots : 1)
  for (int k = 0; k < slots; ++k) {
    const int e = threadIdx.x + k * threads;
    const int q = e / lanes, w = e % lanes, n = n0 + w;
    const int r = real_at<H>(q, h);
    if (n >= N || r < 0) continue;
    const size_t o = (static_cast<size_t>(t) * h * h + r) * N + n;
    float* d = sm[w].e[buf] + q;
    cp_async4(d + Y::Jaa, src.p[0] + o);
    cp_async4(d + Y::Jab, src.p[1] + o);
    cp_async4(d + Y::Jbb, src.p[2] + o);
  }
  if (threadIdx.x < h * lanes) {  // h <= 32: one entry a thread
    const int q = threadIdx.x / lanes, w = threadIdx.x % lanes, n = n0 + w;
    if (n < N) {
      const size_t o = (static_cast<size_t>(t) * h + q) * N + n;
      cp_async4(sm[w].e[buf] + Y::ha + q, src.p[3] + o);
      cp_async4(sm[w].e[buf] + Y::hb + q, src.p[4] + o);
    }
  }
  if (threadIdx.x < lanes && n0 + threadIdx.x < N)
    cp_async4(sm[threadIdx.x].e[buf] + Y::w, src.p[5] + static_cast<size_t>(t) * N + n0 +
                                                 threadIdx.x);
  cp_async_commit();
}

template <int H>
__device__ __forceinline__ void block_store(const ScanLane<H>* sm, const OutPlanes& dst, int t,
                                            int h, int N, int n0) {
  using Y = Layout<H>;
  constexpr int lanes = kLanes<H>, threads = 32 * lanes;
  constexpr int slots = (Y::HH * lanes + threads - 1) / threads;
#pragma unroll(slots <= kUnrollSlots ? slots : 1)
  for (int k = 0; k < slots; ++k) {
    const int e = threadIdx.x + k * threads;
    const int q = e / lanes, w = e % lanes, n = n0 + w;
    const int r = real_at<H>(q, h);
    if (n >= N || r < 0) continue;
    const size_t o = (static_cast<size_t>(t) * h * h + r) * N + n;
    const float* c = sm[w].carry + q;
    dst.p[0][o] = c[Y::Jaa];
    dst.p[1][o] = c[Y::Jab];
    dst.p[2][o] = c[Y::Jbb];
  }
  if (threadIdx.x < h * lanes) {
    const int q = threadIdx.x / lanes, w = threadIdx.x % lanes, n = n0 + w;
    if (n < N) {
      const size_t o = (static_cast<size_t>(t) * h + q) * N + n;
      dst.p[3][o] = sm[w].carry[Y::ha + q];
      dst.p[4][o] = sm[w].carry[Y::hb + q];
    }
  }
  if (threadIdx.x < lanes && n0 + threadIdx.x < N)
    dst.p[5][static_cast<size_t>(t) * N + n0 + threadIdx.x] = sm[threadIdx.x].carry[Y::w];
}

// grid (ceil(N / kLanes), C), kLanes warps: warp w walks lane
// blockIdx.x * kLanes + w through the rows of chunk blockIdx.y.  Dynamic
// shared memory: ScanLane<H>[kLanes].
template <int H>
__global__ void __launch_bounds__(kLanes<H> * 32, 1)
kalman_plane_scan_kernel(Planes in, OutPlanes out, OutPlanes totals, int T, int h, int N,
                         int L, int offset, int reverse) {
  extern __shared__ __align__(16) float kalman_plane_smem[];
  ScanLane<H>* sm = reinterpret_cast<ScanLane<H>*>(kalman_plane_smem);
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int n0 = blockIdx.x * kLanes<H>;
  const bool live = n0 + w < N;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  const int steps = end - begin;
  ScanLane<H>& me = sm[w];
  pad<H>(me.e[0], h, l, 32);
  pad<H>(me.e[1], h, l, 32);
  block_load_async<H>(sm, 0, in, reverse ? end - 1 : begin, h, N, n0);
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? end - 1 - s : begin + s;
    cp_async_wait_all();
    __syncthreads();  // row t landed for every lane; row t - 1 stored
    if (s + 1 < steps)
      block_load_async<H>(sm, (s + 1) & 1, in, reverse ? t - 1 : t + 1, h, N, n0);
    const float* e = me.e[s & 1];
    if (live) {
      if (s == 0) {
        for (int q = l; q < Layout<H>::size; q += 32) me.carry[q] = e[q];
      } else if (reverse) {
        combine<H>(e, me.carry, me.carry, me.wk, h, l);
      } else {
        combine<H>(me.carry, e, me.carry, me.wk, h, l);
      }
    }
    __syncthreads();  // every lane's prefix complete
    block_store<H>(sm, out, t, h, N, n0);
  }
  if (totals.p[5] != nullptr) block_store<H>(sm, totals, blockIdx.y, h, N, n0);
}

template <int H>
struct FixWarp {
  float e[Layout<H>::padded];
  Work<H> wk;
};

// grid (N, C), kFixWarps warps: phases 2-3 for lane blockIdx.x, chunk
// blockIdx.y.  Dynamic shared memory: the carry-in (Layout<H>::padded
// floats), then FixWarp<H>[kFixWarps].
template <int H>
__global__ void __launch_bounds__(kFixWarps<H> * 32, 1)
kalman_plane_fixup_kernel(OutPlanes out, Planes totals, int T, int h, int N, int L, int offset,
                          int C, int reverse) {
  extern __shared__ __align__(16) float kalman_plane_smem[];
  float* acc = kalman_plane_smem;
  FixWarp<H>* fw = reinterpret_cast<FixWarp<H>*>(kalman_plane_smem + Layout<H>::padded);
  const int n = blockIdx.x, c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if (c == (reverse ? C - 1 : 0)) return;
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  int begin, end;
  chunk_rows(T, L, offset, begin, end);
  FixWarp<H>& me = fw[w];
  pad<H>(me.e, h, l, 32);
  if (w == 0) {
    pad<H>(acc, h, l, 32);
    __syncwarp();
    // phase 2: acc = totals[0] o ... o totals[c-1], or in reverse
    // totals[c+1] o ... o totals[C-1]
    warp_load<H>(acc, totals, reverse ? C - 1 : 0, h, N, n, l);
    const int before = reverse ? C - 1 - c : c;
    for (int s = 1; s < before; ++s) {
      warp_load<H>(me.e, totals, reverse ? C - 1 - s : s, h, N, n, l);
      if (reverse)
        combine<H>(me.e, acc, acc, me.wk, h, l);
      else
        combine<H>(acc, me.e, acc, me.wk, h, l);
    }
  }
  __syncthreads();
  // phase 3: each warp combines the carry-in with its rows of the chunk
  const Planes rows{{out.p[0], out.p[1], out.p[2], out.p[3], out.p[4], out.p[5]}};
  for (int t = begin + w; t < end; t += kFixWarps<H>) {
    warp_load<H>(me.e, rows, t, h, N, n, l);
    if (reverse)
      combine<H>(me.e, acc, me.e, me.wk, h, l);
    else
      combine<H>(acc, me.e, me.e, me.wk, h, l);
    warp_store<H>(me.e, out, t, h, N, n, l);
  }
}

inline OutPlanes out_planes(void* const* p) {
  return OutPlanes{{static_cast<float*>(p[0]), static_cast<float*>(p[1]),
                    static_cast<float*>(p[2]), static_cast<float*>(p[3]),
                    static_cast<float*>(p[4]), static_cast<float*>(p[5])}};
}

inline Planes readable(const OutPlanes& o) {
  return Planes{{o.p[0], o.p[1], o.p[2], o.p[3], o.p[4], o.p[5]}};
}

// Raise a kernel's dynamic shared memory limit where it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The scan of potentials of size h at the rung H >= h.
template <int H>
int launch(const void* const* in, void* const* out, void* const* totals, int T, int h, int N,
           int C, int L, int offset, int reverse, cudaStream_t stream) {
  const Planes src{{static_cast<const float*>(in[0]), static_cast<const float*>(in[1]),
                    static_cast<const float*>(in[2]), static_cast<const float*>(in[3]),
                    static_cast<const float*>(in[4]), static_cast<const float*>(in[5])}};
  const OutPlanes dst = out_planes(out);
  const OutPlanes tot = out_planes(totals);
  constexpr int lanes = kLanes<H>;
  const size_t scan_bytes = sizeof(ScanLane<H>) * lanes;
  cudaError_t err = allow_shared(kalman_plane_scan_kernel<H>, scan_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + lanes - 1) / lanes, C);
  kalman_plane_scan_kernel<H><<<grid, lanes * 32, scan_bytes, stream>>>(src, dst, tot, T, h, N,
                                                                       L, offset, reverse);
  err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  const size_t fix_bytes =
      sizeof(float) * Layout<H>::padded + sizeof(FixWarp<H>) * kFixWarps<H>;
  err = allow_shared(kalman_plane_fixup_kernel<H>, fix_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kalman_plane_fixup_kernel<H><<<dim3(N, C), kFixWarps<H> * 32, fix_bytes, stream>>>(
      dst, readable(tot), T, h, N, L, offset, C, reverse);
  return static_cast<int>(cudaGetLastError());
}

// The rungs instantiated in kalman_plane_scan_wide.cu.
extern template int launch<24>(const void* const*, void* const*, void* const*, int, int, int,
                               int, int, int, int, cudaStream_t);
extern template int launch<32>(const void* const*, void* const*, void* const*, int, int, int,
                               int, int, int, int, cudaStream_t);

}  // namespace kalman_plane
