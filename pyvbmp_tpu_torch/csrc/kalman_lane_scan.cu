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
// What bounds it on an H100: at the MixLDS shape (H=2, T=100, N=4000) one
// scan reads each element once and writes each prefix once, 15 floats * 4 B
// * 4000 * 100 = 24 MB each way, ~14 us at 3.35 TB/s; the fold's fix-up reads
// and writes every row of all but one chunk once more.  There are only N
// lanes and each walks T - 1 dependent combines, so at N = 4000 each SM
// holds one warp (a block of 32 lanes), and that warp must keep enough of
// device memory's latency in flight by itself.  The design:
//   - every kernel streams its elements through a ring of kRing slots in
//     shared memory, (slot, component, lane): steps i + 2 .. i + kRing - 1
//     are in flight as cp.async copies and step i + 1 is read from shared
//     memory while step i combines, ~24 KB a warp at every H.  Where N is
//     a multiple of 32 and the leaves are 16-byte aligned (RowCopy<H,
//     true>), a step's F component rows of 128 bytes go as 16-byte chunks
//     shared over the warp, a quarter of the copy instructions, issued
//     before the step's combine, and __syncwarp after each
//     cp.async.wait_group lets a thread read the chunks the others
//     copied; otherwise each thread copies its own lane's components, 4
//     bytes each, and no step takes a barrier.  A ring deeper than the
//     walk commits empty groups;
//   - the stores go straight from registers, coalesced, and nothing waits
//     on them; the pointers advance by a row a step;
//   - the fix-up walks the carry-in's totals and then the chunk's rows
//     through the same ring, so the totals are in flight together before
//     the first combine and each row's load leaves kRing - 1 steps ahead of
//     its store.  The rows are read from the arrays they are written back
//     to (in place), so nothing here is __restrict__;
//   - the combine is straight-line code on registers: the adjugate times
//     one correctly rounded reciprocal of det M where the plain version
//     divides every entry, and __logf (CUDA's bound: absolute error
//     2^-21.41 on [0.5, 2], 3 ulp elsewhere) for log det M.  The carry (15
//     floats at H=2, 28 at H=3) never leaves registers;
//   - the direction is a template parameter, so each kernel's loop holds
//     one combine order.
// Tried and not faster on an H100 at H = 1, 2, 3 (pyvbmp_tpu_torch/probes/
// kalman_lane_designs.cu): a lane's combine split over a lead and a
// follower warp, and the fold in one launch with a decoupled look-back.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // lanes of a block: one warp, a thread per lane
constexpr float kLog2Pi = 1.8378770664093453f;

template <int H>
struct Potential {
  static constexpr int S = H * (H + 1) / 2;
  static constexpr int F = 2 * S + H * H + 2 * H + 1;  // floats of an element
  float Jaa[S];
  float Jab[H * H];
  float Jbb[S];
  float ha[H];
  float hb[H];
  float w;
};

// Ring slots per thread: the elements of kRing - 2 steps in flight, F * 128 B
// a step for the warp (23 KB at H=1, 26 KB at H=2, 21 KB at H=3).  Deeper
// rings were no faster on an H100.
template <int H>
constexpr int kRing = H == 1 ? 32 : H == 2 ? 16 : 8;

// Leaves in the order Jaa, Jab, Jbb, ha, hb, logw.
struct Leaves {
  float* p[6];
};

// Position of entry (i, j) (either triangle) of a packed symmetric matrix.
__host__ __device__ constexpr int sym_pos(int h, int i, int j) {
  return i <= j ? i * h - i * (i - 1) / 2 + (j - i)
                : j * h - j * (j - 1) / 2 + (i - j);
}

// Component count of leaf j (Jaa, Jab, Jbb, ha, hb, logw).
template <int H>
__device__ constexpr int width(int j) {
  return j == 0 || j == 2 ? Potential<H>::S : j == 1 ? H * H : j == 5 ? 1 : H;
}

// fn(value, leaf, component within the leaf, flat component) for every
// component of a potential, in leaf order (all indices compile-time
// constants after unrolling).
template <int H, typename P, typename Fn>
__device__ __forceinline__ void each(P& p, Fn fn) {
  constexpr int S = Potential<H>::S;
#pragma unroll
  for (int k = 0; k < S; ++k) fn(p.Jaa[k], 0, k, k);
#pragma unroll
  for (int k = 0; k < H * H; ++k) fn(p.Jab[k], 1, k, S + k);
#pragma unroll
  for (int k = 0; k < S; ++k) fn(p.Jbb[k], 2, k, S + H * H + k);
#pragma unroll
  for (int k = 0; k < H; ++k) fn(p.ha[k], 3, k, 2 * S + H * H + k);
#pragma unroll
  for (int k = 0; k < H; ++k) fn(p.hb[k], 4, k, 2 * S + H * H + H + k);
  fn(p.w, 5, 0, Potential<H>::F - 1);
}

// A cursor: each leaf's pointer at one row, at this thread's lane.
template <int H>
__device__ __forceinline__ Leaves cursor(const Leaves& x, int t, int N, int n) {
  Leaves c;
#pragma unroll
  for (int j = 0; j < 6; ++j) c.p[j] = x.p[j] + static_cast<size_t>(t) * width<H>(j) * N + n;
  return c;
}

// The cursor moved by `rows` rows (a compile-time constant).
template <int H, int rows>
__device__ __forceinline__ void advance(Leaves& c, int N) {
#pragma unroll
  for (int j = 0; j < 6; ++j) c.p[j] += static_cast<ptrdiff_t>(rows * width<H>(j)) * N;
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

// Slot of step i in a thread's ring of kRing slots: component k of lane l
// at slot[k * kLanes + l].
template <int H>
__device__ __forceinline__ float* slot(float* ring, int i) {
  static_assert((kRing<H> & (kRing<H> - 1)) == 0, "the ring depth is a power of two");
  return ring + (i & (kRing<H> - 1)) * (Potential<H>::F * kLanes);
}

// The row under cursor c into a ring slot, by cp.async (committed by the
// caller).
template <int H>
__device__ __forceinline__ void fetch(float* dst, const Leaves& c, int N, int l) {
  Potential<H> shape;  // only its layout is used
  each<H>(shape, [&](float&, int j, int k, int flat) {
    cp_async4(dst + flat * kLanes + l, c.p[j] + static_cast<ptrdiff_t>(k) * N);
  });
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// A thread's part of copying a block's rows of elements, one row a step,
// into ring slots (committed by the caller).  RowCopy<H, false>: the thread
// copies its own lane's F components, 4 bytes each.
template <int H, bool kShared>
struct RowCopy {
  Leaves c;
  int N, l;
  // leaves x from row t on, for the block whose first lane is n0
  __device__ __forceinline__ RowCopy(const Leaves& x, int t, int N_, int n0, int l_)
      : c(cursor<H>(x, t, N_, n0 + l_)), N(N_), l(l_) {}
  __device__ __forceinline__ void copy(float* slot) const { fetch<H>(slot, c, N, l); }
  __device__ __forceinline__ void advance(int rows) {
#pragma unroll
    for (int j = 0; j < 6; ++j) c.p[j] += static_cast<ptrdiff_t>(rows) * width<H>(j) * N;
  }
};

// RowCopy<H, true>: the block's F component rows of 32 lanes (128 bytes
// each) as 8 F chunks of 16 bytes; thread l copies the chunks of rows
// l / 8 + 4 m (those < F), lanes 4 (l % 8) .. 4 (l % 8) + 3.  Full blocks
// (N % 32 == 0) and 16-byte-aligned leaves only.
template <int H>
struct RowCopy<H, true> {
  static constexpr int kChunks = (Potential<H>::F + 3) / 4;
  const float* src[kChunks];
  ptrdiff_t stride[kChunks];  // floats from a row to the next
  int dst;                    // chunk 0's offset in a slot
  __device__ __forceinline__ RowCopy(const Leaves& x, int t, int N, int n0, int l) {
    const int q = l % 8;
    dst = (l / 8) * kLanes + 4 * q;
#pragma unroll
    for (int m = 0; m < kChunks; ++m) {
      const int row = l / 8 + 4 * m;
      int j = 0, k = row;  // leaf and component of the row
#pragma unroll
      for (int jj = 0; jj < 5; ++jj)
        if (j == jj && k >= width<H>(jj)) {
          k -= width<H>(jj);
          j = jj + 1;
        }
      const float* base = x.p[0];
#pragma unroll
      for (int jj = 1; jj < 6; ++jj)
        if (j == jj) base = x.p[jj];
      src[m] = base + (static_cast<ptrdiff_t>(t) * width<H>(j) + k) * N + n0 + 4 * q;
      stride[m] = static_cast<ptrdiff_t>(width<H>(j)) * N;
    }
  }
  __device__ __forceinline__ void copy(float* slot) const {
#pragma unroll
    for (int m = 0; m < kChunks; ++m)
      if (dst / kLanes + 4 * m < Potential<H>::F) cp_async16(slot + dst + m * 4 * kLanes, src[m]);
  }
  // rows is 1 or -1
  __device__ __forceinline__ void advance(int rows) {
#pragma unroll
    for (int m = 0; m < kChunks; ++m) src[m] += rows == 1 ? stride[m] : -stride[m];
  }
};

template <int H>
__device__ __forceinline__ Potential<H> take(const float* src, int l) {
  Potential<H> p;
  each<H>(p, [&](float& v, int, int, int flat) { v = src[flat * kLanes + l]; });
  return p;
}

// p to the row under cursor c.
template <int H>
__device__ __forceinline__ void put(const Potential<H>& p, const Leaves& c, int N) {
  each<H>(p, [&](const float& v, int j, int k, int) {
    c.p[j][static_cast<ptrdiff_t>(k) * N] = v;
  });
}

// Inverse (packed upper triangle) and logdet of a packed symmetric PD
// matrix: the adjugate of smallmat.sym_inv_and_logdet times one reciprocal
// of the determinant.
template <int H>
__device__ __forceinline__ float sym_inv(const float* A, float* inv) {
  if constexpr (H == 1) {
    const float det = A[0];
    inv[0] = __frcp_rn(det);
    return __logf(det);
  } else if constexpr (H == 2) {
    const float a = A[0], b = A[1], d = A[2];
    const float det = a * d - b * b;
    const float r = __frcp_rn(det);
    inv[0] = d * r;
    inv[1] = -b * r;
    inv[2] = a * r;
    return __logf(det);
  } else {
    const float a = A[0], b = A[1], c = A[2], e = A[3], f = A[4], i = A[5];
    const float A11 = e * i - f * f;
    const float A12 = -(b * i - c * f);
    const float A13 = b * f - c * e;
    const float A22 = a * i - c * c;
    const float A23 = -(a * f - c * b);
    const float A33 = a * e - b * b;
    const float det = a * A11 + b * A12 + c * A13;
    const float r = __frcp_rn(det);
    inv[0] = A11 * r;
    inv[1] = A12 * r;
    inv[2] = A13 * r;
    inv[3] = A22 * r;
    inv[4] = A23 * r;
    inv[5] = A33 * r;
    return __logf(det);
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

// carry o e in chain order: e o carry in reverse.
template <int H, bool kReverse>
__device__ __forceinline__ Potential<H> fold_in(const Potential<H>& carry,
                                                const Potential<H>& e) {
  return kReverse ? combine<H>(e, carry) : combine<H>(carry, e);
}

// The rows [begin, end) of chunk c.
__device__ __forceinline__ void chunk_rows(int c, int T, int L, int offset, int& begin,
                                           int& end) {
  begin = max(c * L + offset, 0);
  end = min((c + 1) * L + offset, T);
}

// A thread's walk of `steps` elements through its ring.  fill(i) starts
// step i: its copies (none past the walk's end) and one commit group.  Steps
// 0 .. D - 2 start before the walk, and step i + D - 1 during step i, into
// the slot of step i - 1, whose element was read at step i - 2.  So "at
// most D - 3 groups pending" at step i means that step i + 1 has landed, and
// its element is read from shared memory while visit(i, e) combines step i.
// With kShared (RowCopy<H, true>) a thread reads other threads' copies, so
// every wait is followed by __syncwarp, which also keeps the warp within a
// step, so no thread refills a slot that another still reads.  Step i's
// fill comes before its combine with kShared and after it otherwise: the
// order that was faster on an H100 for each.
template <int H, bool kShared, typename Fill, typename Visit>
__device__ __forceinline__ void walk(float* ring, int steps, int l, Fill fill, Visit visit) {
  constexpr int D = kRing<H>;
#pragma unroll 1
  for (int i = 0; i < D - 1; ++i) fill(i);
  cp_async_wait<D - 2>();
  if constexpr (kShared) __syncwarp();
  const Potential<H> e0 = take<H>(slot<H>(ring, 0), l);
  fill(D - 1);
  visit(0, e0);
  cp_async_wait<D - 2>();
  if constexpr (kShared) __syncwarp();
  Potential<H> e = take<H>(slot<H>(ring, 1), l);
  for (int i = 1; i < steps; ++i) {
    cp_async_wait<D - 3>();
    if constexpr (kShared) __syncwarp();
    const Potential<H> next = take<H>(slot<H>(ring, i + 1), l);
    if constexpr (kShared) {
      fill(i + D - 1);
      visit(i, e);
    } else {
      visit(i, e);
      fill(i + D - 1);
    }
    e = next;
  }
}

// grid (ceil(N / kLanes), C): phase 1, the scan of chunk blockIdx.y, and
// the chunk's total into totals (unless totals is null).
template <int H, bool kReverse, bool kShared>
__global__ void __launch_bounds__(kLanes)
kalman_lane_scan_kernel(Leaves in, Leaves out, Leaves totals, int T, int N, int L, int offset) {
  constexpr int dir = kReverse ? -1 : 1;
  __shared__ __align__(16) float ring[kRing<H> * Potential<H>::F * kLanes];
  const int l = threadIdx.x, n0 = blockIdx.x * kLanes, n = n0 + l;
  if (!kShared && n >= N) return;  // (kShared: every block is full)
  int begin, end;
  chunk_rows(blockIdx.y, T, L, offset, begin, end);
  const int steps = end - begin, first = kReverse ? end - 1 : begin;
  RowCopy<H, kShared> rd(in, first, N, n0, l);
  Leaves wr = cursor<H>(out, first, N, n);
  Potential<H> carry;
  walk<H, kShared>(
      ring, steps, l,
      [&](int i) {
        if (i < steps) rd.copy(slot<H>(ring, i));
        rd.advance(dir);
        cp_async_commit();
      },
      [&](int i, const Potential<H>& e) {
        carry = i == 0 ? e : fold_in<H, kReverse>(carry, e);
        put<H>(carry, wr, N);
        advance<H, dir>(wr, N);
      });
  if (totals.p[5] != nullptr) put<H>(carry, cursor<H>(totals, blockIdx.y, N, n), N);
}

// grid (ceil(N / kLanes), C): phases 2-3 for chunk blockIdx.y.  One walk:
// the totals of the chunks before it in chain order, folded into the
// carry-in, then the chunk's rows, each combined with the carry-in and
// written back in place.
template <int H, bool kReverse, bool kShared>
__global__ void __launch_bounds__(kLanes)
kalman_lane_fixup_kernel(Leaves out, Leaves totals, int T, int N, int L, int offset, int C) {
  __shared__ __align__(16) float ring[kRing<H> * Potential<H>::F * kLanes];
  const int l = threadIdx.x, n0 = blockIdx.x * kLanes, n = n0 + l;
  const int c = blockIdx.y;
  // the first chunk in chain order has no carry-in
  if ((!kShared && n >= N) || c == (kReverse ? C - 1 : 0)) return;
  int begin, end;
  chunk_rows(c, T, L, offset, begin, end);
  const int before = kReverse ? C - 1 - c : c;  // totals in the carry-in
  const int steps = before + end - begin;
  // the totals from the first in chain order on, then (from step before)
  // the chunk's rows
  RowCopy<H, kShared> rd(totals, kReverse ? C - 1 : 0, N, n0, l);
  Leaves wr = cursor<H>(out, begin, N, n);
  Potential<H> acc;
  walk<H, kShared>(
      ring, steps, l,
      [&](int i) {
        if (i == before) rd = RowCopy<H, kShared>(out, begin, N, n0, l);
        if (i < steps) rd.copy(slot<H>(ring, i));
        rd.advance(i < before && kReverse ? -1 : 1);
        cp_async_commit();
      },
      [&](int i, const Potential<H>& e) {
        if (i < before) {
          acc = i == 0 ? e : fold_in<H, kReverse>(acc, e);
        } else {
          put<H>(fold_in<H, kReverse>(acc, e), wr, N);
          advance<H, 1>(wr, N);
        }
      });
}

Leaves leaves(const void* const* p) {
  Leaves x;
  for (int j = 0; j < 6; ++j) x.p[j] = static_cast<float*>(const_cast<void*>(p[j]));
  return x;
}

template <int H, bool kReverse, bool kShared>
int launch(const Leaves& in, const Leaves& out, const Leaves& totals, int T, int N, int C, int L,
           int offset, cudaStream_t stream) {
  const dim3 grid((N + kLanes - 1) / kLanes, C);
  kalman_lane_scan_kernel<H, kReverse, kShared><<<grid, kLanes, 0, stream>>>(in, out, totals, T,
                                                                             N, L, offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  kalman_lane_fixup_kernel<H, kReverse, kShared><<<grid, kLanes, 0, stream>>>(out, totals, T, N,
                                                                              L, offset, C);
  return static_cast<int>(cudaGetLastError());
}

// Whether every leaf of x (or x is null, as the totals of a one-pass scan)
// is 16-byte aligned.
bool aligned16(const Leaves& x) {
  for (const float* p : x.p)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

template <int H>
int launch(const void* const* in, void* const* out, void* const* totals, int T, int N, int C,
           int L, int offset, int reverse, cudaStream_t stream) {
  const Leaves src = leaves(in), dst = leaves(out), tot = leaves(totals);
  // 16-byte row chunks where every block is full and every row of every
  // leaf starts 16-byte aligned
  if (N % kLanes == 0 && aligned16(src) && aligned16(dst) && aligned16(tot))
    return reverse ? launch<H, true, true>(src, dst, tot, T, N, C, L, offset, stream)
                   : launch<H, false, true>(src, dst, tot, T, N, C, L, offset, stream);
  return reverse ? launch<H, true, false>(src, dst, tot, T, N, C, L, offset, stream)
                 : launch<H, false, false>(src, dst, tot, T, N, C, L, offset, stream);
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
