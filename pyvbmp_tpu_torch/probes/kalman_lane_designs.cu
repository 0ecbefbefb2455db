// Two designs of the lane Kalman scan measured against the kernel of
// csrc/kalman_lane_scan.cu (included below, so they share its element
// layout, ring, walk and combine) by pyvbmp_tpu_torch/probes/lane_designs.py.
// Both copy each thread's own lane, 4 bytes a component (RowCopy<H, false>).
//
// kalman_lane_split_f32: one lane's combine split over two threads, a lead
// and a follower, each in a warp of its own (a block of 64 threads for 32
// lanes).  In chain order e1 o e2 the outputs Jbb, hb, Jab and logw of a
// forward step (carry o e) depend only on the carry's Jbb, hb, Jab and
// logw and on e; the carry's Jaa and ha feed only the next Jaa and ha:
//   Jaa' = Jaa - G M^-1 G',  ha' = ha - G M^-1 m,  G = the carry's Jab,
// with M^-1 and m (M^-1 m) of the step.  In reverse (e o carry) the roles of
// (Jaa, ha) and (Jbb, hb) swap and G is the carry's Jab transposed.  So the
// lead walks the closed recursion alone, through the kernel's ring, and
// hands each step's M^-1, G and M^-1 m to the follower through a queue in
// shared memory; the follower folds them into the other two outputs.  The
// hand-off runs one way: the lead waits only when the queue is full.
// Phase 1 of the fold runs the same kernel per chunk; the fix-up is the
// kernel's own.
//
// kalman_lane_lookback_f32: the time fold in one launch with a decoupled
// look-back.  A block takes a ticket on entry; tickets go to the chunks in
// chain order, so a block waits only on blocks that took theirs before it.
// A chunk walks its rows once to its total and publishes it (a flag per
// chunk and lane block, set with release order once the totals are
// written), waits for the totals of the chunks before it in chain order,
// folds them into its carry-in and walks its rows again from there,
// writing each output row once (the first chunk in chain order writes on
// its first walk).

#include "../csrc/kalman_lane_scan.cu"

namespace {

// Queue entries a lane holds between lead and follower.
template <int H>
constexpr int kQueue = H == 1 ? 16 : 8;

// Floats of a queue entry: M^-1 (packed), G (row-major), M^-1 m.  Step 0
// carries the first element's follower components in the M^-1 and M^-1 m
// slots instead.
template <int H>
constexpr int kEntry = Potential<H>::S + H * H + H;

__device__ __forceinline__ int ld_acquire_shared(const int* p) {
  int v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_shared(int* p, int v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.release.cta.shared.s32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// Whether leaf j (Jaa, Jab, Jbb, ha, hb, logw) is the follower's: Jaa and
// ha forward, Jbb and hb in reverse.
template <bool kReverse>
__device__ constexpr bool follower_leaf(int j) {
  return kReverse ? j == 2 || j == 4 : j == 0 || j == 3;
}

// The lead's part of one step: the closed outputs of e1 o e2 (carry o e
// forward, e o carry in reverse) in the kernel's order of operations, and
// M^-1 and M^-1 m for the follower.  The follower's outputs are left unset.
template <int H, bool kReverse>
__device__ __forceinline__ Potential<H> lead_combine(const Potential<H>& e1,
                                                     const Potential<H>& e2, float* Minv,
                                                     float* Mh) {
  constexpr int S = Potential<H>::S;
  float M[S], hmid[H];
#pragma unroll
  for (int k = 0; k < S; ++k) M[k] = e1.Jbb[k] + e2.Jaa[k];
#pragma unroll
  for (int k = 0; k < H; ++k) hmid[k] = e1.hb[k] + e2.ha[k];
  const float logdetM = sym_inv<H>(M, Minv);
  float MJ1[H * H], MJ2[H * H];
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
      float acc = 0.0f;
      if constexpr (kReverse) {  // Jaa from e1
#pragma unroll
        for (int m = 0; m < H; ++m) acc += e1.Jab[i * H + m] * MJ1[m * H + j];
        out.Jaa[sym_pos(H, i, j)] = e1.Jaa[sym_pos(H, i, j)] - acc;
      } else {  // Jbb from e2
#pragma unroll
        for (int m = 0; m < H; ++m) acc += e2.Jab[m * H + i] * MJ2[m * H + j];
        out.Jbb[sym_pos(H, i, j)] = e2.Jbb[sym_pos(H, i, j)] - acc;
      }
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      float ab = 0.0f;
#pragma unroll
      for (int m = 0; m < H; ++m) ab += e1.Jab[i * H + m] * MJ2[m * H + j];
      out.Jab[i * H + j] = -ab;
    }
    float acc = 0.0f;
    if constexpr (kReverse) {
#pragma unroll
      for (int m = 0; m < H; ++m) acc += e1.Jab[i * H + m] * Mh[m];
      out.ha[i] = e1.ha[i] - acc;
    } else {
#pragma unroll
      for (int m = 0; m < H; ++m) acc += e2.Jab[m * H + i] * Mh[m];
      out.hb[i] = e2.hb[i] - acc;
    }
  }
  float hMh = 0.0f;
#pragma unroll
  for (int k = 0; k < H; ++k) hMh += hmid[k] * Mh[k];
  out.w = e1.w + e2.w + 0.5f * hMh - 0.5f * logdetM + 0.5f * H * kLog2Pi;
  return out;
}

// The follower's components of p (X: Jaa or Jbb, y: ha or hb).
template <int H, bool kReverse>
__device__ __forceinline__ const float* follower_X(const Potential<H>& p) {
  return kReverse ? p.Jbb : p.Jaa;
}
template <int H, bool kReverse>
__device__ __forceinline__ const float* follower_y(const Potential<H>& p) {
  return kReverse ? p.hb : p.ha;
}

// grid (ceil(N / kLanes), C), 2 kLanes threads: phase 1 (the scan of chunk
// blockIdx.y, and its total into totals unless totals is null), the lead in
// warp 0 and the follower in warp 1.
template <int H, bool kReverse>
__global__ void __launch_bounds__(2 * kLanes)
kalman_lane_split_kernel(Leaves in, Leaves out, Leaves totals, int T, int N, int L, int offset) {
  constexpr int S = Potential<H>::S, E = kEntry<H>, Q = kQueue<H>, dir = kReverse ? -1 : 1;
  __shared__ __align__(16) float ring[kRing<H> * Potential<H>::F * kLanes];
  __shared__ float queue[Q * E * kLanes];
  __shared__ int ready[kLanes], done[kLanes];  // steps handed off / taken, per lane
  const int l = threadIdx.x % kLanes, n = blockIdx.x * kLanes + l;
  const bool lead = threadIdx.x < kLanes;
  if (lead) ready[l] = done[l] = 0;
  __syncthreads();
  if (n >= N) return;
  int begin, end;
  chunk_rows(blockIdx.y, T, L, offset, begin, end);
  const int steps = end - begin, first = kReverse ? end - 1 : begin;
  Leaves wr = cursor<H>(out, first, N, n);
  if (lead) {
    Leaves rd = cursor<H>(in, first, N, n);
    Potential<H> carry;
    walk<H, false>(
        ring, steps, l,
        [&](int i) {
          if (i < steps) fetch<H>(slot<H>(ring, i), rd, N, l);
          advance<H, dir>(rd, N);
          cp_async_commit();
        },
        [&](int i, const Potential<H>& e) {
          // entries i .. i + Q/2 - 1 take the slots of steps up to i - Q/2 - 1
          if (i >= Q && (i & (Q / 2 - 1)) == 0)
            while (ld_acquire_shared(done + l) < i - Q / 2) {
            }
          float* q = queue + (i & (Q - 1)) * E * kLanes + l;
          if (i == 0) {
            carry = e;
#pragma unroll
            for (int k = 0; k < S; ++k) q[k * kLanes] = follower_X<H, kReverse>(e)[k];
#pragma unroll
            for (int k = 0; k < H; ++k) q[(S + H * H + k) * kLanes] = follower_y<H, kReverse>(e)[k];
          } else {
            float Minv[S], Mh[H];
#pragma unroll
            for (int k = 0; k < H * H; ++k) q[(S + k) * kLanes] = carry.Jab[k];
            carry = kReverse ? lead_combine<H, true>(e, carry, Minv, Mh)
                             : lead_combine<H, false>(carry, e, Minv, Mh);
#pragma unroll
            for (int k = 0; k < S; ++k) q[k * kLanes] = Minv[k];
#pragma unroll
            for (int k = 0; k < H; ++k) q[(S + H * H + k) * kLanes] = Mh[k];
          }
          st_release_shared(ready + l, i + 1);
          each<H>(carry, [&](const float& v, int j, int k, int) {
            if (!follower_leaf<kReverse>(j)) wr.p[j][static_cast<ptrdiff_t>(k) * N] = v;
          });
          advance<H, dir>(wr, N);
        });
    if (totals.p[5] != nullptr) {
      const Leaves t = cursor<H>(totals, blockIdx.y, N, n);
      each<H>(carry, [&](const float& v, int j, int k, int) {
        if (!follower_leaf<kReverse>(j)) t.p[j][static_cast<ptrdiff_t>(k) * N] = v;
      });
    }
    return;
  }
  // the follower: X and y of the carry, leaves 0 and 3 forward, 2 and 4 in reverse
  constexpr int jX = kReverse ? 2 : 0, jy = kReverse ? 4 : 3;
  float X[S], y[H];
  int avail = 0;
  for (int i = 0; i < steps; ++i) {
    while (avail <= i) avail = ld_acquire_shared(ready + l);
    const float* q = queue + (i & (Q - 1)) * E * kLanes + l;
    if (i == 0) {
#pragma unroll
      for (int k = 0; k < S; ++k) X[k] = q[k * kLanes];
#pragma unroll
      for (int k = 0; k < H; ++k) y[k] = q[(S + H * H + k) * kLanes];
    } else {
      float Minv[S], G[H * H], Mh[H], MG[H * H];
#pragma unroll
      for (int k = 0; k < S; ++k) Minv[k] = q[k * kLanes];
#pragma unroll
      for (int k = 0; k < H * H; ++k) G[k] = q[(S + k) * kLanes];
#pragma unroll
      for (int k = 0; k < H; ++k) Mh[k] = q[(S + H * H + k) * kLanes];
      // as combine: forward MJ1 = M^-1 J1ab', Jaa -= J1ab MJ1, ha -= J1ab M^-1 m;
      // reverse MJ2 = M^-1 J2ab, Jbb -= J2ab' MJ2, hb -= J2ab' M^-1 m
#pragma unroll
      for (int i2 = 0; i2 < H; ++i2)
#pragma unroll
        for (int j = 0; j < H; ++j) {
          float s = 0.0f;
#pragma unroll
          for (int m = 0; m < H; ++m)
            s += Minv[sym_pos(H, i2, m)] * (kReverse ? G[m * H + j] : G[j * H + m]);
          MG[i2 * H + j] = s;
        }
#pragma unroll
      for (int i2 = 0; i2 < H; ++i2) {
#pragma unroll
        for (int j = i2; j < H; ++j) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < H; ++m)
            acc += (kReverse ? G[m * H + i2] : G[i2 * H + m]) * MG[m * H + j];
          X[sym_pos(H, i2, j)] -= acc;
        }
        float acc = 0.0f;
#pragma unroll
        for (int m = 0; m < H; ++m) acc += (kReverse ? G[m * H + i2] : G[i2 * H + m]) * Mh[m];
        y[i2] -= acc;
      }
    }
    if ((i & (Q / 2 - 1)) == Q / 2 - 1) st_release_shared(done + l, i + 1);
#pragma unroll
    for (int k = 0; k < S; ++k) wr.p[jX][static_cast<ptrdiff_t>(k) * N] = X[k];
#pragma unroll
    for (int k = 0; k < H; ++k) wr.p[jy][static_cast<ptrdiff_t>(k) * N] = y[k];
    advance<H, dir>(wr, N);
  }
  if (totals.p[5] != nullptr) {
    const Leaves t = cursor<H>(totals, blockIdx.y, N, n);
#pragma unroll
    for (int k = 0; k < S; ++k) t.p[jX][static_cast<ptrdiff_t>(k) * N] = X[k];
#pragma unroll
    for (int k = 0; k < H; ++k) t.p[jy][static_cast<ptrdiff_t>(k) * N] = y[k];
  }
}

template <int H, bool kReverse>
int launch_split(const Leaves& in, const Leaves& out, const Leaves& totals, int T, int N, int C,
                 int L, int offset, cudaStream_t stream) {
  const dim3 grid((N + kLanes - 1) / kLanes, C);
  kalman_lane_split_kernel<H, kReverse><<<grid, 2 * kLanes, 0, stream>>>(in, out, totals, T, N,
                                                                         L, offset);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || C == 1) return static_cast<int>(err);
  kalman_lane_fixup_kernel<H, kReverse, false><<<grid, kLanes, 0, stream>>>(out, totals, T, N, L,
                                                                     offset, C);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ int ld_acquire_global(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_global(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// grid ceil(N / kLanes) * C blocks.  flags: C * ceil(N / kLanes) chunk
// flags and the ticket counter, zero at launch.
template <int H, bool kReverse>
__global__ void __launch_bounds__(kLanes)
kalman_lane_lookback_kernel(Leaves in, Leaves out, Leaves totals, int* flags, int T, int N,
                            int L, int offset, int C) {
  constexpr int dir = kReverse ? -1 : 1;
  __shared__ __align__(16) float ring[kRing<H> * Potential<H>::F * kLanes];
  const int blocks = (N + kLanes - 1) / kLanes;
  const int l = threadIdx.x;
  int ticket = 0;
  if (l == 0) ticket = atomicAdd(flags + C * blocks, 1);
  ticket = __shfl_sync(0xffffffffu, ticket, 0);
  const int order = ticket / blocks, b = ticket - order * blocks;
  const int c = kReverse ? C - 1 - order : order;
  const int n = b * kLanes + l;
  if (n >= N) return;
  const int lanes = min(kLanes, N - b * kLanes);
  const unsigned mask = lanes == kLanes ? 0xffffffffu : (1u << lanes) - 1u;
  int begin, end;
  chunk_rows(c, T, L, offset, begin, end);
  const int steps = end - begin, first = kReverse ? end - 1 : begin;
  Leaves rd = cursor<H>(in, first, N, n), wr = cursor<H>(out, first, N, n);
  auto fill = [&](int i) {
    if (i < steps) fetch<H>(slot<H>(ring, i), rd, N, l);
    advance<H, dir>(rd, N);
    cp_async_commit();
  };
  Potential<H> carry;
  walk<H, false>(ring, steps, l, fill, [&](int i, const Potential<H>& e) {
    carry = i == 0 ? e : fold_in<H, kReverse>(carry, e);
    if (order == 0) {
      put<H>(carry, wr, N);
      advance<H, dir>(wr, N);
    }
  });
  if (order < C - 1) {  // the last chunk's total has no reader
    put<H>(carry, cursor<H>(totals, c, N, n), N);
    __threadfence();
    __syncwarp(mask);
    if (l == 0) st_release_global(flags + c * blocks + b, 1);
  }
  if (order == 0) return;
  Potential<H> acc;
  for (int k = 0; k < order; ++k) {
    const int pc = kReverse ? C - 1 - k : k;
    while (ld_acquire_global(flags + pc * blocks + b) == 0) {
    }
    const Leaves t = cursor<H>(totals, pc, N, n);
    Potential<H> total;
    each<H>(total, [&](float& v, int j, int kk, int) {
      v = __ldcg(t.p[j] + static_cast<ptrdiff_t>(kk) * N);
    });
    acc = k == 0 ? total : fold_in<H, kReverse>(acc, total);
  }
  rd = cursor<H>(in, first, N, n);
  walk<H, false>(ring, steps, l, fill, [&](int i, const Potential<H>& e) {
    carry = fold_in<H, kReverse>(i == 0 ? acc : carry, e);
    put<H>(carry, wr, N);
    advance<H, dir>(wr, N);
  });
}

template <int H, bool kReverse>
int launch_lookback(const Leaves& in, const Leaves& out, const Leaves& totals, int* flags, int T,
                    int N, int C, int L, int offset, cudaStream_t stream) {
  const int blocks = (N + kLanes - 1) / kLanes;
  const cudaError_t err =
      cudaMemsetAsync(flags, 0, sizeof(int) * (static_cast<size_t>(C) * blocks + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kalman_lane_lookback_kernel<H, kReverse><<<blocks * C, kLanes, 0, stream>>>(
      in, out, totals, flags, T, N, L, offset, C);
  return static_cast<int>(cudaGetLastError());
}

template <int H>
int dispatch(int design, const void* const* in, void* const* out, void* const* totals, int* flags,
             int T, int N, int C, int L, int offset, int reverse, cudaStream_t s) {
  const Leaves a = leaves(in), b = leaves(out), t = leaves(totals);
  if (design == 0)
    return reverse ? launch_split<H, true>(a, b, t, T, N, C, L, offset, s)
                   : launch_split<H, false>(a, b, t, T, N, C, L, offset, s);
  return reverse ? launch_lookback<H, true>(a, b, t, flags, T, N, C, L, offset, s)
                 : launch_lookback<H, false>(a, b, t, flags, T, N, C, L, offset, s);
}

int entry(int design, const void* const* in, void* const* out, void* const* tot, void* flags,
          int T, int H, int N, int C, int L, int offset, int reverse, void* stream) {
  if (C > 1)
    for (int j = 0; j < 6; ++j)
      if (tot[j] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (design == 1 && (C < 2 || flags == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  int* f = static_cast<int*>(flags);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 1: return dispatch<1>(design, in, out, tot, f, T, N, C, L, offset, reverse, s);
    case 2: return dispatch<2>(design, in, out, tot, f, T, N, C, L, offset, reverse, s);
    case 3: return dispatch<3>(design, in, out, tot, f, T, N, C, L, offset, reverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The arguments of kalman_lane_scan_f32.
extern "C" int kalman_lane_split_f32(
    const void* Jaa, const void* Jab, const void* Jbb, const void* ha,
    const void* hb, const void* logw, void* oJaa, void* oJab, void* oJbb,
    void* oha, void* ohb, void* ologw, void* tJaa, void* tJab, void* tJbb,
    void* tha, void* thb, void* tlogw, int T, int H, int N, int C, int L,
    int offset, int reverse, void* stream) {
  const void* in[6] = {Jaa, Jab, Jbb, ha, hb, logw};
  void* out[6] = {oJaa, oJab, oJbb, oha, ohb, ologw};
  void* tot[6] = {tJaa, tJab, tJbb, tha, thb, tlogw};
  return entry(0, in, out, tot, nullptr, T, H, N, C, L, offset, reverse, stream);
}

// The arguments of kalman_lane_scan_f32 with the look-back's flags (C *
// ceil(N / 32) + 1 ints of scratch) after the totals; C > 1 only.
extern "C" int kalman_lane_lookback_f32(
    const void* Jaa, const void* Jab, const void* Jbb, const void* ha,
    const void* hb, const void* logw, void* oJaa, void* oJab, void* oJbb,
    void* oha, void* ohb, void* ologw, void* tJaa, void* tJab, void* tJbb,
    void* tha, void* thb, void* tlogw, void* flags, int T, int H, int N, int C,
    int L, int offset, int reverse, void* stream) {
  const void* in[6] = {Jaa, Jab, Jbb, ha, hb, logw};
  void* out[6] = {oJaa, oJab, oJbb, oha, ohb, ologw};
  void* tot[6] = {tJaa, tJab, tJbb, tha, thb, tlogw};
  return entry(1, in, out, tot, flags, T, H, N, C, L, offset, reverse, stream);
}
