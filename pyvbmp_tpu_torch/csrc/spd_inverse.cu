// Batched inverse and log-determinant of small symmetric positive-definite
// matrices (1 <= n <= 32) in float32, from one Cholesky factor each:
// inv = L^-T L^-1 and logdet = 2 sum_i log L_ii, where A = L L^T.
//
// Replaces no TPU kernel: in the JAX package these inverses are XLA's
// Cholesky and triangular solves.  It exists because the port's library
// route, torch.linalg.cholesky_ex then torch.cholesky_inverse, runs MAGMA's
// batched triangular solves (the largest tensor-algebra kernels of a large
// DMBD sweep), reads MAGMA's `info` on the host after every inverse (a
// stream sync each call) and, at n >= 26, allocates and frees a workspace
// with cudaMalloc/cudaFree in every call.  This kernel allocates nothing,
// reads nothing back and launches once a call.  Its callers are
// ops/spd_inverse.py (utils/linalg.py:psd_inv*, ops/planemat.py:
// bsym_inv_and_logdet).
//
// Layout: a batch of `count` matrices, matrix g = b * lanes + l starting
// at b * sb + l * sl, entry (i, j) at + i * sr + j * sc, in floats; the
// input is read in place from any such strides (the plane layout
// (..., n, n, N) has sl = 1, the dense (..., n, n) sc = 1), the output is
// written through its own strides.  `symmetrize` reads (A + A^T) / 2 and
// adds `jitter` to the diagonal; otherwise the lower triangle is read as it
// is (jitter 0), as cholesky_ex reads it.  A matrix whose factorization
// fails (a pivot not > 0, or NaN) gets an inverse and a log-determinant of
// NaN; the other matrices of the batch are unaffected.  Full float32
// throughout: no tensor cores, no TF32.
//
// Design.  The mapping follows n:
//   - n <= 8 (a template per n): one thread per matrix, 128 a block, the
//     factor, its inverse and the product in registers (fully unrolled).
//   - 8 < n <= 32 (rungs 16 and 32): one warp per matrix, 8 a block; the
//     matrix in shared memory (rows padded to n + 1), a right-looking
//     Cholesky with a lane per column of the trailing update, then each lane
//     forms one column of L^-1 in registers by forward substitution and one
//     column of L^-T L^-1 from the columns the others left in shared memory.
// Loads and stores go through shared memory in whichever order keeps them
// coalesced: where the lanes are minor (sl == 1) neighbouring threads take
// neighbouring matrices' same entry, else the block walks its matrices'
// entries in turn.  The output is exactly symmetric (inv[i][j] and inv[j][i]
// are the same sum in the same order).
//
// What bounds it on an H100: bytes, n^2 floats read and n^2 written a
// matrix (the symmetrized read; the lower triangle alone otherwise) against
// 3.35 TB/s; the arithmetic, ~n^3 FMAs a matrix, is small beside it at
// n <= 8, where the batches are large (a Lorenz sweep's 399 x 1000 latent
// 6 x 6 matrices).  The design's answer is one read and one write of each
// entry, coalesced, with nothing in between kept in device memory.  At
// n = 26-27 the batches are a few thousand matrices, latency-bound on the
// warp's dependent Cholesky steps; a block holds 8 of them so that the
// card's SMs each run several.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace spd_inverse {

constexpr int kThreadMatrices = 128;  // n <= 8: matrices (threads) of a block
constexpr int kWarpMatrices = 8;      // 8 < n <= 32: matrices (warps) of a block

struct Batch {
  long long lanes;           // matrix g is (b, l) = (g / lanes, g % lanes)
  long long sb, sl, sr, sc;  // strides of b, l, row and column, in floats
};

__device__ __forceinline__ long long matrix_offset(const Batch& t, long long g) {
  const long long b = g / t.lanes;
  return b * t.sb + (g - b * t.lanes) * t.sl;
}

// ---------------------------------------------------------------- n <= 8
template <int N>
__global__ void __launch_bounds__(kThreadMatrices)
spd_inverse_thread(const float* __restrict__ A, float* __restrict__ inv,
                   float* __restrict__ logdet, long long count, Batch in, Batch out,
                   int symmetrize, float jitter) {
  constexpr int NN = N * N;
  constexpr int P = NN | 1;  // odd pitch: 32 threads on 32 matrices hit 32 banks
  __shared__ float tile[kThreadMatrices * P];
  __shared__ long long in_base[kThreadMatrices], out_base[kThreadMatrices];
  const int t = threadIdx.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * kThreadMatrices;
  const int m_count = static_cast<int>(min(static_cast<long long>(kThreadMatrices), count - g0));
  if (t < m_count) {
    in_base[t] = matrix_offset(in, g0 + t);
    out_base[t] = matrix_offset(out, g0 + t);
  }
  __syncthreads();

  if (in.sl == 1) {  // lanes minor: each thread its own matrix
    if (t < m_count) {
#pragma unroll
      for (int e = 0; e < NN; ++e) {
        const int i = e / N, j = e % N;
        if (symmetrize || i >= j) tile[t * P + e] = A[in_base[t] + i * in.sr + j * in.sc];
      }
    }
  } else {  // the block walks its matrices' entries in turn
    for (int idx = t; idx < m_count * NN; idx += kThreadMatrices) {
      const int m = idx / NN, e = idx - m * NN;
      tile[m * P + e] = A[in_base[m] + (e / N) * in.sr + (e % N) * in.sc];
    }
  }
  __syncthreads();

  if (t < m_count) {
    float* s = tile + t * P;
    float L[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float a = symmetrize ? 0.5f * (s[i * N + j] + s[j * N + i]) : s[i * N + j];
        L[i][j] = i == j ? a + jitter : a;
      }
    // Cholesky, column by column (dot-product form)
    bool ok = true;
    float ld = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float d = L[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
      ok = ok && d > 0.f;
      const float ljj = sqrtf(d);
      const float r = 1.f / ljj;
      ld += logf(ljj);
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        float v = L[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
        L[i][j] = v * r;
      }
      L[j][j] = r;  // the diagonal of L^-1, which is all the inverse needs of it
    }
    // L^-1 in place, column by column, top down
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        float v = 0.f;
#pragma unroll
        for (int k = j; k < i; ++k) v += L[i][k] * L[k][j];
        L[i][j] = -v * L[i][i];
      }
    // inv = L^-T L^-1, lower triangle, mirrored
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        float v = 0.f;
#pragma unroll
        for (int k = i; k < N; ++k) v += L[k][i] * L[k][j];
        v = ok ? v : CUDART_NAN_F;
        s[i * N + j] = v;
        s[j * N + i] = v;
      }
    if (logdet != nullptr) logdet[g0 + t] = ok ? 2.f * ld : CUDART_NAN_F;
  }
  __syncthreads();

  if (out.sl == 1) {
    if (t < m_count) {
#pragma unroll
      for (int e = 0; e < NN; ++e)
        inv[out_base[t] + (e / N) * out.sr + (e % N) * out.sc] = tile[t * P + e];
    }
  } else {
    for (int idx = t; idx < m_count * NN; idx += kThreadMatrices) {
      const int m = idx / NN, e = idx - m * NN;
      inv[out_base[m] + (e / N) * out.sr + (e % N) * out.sc] = tile[m * P + e];
    }
  }
}

// ------------------------------------------------------------ 8 < n <= 32
// A matrix's rows are NMAX + 1 floats apart (a warp on one row's columns,
// or on one column's rows, hits distinct banks), matrices kPitch apart,
// kPitch = 4 (mod 32): where the lanes are minor, a warp copies 4 columns
// of 8 matrices, and those 32 words fall in 32 banks.
template <int NMAX>
struct WarpTile {
  static constexpr int kRow = NMAX + 1;
  static constexpr int kPitch = NMAX * kRow + ((4 - NMAX * kRow % 32) + 32) % 32;
};

// Thread t's (matrix, column) in a copy of the block's matrices: lanes
// minor, 8 consecutive threads on 8 matrices' same column; else a warp on
// its own matrix, a lane a column.
__device__ __forceinline__ void copy_slot(bool lanes_minor, int t, int& m, int& c) {
  if (lanes_minor) {
    m = t % kWarpMatrices;
    c = t / kWarpMatrices;
  } else {
    m = t / 32;
    c = t % 32;
  }
}

template <int NMAX>
__global__ void __launch_bounds__(32 * kWarpMatrices)
spd_inverse_warp(const float* __restrict__ A, float* __restrict__ inv,
                 float* __restrict__ logdet, long long count, int n, Batch in, Batch out,
                 int symmetrize, float jitter) {
  constexpr int R = WarpTile<NMAX>::kRow;
  constexpr int M = WarpTile<NMAX>::kPitch;
  __shared__ float tile[kWarpMatrices * M];
  __shared__ long long in_base[kWarpMatrices], out_base[kWarpMatrices];
  const int t = threadIdx.x, lane = t % 32, w = t / 32;
  const long long g0 = static_cast<long long>(blockIdx.x) * kWarpMatrices;
  const int m_count = static_cast<int>(min(static_cast<long long>(kWarpMatrices), count - g0));
  if (t < m_count) {
    in_base[t] = matrix_offset(in, g0 + t);
    out_base[t] = matrix_offset(out, g0 + t);
  }
  __syncthreads();

  int m, c;
  copy_slot(in.sl == 1, t, m, c);
  if (m < m_count && c < n)
    for (int i = symmetrize ? 0 : c; i < n; ++i)
      tile[m * M + i * R + c] = A[in_base[m] + i * in.sr + c * in.sc];
  __syncthreads();

  if (w < m_count) {  // warp w: matrix w
    float* S = tile + w * M;
    if (lane < n) {
      if (symmetrize)
        for (int i = lane + 1; i < n; ++i)
          S[i * R + lane] = 0.5f * (S[i * R + lane] + S[lane * R + i]);
      S[lane * R + lane] += jitter;
    }
    __syncwarp();

    // Cholesky, right-looking: column j scaled, then the trailing lower
    // triangle updated, lane k on column k
    bool ok = true;
    for (int j = 0; j < n; ++j) {
      const float d = S[j * R + j];
      ok = ok && d > 0.f;
      const float ljj = sqrtf(d);
      const float r = 1.f / ljj;
      __syncwarp();
      if (lane == j)
        S[j * R + j] = ljj;
      else if (lane > j && lane < n)
        S[lane * R + j] *= r;
      __syncwarp();
      if (lane > j && lane < n) {
        const float lkj = S[lane * R + j];
        for (int i = j + 1; i < n; ++i)
          if (i >= lane) S[i * R + lane] -= S[i * R + j] * lkj;
      }
      __syncwarp();
    }
    float ld = lane < n ? logf(S[lane * R + lane]) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) ld += __shfl_xor_sync(0xffffffffu, ld, off);

    // column `lane` of L^-1 by forward substitution
    float x[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      float v = 0.f;
      if (i < n) {
        v = i == lane ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < i; ++k) v -= S[i * R + k] * x[k];
        v *= 1.f / S[i * R + i];
      }
      x[i] = v;
    }
    __syncwarp();
    // L^-1 over L in shared memory (its lower triangle; x[k] = 0 for k < lane)
#pragma unroll
    for (int k = 0; k < NMAX; ++k)
      if (k < n && k >= lane) S[k * R + lane] = x[k];
    __syncwarp();
    // column `lane` of L^-T L^-1: inv[i][lane] = sum_{k >= i} Linv[k][i] Linv[k][lane]
    float y[NMAX];
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      float v = 0.f;
#pragma unroll
      for (int k = i; k < NMAX; ++k)
        if (k < n) v += S[k * R + i] * x[k];
      y[i] = ok ? v : CUDART_NAN_F;
    }
    __syncwarp();
    if (lane < n) {
#pragma unroll
      for (int i = 0; i < NMAX; ++i)
        if (i < n) S[i * R + lane] = y[i];
    }
    if (lane == 0 && logdet != nullptr) logdet[g0 + w] = ok ? 2.f * ld : CUDART_NAN_F;
  }
  __syncthreads();

  copy_slot(out.sl == 1, t, m, c);
  if (m < m_count && c < n)
    for (int i = 0; i < n; ++i)
      inv[out_base[m] + i * out.sr + c * out.sc] = tile[m * M + i * R + c];
}

template <int N>
cudaError_t launch_thread(const float* A, float* inv, float* logdet, long long count,
                          const Batch& in, const Batch& out, int symmetrize, float jitter,
                          cudaStream_t st) {
  const long long blocks = (count + kThreadMatrices - 1) / kThreadMatrices;
  spd_inverse_thread<N><<<static_cast<unsigned>(blocks), kThreadMatrices, 0, st>>>(
      A, inv, logdet, count, in, out, symmetrize, jitter);
  return cudaGetLastError();
}

template <int NMAX>
cudaError_t launch_warp(const float* A, float* inv, float* logdet, long long count, int n,
                        const Batch& in, const Batch& out, int symmetrize, float jitter,
                        cudaStream_t st) {
  const long long blocks = (count + kWarpMatrices - 1) / kWarpMatrices;
  spd_inverse_warp<NMAX><<<static_cast<unsigned>(blocks), 32 * kWarpMatrices, 0, st>>>(
      A, inv, logdet, count, n, in, out, symmetrize, jitter);
  return cudaGetLastError();
}

}  // namespace spd_inverse

// A: `count` >= 1 matrices of n x n floats (1 <= n <= 32); matrix g = b *
// lanes + l at b * in_sb + l * in_sl, entry (i, j) at + i * in_sr + j *
// in_sc; inv written the same way through the out_* strides; logdet
// (count,) contiguous, or NULL to skip it.  symmetrize: read (A + A^T) / 2
// plus jitter on the diagonal, else A's lower triangle.  Returns 0 on a
// clean launch, the cudaGetLastError() code otherwise, and
// cudaErrorInvalidValue for an n or a count out of range.
extern "C" int spd_inverse_f32(const void* A, void* inv, void* logdet, int n,
                               long long count, long long lanes, long long in_sb,
                               long long in_sl, long long in_sr, long long in_sc,
                               long long out_sb, long long out_sl, long long out_sr,
                               long long out_sc, int symmetrize, float jitter,
                               void* stream) {
  using namespace spd_inverse;
  if (n < 1 || n > 32 || count < 1 || lanes < 1 ||
      (count + kWarpMatrices - 1) / kWarpMatrices > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* a = static_cast<const float*>(A);
  float* o = static_cast<float*>(inv);
  float* ld = static_cast<float*>(logdet);
  const Batch in{lanes, in_sb, in_sl, in_sr, in_sc};
  const Batch out{lanes, out_sb, out_sl, out_sr, out_sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n) {
    case 1: err = launch_thread<1>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 2: err = launch_thread<2>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 3: err = launch_thread<3>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 4: err = launch_thread<4>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 5: err = launch_thread<5>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 6: err = launch_thread<6>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 7: err = launch_thread<7>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    case 8: err = launch_thread<8>(a, o, ld, count, in, out, symmetrize, jitter, st); break;
    default:
      err = n <= 16 ? launch_warp<16>(a, o, ld, count, n, in, out, symmetrize, jitter, st)
                    : launch_warp<32>(a, o, ld, count, n, in, out, symmetrize, jitter, st);
  }
  return static_cast<int>(err);
}
