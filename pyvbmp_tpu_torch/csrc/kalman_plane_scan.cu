// The plane Kalman scan's C entry point, and its rungs H <= 16 (templates
// and design notes in kalman_plane_scan.cuh; the rungs 24 and 32 are in
// kalman_plane_scan_wide.cu).
#include "kalman_plane_scan.cuh"

// Inputs, outputs and totals in the order Jaa, Jab, Jbb, ha, hb, logw.
// One-pass scan: C = 1, L = T, offset = 0, totals may be NULL.  Time fold:
// C > 1 chunks of L rows (C L >= T, every chunk non-empty), offset as above,
// totals (C, ...) scratch planes.  Any 1 <= H <= 32, run at the rung 4, 6,
// 8, 10, 12, 14, 16, 24 or 32 at or above it.  Returns 0 on a clean launch,
// the CUDA error code otherwise, and cudaErrorInvalidValue for an H out of
// range or a fold without totals (the Python wrapper checks both first).
extern "C" int kalman_plane_scan_f32(
    const void* Jaa, const void* Jab, const void* Jbb, const void* ha,
    const void* hb, const void* logw, void* oJaa, void* oJab, void* oJbb,
    void* oha, void* ohb, void* ologw, void* tJaa, void* tJab, void* tJbb,
    void* tha, void* thb, void* tlogw, int T, int H, int N, int C, int L,
    int offset, int reverse, void* stream) {
  using namespace kalman_plane;
  const void* in[6] = {Jaa, Jab, Jbb, ha, hb, logw};
  void* out[6] = {oJaa, oJab, oJbb, oha, ohb, ologw};
  void* tot[6] = {tJaa, tJab, tJbb, tha, thb, tlogw};
  if (C > 1)
    for (void* p : tot)
      if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (H < 1 || H > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 4) return launch<4>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 6) return launch<6>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 8) return launch<8>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 10) return launch<10>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 12) return launch<12>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 14) return launch<14>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 16) return launch<16>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  if (H <= 24) return launch<24>(in, out, tot, T, H, N, C, L, offset, reverse, s);
  return launch<32>(in, out, tot, T, H, N, C, L, offset, reverse, s);
}
