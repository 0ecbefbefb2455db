// The plane Kalman scan at the rungs H = 24 and 32 (templates and design
// notes in kalman_plane_scan.cuh; a source of their own so that nvcc builds
// them beside the others).
#include "kalman_plane_scan.cuh"

namespace kalman_plane {

template int launch<24>(const void* const*, void* const*, void* const*, int, int, int, int, int,
                        int, int, cudaStream_t);
template int launch<32>(const void* const*, void* const*, void* const*, int, int, int, int, int,
                        int, int, cudaStream_t);

}  // namespace kalman_plane
