// Sparse FE of the keypoints of one pyramid level, all cameras, in one
// launch.
//
// Replaces the TPU kernel repro/kernels/describe_fused.py::
// describe_fused_pallas (pl.pallas_call at line 192; body
// _describe_kernel and _describe_block): for each of the (B, K)
// keypoints of a raw and a smoothed (B, h, w) level, clamped into the
// level, the 31x31 circular-mask moments (m10, m01), theta =
// atan2(m01, m10), the 30-degree steering bin, and the 256-bit rBRIEF
// descriptor p(A) < p(B) on the smoothed patch through the bin's
// STEER_LUT row, packed bit i into word i / 32.  It serves the per-level
// FE schedule (orb.extract_features_per_level), 1 launch a level.
//
// Bound on an H100 SXM at the paper's configuration (4 cameras, top-K
// 591 on level 0 and 409 on level 1): each keypoint reads a 31x31 raw
// and a 31x31 smoothed patch; counting each covered level pixel once
// (patches overlap) that is at most 18 MB on level 0 (2,364 keypoints)
// and 12 MB on level 1 (1,636), 5 us and 4 us at 3.35 TB/s.  About
// 1,500 instructions a keypoint at their pipes' rates (chip_smoke.py
// sparse_bound) are under 0.1 us, so the kernel is bound by bytes.
//
// Design: K2's (describe_fused.cu) on one level: one warp per keypoint,
// eight keypoints per 256-thread block, four blocks an SM, any K (no
// KP_BLOCK padding; the last block's spare warps leave at once).  The
// keypoint body is describe_common.cuh's describe_keypoint, the same
// device code K2 runs: row-by-row clamped window reads (the reference's
// edge pad, so no padded slab), the raw pixels summed in registers as
// masked column sums, only the smoothed window in dynamic shared memory,
// exact tau compares through the packed LUT row, packed by
// __ballot_sync.  The TPU's +-1 selection matmul and its whole-level VMEM
// residency are gone.
//
// Pixel types: one template, launched as describe_level_kernel<float>
// (describe_fused) and describe_level_kernel<unsigned char>
// (describe_fused_u8, the uint8 datapath of describe_keypoint).
#include "describe_common.cuh"

namespace {

using describe::NPIX;
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;

template <typename P>
__global__ void __launch_bounds__(NT, 4)
describe_level_kernel(const unsigned* __restrict__ lut,
                      const P* __restrict__ raw, const P* __restrict__ sm,
                      const int* __restrict__ xy, float* __restrict__ theta,
                      float* __restrict__ mom, int* __restrict__ desc, int B,
                      int K, int h, int w, float inv_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long kp = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (kp >= static_cast<long long>(B) * K) return;   // whole warp leaves

  const long long img = (kp / K) * h * w;
  describe::describe_keypoint(lut, raw + img, sm + img, h, w, xy[2 * kp],
                              xy[2 * kp + 1], inv_step, lane,
                              reinterpret_cast<P*>(smem) + warp * NPIX, kp,
                              theta, mom, desc);
}

template <typename P>
int launch(const int* lut, const P* raw, const P* sm, const int* xy,
           float* theta, float* mom, int* desc, int B, int K, int h, int w,
           float inv_step, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  describe_level_kernel<P><<<grid, NT, WARPS * NPIX * sizeof(P), stream>>>(
      reinterpret_cast<const unsigned*>(lut), raw, sm, xy, theta, mom, desc,
      B, K, h, w, inv_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int describe_fused(const int* lut, const float* raw,
                              const float* sm, const int* xy, float* theta,
                              float* mom, int* desc, int B, int K, int h,
                              int w, float inv_step, cudaStream_t stream) {
  return launch(lut, raw, sm, xy, theta, mom, desc, B, K, h, w, inv_step,
                stream);
}

extern "C" int describe_fused_u8(const int* lut, const uint8_t* raw,
                                 const uint8_t* sm, const int* xy,
                                 float* theta, float* mom, int* desc, int B,
                                 int K, int h, int w, float inv_step,
                                 cudaStream_t stream) {
  return launch(lut, raw, sm, xy, theta, mom, desc, B, K, h, w, inv_step,
                stream);
}
