// Sparse FE over every keypoint of every camera x level in one launch.
//
// Replaces the TPU kernel repro/kernels/describe_fused.py::
// describe_fused_pyramid_pallas (pl.pallas_call at line 291): per
// keypoint, the 31x31 circular-mask moments (m10, m01), theta =
// atan2(m01, m10), the 30-degree steering bin, and the 256-bit rBRIEF
// descriptor p(A) < p(B) on the smoothed patch through the bin's
// STEER_LUT row, packed bit i into word i / 32.
//
// Bound on an H100 SXM at the paper's configuration (4 cameras x 1000
// keypoints): each keypoint reads a 31x31 raw and a 31x31 smoothed
// patch, 31 MB if no two patches overlapped; counting each covered
// slab pixel once, about 17 MB on chip_smoke.py's 720p scene, 5 us at
// 3.35 TB/s.  The instructions (about 1,500 a keypoint at their pipes'
// rates, chip_smoke.py sparse_bound) take under 0.1 us, so the kernel is
// bound by bytes.
//
// Design: one warp per keypoint, eight keypoints per 256-thread block, at
// most 64 registers a thread (four blocks an SM: the 4,000 keypoints run in
// one wave of 32 warps an SM).  The warp reads both windows row by row, lane
// = column, at the keypoint clamped into its slab (clamping IS the
// reference's edge pad; describe_common.cuh patch_moments): the raw rows,
// unrolled to be in flight together, go straight into the lane's masked
// column sums, and the smoothed window to dynamic shared memory (3,844 B a
// warp in float, copied with cp.async, which holds no register; 961 B in
// uint8, only the disc the taps reach).  The moments come out of one xor
// butterfly on every lane, so every lane derives the same theta and bin. Each
// tau bit is an exact shared-memory compare through the bin's packed LUT row:
// the TPU's +-1 selection matmul is gone, and __ballot_sync packs 32 lanes'
// bits into one word in the reference's bit order.  The keypoint body is
// describe_keypoint, which the per-level kernel (K7, describe_level.cu) runs
// too; its moments are also K8's (orient_fused.cu).
//
// Pixel types: one template, launched as describe_kernel<float>
// (describe_fused_pyramid) and describe_kernel<unsigned char>
// (describe_fused_pyramid_u8, the uint8 datapath: uint8 smoothed patches
// in shared memory, int32 moments, integer tau compares).
#include "describe_common.cuh"

namespace {

using describe::NPIX;
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;

template <typename P>
__global__ void __launch_bounds__(NT, 4)
describe_kernel(const unsigned* __restrict__ lut, const P* __restrict__ raw,
                const P* __restrict__ sm,
                const long long* __restrict__ table,
                const int* __restrict__ xy, const int* __restrict__ col_level,
                float* __restrict__ theta, float* __restrict__ mom,
                int* __restrict__ desc, int B, int K, float inv_step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long kp = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (kp >= static_cast<long long>(B) * K) return;   // whole warp leaves

  const int b = static_cast<int>(kp / K);
  const int s = col_level[kp % K] * B + b;
  const long long off = table[3 * s];
  const int h = static_cast<int>(table[3 * s + 1]);
  const int w = static_cast<int>(table[3 * s + 2]);
  describe::describe_keypoint(lut, raw + off, sm + off, h, w, xy[2 * kp],
                              xy[2 * kp + 1], inv_step, lane,
                              reinterpret_cast<P*>(smem) + warp * NPIX, kp,
                              theta, mom, desc);
}

template <typename P>
int launch(const int* lut, const P* raw, const P* sm, const long long* table,
           const int* xy, const int* col_level, float* theta, float* mom,
           int* desc, int B, int K, float inv_step, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  describe_kernel<P><<<grid, NT, WARPS * NPIX * sizeof(P), stream>>>(
      reinterpret_cast<const unsigned*>(lut), raw, sm, table, xy, col_level,
      theta, mom, desc, B, K, inv_step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int describe_fused_pyramid(const int* lut, const float* raw,
                                      const float* sm, const long long* table,
                                      const int* xy, const int* col_level,
                                      float* theta, float* mom, int* desc,
                                      int B, int K, float inv_step,
                                      cudaStream_t stream) {
  return launch(lut, raw, sm, table, xy, col_level, theta, mom, desc, B, K,
                inv_step, stream);
}

extern "C" int describe_fused_pyramid_u8(const int* lut, const uint8_t* raw,
                                         const uint8_t* sm,
                                         const long long* table,
                                         const int* xy, const int* col_level,
                                         float* theta, float* mom, int* desc,
                                         int B, int K, float inv_step,
                                         cudaStream_t stream) {
  return launch(lut, raw, sm, table, xy, col_level, theta, mom, desc, B, K,
                inv_step, stream);
}
