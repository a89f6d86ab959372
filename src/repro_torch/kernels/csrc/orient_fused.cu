// Orientation only: moments and theta of every keypoint of a batch of
// images in one launch.
//
// Replaces the TPU kernel repro/kernels/describe_fused.py::
// orient_fused_pallas (pl.pallas_call at line 229, body _orient_kernel
// with _load_patches and _block_theta): per keypoint, clamped into its
// image, the 31x31 raw patch, the circular-mask moments (m10, m01) and
// theta = atan2(m01, m10) (paper Eq. 1); no smoothed image and no
// descriptor.  It serves fast.orientations and fast.detect.
//
// Bound on an H100 SXM at fast.detect's level-0 shape (591 keypoints of
// one 720 x 1280 image): each covered image pixel read once (at most
// 0.57 M if no two patches overlapped, 2.3 MB) plus the keypoints and
// the outputs, under 0.7 us at 3.35 TB/s; about 1,500 instructions a
// keypoint (709 masked pixels' column sums, atan2) at their pipes' rates
// (chip_smoke.py orient_bound), under 0.01 us.  The kernel is bound by
// bytes, and at this size by its launch.
//
// Design: K2's, without its second half: one warp per keypoint, eight
// keypoints per 256-thread block, any K (the TPU's padding of K to an
// 8-keypoint block is gone), each warp reading its raw window row by row
// with clamped reads (the reference's edge pad: no padded slab) straight
// into its masked column sums, no shared memory.  The moments are
// describe_common.cuh's patch_moments, the same device code K2 runs, so
// theta and moments are bit-equal to K2's.
//
// Pixel types: one template, launched as orient_kernel<float>
// (orient_fused) and orient_kernel<unsigned char> (orient_fused_u8:
// int32 moments, the reference's integer _block_theta).
#include "describe_common.cuh"

namespace {

constexpr int WARPS = 8;

template <typename P>
__global__ void __launch_bounds__(WARPS * 32)
orient_kernel(const P* __restrict__ raw, const int* __restrict__ xy,
              float* __restrict__ theta, float* __restrict__ mom, int B,
              int K, int h, int w) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long kp = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (kp >= static_cast<long long>(B) * K) return;   // whole warp leaves

  const long long img = (kp / K) * h * w;
  const int x = describe::clampi(xy[2 * kp], 0, w - 1);
  const int y = describe::clampi(xy[2 * kp + 1], 0, h - 1);
  float m10, m01;
  describe::patch_moments<false>(raw + img, static_cast<const P*>(nullptr),
                                 h, w, x, y, lane, static_cast<P*>(nullptr),
                                 m10, m01);
  if (lane == 0) {
    theta[kp] = atan2f(m01, m10);
    mom[2 * kp] = m10;
    mom[2 * kp + 1] = m01;
  }
}

template <typename P>
int launch(const P* raw, const int* xy, float* theta, float* mom, int B,
           int K, int h, int w, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  orient_kernel<P><<<grid, WARPS * 32, 0, stream>>>(raw, xy, theta, mom, B,
                                                    K, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int orient_fused(const float* raw, const int* xy, float* theta,
                            float* mom, int B, int K, int h, int w,
                            cudaStream_t stream) {
  return launch(raw, xy, theta, mom, B, K, h, w, stream);
}

extern "C" int orient_fused_u8(const uint8_t* raw, const int* xy,
                               float* theta, float* mom, int B, int K, int h,
                               int w, cudaStream_t stream) {
  return launch(raw, xy, theta, mom, B, K, h, w, stream);
}
