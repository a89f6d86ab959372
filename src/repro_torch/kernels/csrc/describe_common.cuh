// Device code shared by the sparse FE kernels: the fused sparse FE over
// every slab (K2, describe_fused.cu) and over one level (K7,
// describe_level.cu), and orientation only (K8, orient_fused.cu).  All
// three load a keypoint's raw patch and derive its moments and theta
// with the functions below, so K8's theta and moments are bit-equal to
// K2's on the same keypoints; K2 and K7 run the same keypoint body
// (describe_keypoint).  Each keypoint is one warp's work.
//
// load_patches and describe_keypoint are templates over the pixel type
// P, which is also the type of the patches in shared memory, and
// patch_theta has an overload for each: float, or uint8_t for the
// paper's 8-bit datapath (the reference's _block_theta and integer
// _tap_sign_bits): int32 moments, exact since |m| <= 255 * 4528 < 2^24,
// converted to float for atan2f and for the moments written out, and
// tau bits that compare the integer taps.  On integer-valued images the
// two datapaths give the same floats to atan2f, so the same theta.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace describe {

constexpr int PATCH = 31;
constexpr int RADIUS = 15;
constexpr int NPIX = PATCH * PATCH;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The 31x31 window of an (h, w) raw image and, with ``kSmoothed``, the
// same window of its smoothed image, around the (already clamped)
// center (x, y), every read clamped into the image (the reference's
// edge pad), into ``dst_raw`` / ``dst_sm`` row by row; the warp's 32
// lanes share them.  K2 loads both windows in one loop, K8 the raw one.
template <bool kSmoothed, typename P>
__device__ __forceinline__ void load_patches(const P* __restrict__ raw,
                                             const P* __restrict__ sm,
                                             int h, int w, int x, int y,
                                             int lane, P* dst_raw,
                                             P* dst_sm) {
  for (int i = lane; i < NPIX; i += 32) {
    const int gy = clampi(y - RADIUS + i / PATCH, 0, h - 1);
    const int gx = clampi(x - RADIUS + i % PATCH, 0, w - 1);
    const long long g = static_cast<long long>(gy) * w + gx;
    dst_raw[i] = raw[g];
    if constexpr (kSmoothed) dst_sm[i] = sm[g];
  }
}

// Circular-mask intensity-centroid moments (m10, m01) of a patch in
// shared memory (paper Eq. 1): each lane sums its pixels, the warp
// reduces with shuffles to lane 0, which broadcasts, so every lane
// returns the same moments and theta = atan2(m01, m10).
__device__ __forceinline__ float patch_theta(const float* patch, int lane,
                                             float* m10_out,
                                             float* m01_out) {
  float m10 = 0.f, m01 = 0.f;
  for (int i = lane; i < NPIX; i += 32) {
    const int dy = i / PATCH - RADIUS, dx = i % PATCH - RADIUS;
    if (dx * dx + dy * dy <= RADIUS * RADIUS) {
      m10 = __fadd_rn(m10, __fmul_rn(patch[i], static_cast<float>(dx)));
      m01 = __fadd_rn(m01, __fmul_rn(patch[i], static_cast<float>(dy)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_down_sync(FULL, m10, o));
    m01 = __fadd_rn(m01, __shfl_down_sync(FULL, m01, o));
  }
  m10 = __shfl_sync(FULL, m10, 0);
  m01 = __shfl_sync(FULL, m01, 0);
  *m10_out = m10;
  *m01_out = m01;
  return atan2f(m01, m10);
}

// The same moments of a uint8 patch in int32 (exact in any order), given
// out as floats (exact below 2^24), and theta = atan2 of those floats.
__device__ __forceinline__ float patch_theta(const uint8_t* patch, int lane,
                                             float* m10_out,
                                             float* m01_out) {
  int m10 = 0, m01 = 0;
  for (int i = lane; i < NPIX; i += 32) {
    const int dy = i / PATCH - RADIUS, dx = i % PATCH - RADIUS;
    if (dx * dx + dy * dy <= RADIUS * RADIUS) {
      m10 += static_cast<int>(patch[i]) * dx;
      m01 += static_cast<int>(patch[i]) * dy;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 += __shfl_down_sync(FULL, m10, o);
    m01 += __shfl_down_sync(FULL, m01, o);
  }
  *m10_out = static_cast<float>(__shfl_sync(FULL, m10, 0));
  *m01_out = static_cast<float>(__shfl_sync(FULL, m01, 0));
  return atan2f(*m01_out, *m10_out);
}

// One keypoint of the sparse FE (K2 and K7), one warp: clamp (x, y)
// into the (h, w) image, load its raw and smoothed 31x31 patches into
// ``pr`` / ``ps`` (this warp's shared memory), derive the moments and
// theta, quantize theta to its 30-degree steering bin (round half to
// even, then a non-negative mod 12), and form the 256 tau bits p(A) <
// p(B) on the smoothed patch through the bin's row of the (12, 256, 2)
// steering ``lut``, packed 32 lanes at a time by __ballot_sync (bit i
// in word i / 32).  Lane 0 writes theta[kp], mom[2 kp..], desc[8 kp..].
template <typename P>
__device__ __forceinline__ void describe_keypoint(
    const int* __restrict__ lut, const P* __restrict__ raw,
    const P* __restrict__ sm, int h, int w, int x, int y,
    float inv_step, int lane, P* pr, P* ps, long long kp,
    float* __restrict__ theta, float* __restrict__ mom,
    int* __restrict__ desc) {
  x = clampi(x, 0, w - 1);
  y = clampi(y, 0, h - 1);
  load_patches<true>(raw, sm, h, w, x, y, lane, pr, ps);
  __syncwarp();

  float m10, m01;
  const float th = patch_theta(pr, lane, &m10, &m01);
  int bin = static_cast<int>(rintf(__fmul_rn(th, inv_step))) % 12;
  if (bin < 0) bin += 12;

  const int* row = lut + bin * 256 * 2;
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) {
    const int i = wd * 32 + lane;
    const bool tau = ps[row[2 * i]] < ps[row[2 * i + 1]];
    const unsigned bits = __ballot_sync(FULL, tau);
    if (lane == 0) desc[kp * 8 + wd] = static_cast<int>(bits);
  }
  if (lane == 0) {
    theta[kp] = th;
    mom[2 * kp] = m10;
    mom[2 * kp + 1] = m01;
  }
}

}  // namespace describe
