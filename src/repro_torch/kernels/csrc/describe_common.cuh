// Device code shared by the sparse FE kernels: the fused sparse FE over
// every slab (K2, describe_fused.cu) and over one level (K7,
// describe_level.cu), and orientation only (K8, orient_fused.cu).  All
// three derive a keypoint's moments with patch_moments, so K8's theta and
// moments are bit-equal to K2's on the same keypoints; K2 and K7 run the
// same keypoint body (describe_keypoint).  Each keypoint is one warp's
// work.
//
// The warp reads the 31x31 window row by row, lane = patch column (dx =
// lane - 15; lane 31 holds no column), every read clamped into the image
// (the reference's edge pad).  A lane sums the raw pixels of its column
// that lie inside the circular mask, s = sum p and t = sum dy * p, rows
// in order: the mask is the lane's row range |dy| <= sqrt(225 - dx^2), not
// a per-pixel test, and the raw patch never leaves registers.  Then
// m10 = sum over lanes of dx * s and m01 = sum of t, by an xor butterfly
// that leaves the same sums on every lane.  That order differs from the
// reference's, within 2 * gamma_961 * sum|x * p| on float patches; on
// integer-valued ones every partial sum is an integer below 2^24, so the
// moments are exact in any order.  Only the smoothed patch goes to shared
// memory (K2, K7), copied row by row (cp.async in float; in uint8 only
// the disc that the steering table's taps reach).
//
// The templates take the pixel type P: float, or uint8_t for the paper's
// 8-bit datapath (the reference's integer _block_theta and
// _tap_sign_bits): int32 moments, exact since |m| <= 255 * 4528 < 2^24,
// converted to float for atan2f and for the moments written out, and tau
// bits that compare the integer taps.  On integer-valued images the two
// datapaths give the same floats to atan2f, so the same theta.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

namespace describe {

constexpr int PATCH = 31;
constexpr int RADIUS = 15;
constexpr int NPIX = PATCH * PATCH;
constexpr unsigned FULL = 0xffffffffu;
// The largest dx^2 + dy^2 of any STEER_LUT tap about the patch center
// (tests/port/test_torch_sparse_fm_schedule.py holds every tap to it):
// the uint8 path reads only that disc of the smoothed window.
constexpr int TAP_REACH2 = 173;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// A lane's column sums: float sums with every operation rounded, in row
// order (no contraction), or exact int32 sums of uint8 pixels.
template <typename P>
struct ColumnSums {
  float s = 0.f, t = 0.f;
  __device__ __forceinline__ void add(P v, int dy) {
    s = __fadd_rn(s, v);
    t = __fadd_rn(t, __fmul_rn(static_cast<float>(dy), v));
  }
  // Returns the warp's (m10, m01) on every lane.
  __device__ __forceinline__ void reduce(int dx, float& m10, float& m01) {
    float a = __fmul_rn(static_cast<float>(dx), s), b = t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(FULL, b, o));
    }
    m10 = a;
    m01 = b;
  }
};

template <>
struct ColumnSums<uint8_t> {
  int s = 0, t = 0;
  __device__ __forceinline__ void add(uint8_t v, int dy) {
    s += v;
    t += dy * static_cast<int>(v);
  }
  __device__ __forceinline__ void reduce(int dx, float& m10, float& m01) {
    int a = dx * s, b = t;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(FULL, a, o);
      b += __shfl_xor_sync(FULL, b, o);
    }
    m10 = static_cast<float>(a);
    m01 = static_cast<float>(b);
  }
};

// One float pixel of the smoothed window, ``src``, into row i of this
// lane's column of ``dst`` (this warp's shared memory, row-major 31 x
// 31), asynchronously (cp.async, 4 bytes): it holds no register, and the
// thread waits for its copies in wait_copies.
__device__ __forceinline__ void copy_pixel(const float* src, int i, int lane,
                                           float* dst) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(static_cast<unsigned>(__cvta_generic_to_shared(
                     dst + i * PATCH + lane))),
               "l"(src));
}

// The rows dy (dy^2 <= ``taps``) of column ``gx`` of the uint8 smoothed
// window about row y into ``dst`` (this warp's shared memory, row-major
// 31 x 31), one pixel a lane a row, through registers (cp.async moves 4,
// 8 or 16 bytes): every row is loaded before the first store, since a
// warp issues in order and a store waits for its load.
__device__ __forceinline__ void copy_window(const uint8_t* __restrict__ sm,
                                            int h, int w, int y, int gx,
                                            int taps, int lane,
                                            uint8_t* dst) {
  uint8_t v[PATCH];
#pragma unroll
  for (int i = 0; i < PATCH; ++i) {
    const int dy = i - RADIUS;
    if (dy * dy <= taps) v[i] = sm[clampi(y + dy, 0, h - 1) * w + gx];
  }
#pragma unroll
  for (int i = 0; i < PATCH; ++i) {
    const int dy = i - RADIUS;
    if (dy * dy <= taps) dst[i * PATCH + lane] = v[i];
  }
}
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Circular-mask intensity-centroid moments (m10, m01) of the raw 31x31
// window of an (h, w) image around the (already clamped) center (x, y)
// (paper Eq. 1), on every lane; with ``kSmoothed`` the same window of the
// smoothed image is copied into ``dst_sm`` (this warp's shared memory)
// in the same pass, so both images' reads are in flight together (in
// uint8 only the disc that the taps reach, TAP_REACH2), and the caller
// waits for the copies (wait_copies).
template <bool kSmoothed, typename P>
__device__ __forceinline__ void patch_moments(const P* __restrict__ raw,
                                              const P* __restrict__ sm,
                                              int h, int w, int x, int y,
                                              int lane, P* dst_sm,
                                              float& m10, float& m01) {
  const int dx = lane - RADIUS;
  const int reach = RADIUS * RADIUS - dx * dx;  // mask rows: dy * dy <= reach
  const int taps = TAP_REACH2 - dx * dx;         // tap rows: dy * dy <= taps
  const int gx = clampi(x + dx, 0, w - 1);
  ColumnSums<P> sums;
  // int offsets: one register a row (an image holds fewer than 2^31
  // pixels).  The schedules that measured fastest on the card (PERF.md):
  // float: each row's raw load, then its smoothed pixel's copy (cp.async,
  // which holds no register; the whole column, which beat the tap disc
  // alone), the raw rows summed as they arrive; uint8: the tap disc's
  // smoothed rows all loaded, then stored, then every raw row loaded,
  // then summed (a warp issues in order, and a use waits for its load).
  if constexpr (std::is_same_v<P, uint8_t>) {
    if constexpr (kSmoothed) copy_window(sm, h, w, y, gx, taps, lane, dst_sm);
    P v[PATCH];
#pragma unroll
    for (int i = 0; i < PATCH; ++i) {
      const int dy = i - RADIUS;
      v[i] = dy * dy <= reach ? raw[clampi(y + dy, 0, h - 1) * w + gx] : P(0);
    }
#pragma unroll
    for (int i = 0; i < PATCH; ++i) sums.add(v[i], i - RADIUS);
  } else {
#pragma unroll
    for (int i = 0; i < PATCH; ++i) {
      const int dy = i - RADIUS;
      const int g = clampi(y + dy, 0, h - 1) * w + gx;
      if (dy * dy <= reach) sums.add(raw[g], dy);
      if (kSmoothed && lane < PATCH) copy_pixel(sm + g, i, lane, dst_sm);
    }
  }
  sums.reduce(dx, m10, m01);
}

// One keypoint of the sparse FE (K2 and K7), one warp: clamp (x, y) into
// the (h, w) image, derive the moments (copying the smoothed window's
// tap disc into ``ps``, this warp's shared memory) and theta =
// atan2(m01, m10), quantize theta to its 30-degree steering bin (round
// half to even, then a non-negative mod 12), and form the 256 tau bits
// p(A) < p(B) on the smoothed patch through the bin's row of ``lut``,
// the (12, 256) steering table with each pair's indices packed into one
// word (A in the low 16 bits, B in the high; ref.steer_lut_packed): a
// lane's 8 words are 8 coalesced loads issued together.  __ballot_sync
// packs 32 lanes' bits at a time (bit i in word i / 32), and lanes 0..7
// write the 8 words.
template <typename P>
__device__ __forceinline__ void describe_keypoint(
    const unsigned* __restrict__ lut, const P* __restrict__ raw,
    const P* __restrict__ sm, int h, int w, int x, int y, float inv_step,
    int lane, P* ps, long long kp, float* __restrict__ theta,
    float* __restrict__ mom, int* __restrict__ desc) {
  float m10, m01;
  patch_moments<true>(raw, sm, h, w, clampi(x, 0, w - 1),
                      clampi(y, 0, h - 1), lane, ps, m10, m01);
  const float th = atan2f(m01, m10);
  int bin = static_cast<int>(rintf(__fmul_rn(th, inv_step))) % 12;
  if (bin < 0) bin += 12;

  const unsigned* row = lut + bin * 256 + lane;
  unsigned pairs[8];
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) pairs[wd] = __ldg(row + 32 * wd);
  wait_copies();                          // this lane's smoothed pixels,
  __syncwarp();                           // then the warp's
  unsigned mine = 0;
#pragma unroll
  for (int wd = 0; wd < 8; ++wd) {
    const bool tau = ps[pairs[wd] & 0xffffu] < ps[pairs[wd] >> 16];
    const unsigned bits = __ballot_sync(FULL, tau);
    if (lane == wd) mine = bits;
  }
  if (lane < 8) desc[kp * 8 + lane] = static_cast<int>(mine);
  if (lane == 0) {
    theta[kp] = th;
    mom[2 * kp] = m10;
    mom[2 * kp + 1] = m01;
  }
}

}  // namespace describe
