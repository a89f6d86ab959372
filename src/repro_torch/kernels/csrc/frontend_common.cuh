// Device code shared by the dense FE kernels: the fused dense FE over
// every slab (K1, frontend_fused.cu) and over one level (K6,
// frontend_level.cu), the FAST score map (K11, fast_detect.cu) and the
// 7x7 blur (K12, gaussian_blur.cu).  Each computes its pixels with the
// functions below, so the four cannot drift apart: K1 and K6 run the
// same tile body (dense_tile), and K11 followed by the NMS oracle and
// K12 are bit-equal to K1's score and blur.
//
// FAST-9/16's arc extrema.  The score of a pixel with centre c and
// circle taps t[0..15] is max(bright, -dark), bright the max over the
// 16 arcs of 9 contiguous taps of the arc's min of (t - c), dark the
// min over the arcs of the arc's max.  Both are taken on the raw taps
// and the centre subtracted once a side: x -> round(x - c) is monotone,
// so it commutes with min and max, and min and max are exact, so any
// association is bit-equal to the reference's (a signed zero can
// differ only in a score that is 0, which a threshold >= 0 maps to
// +0).  Float taps use van Herk / Gil-Werman on the two blocks of 8
// taps (arc_extrema: 59 two-input FMNMX a side, against 143 unrolled);
// the uint8 datapath holds two pixels a 32-bit word in 16-bit lanes and
// uses sm_90's DPX three-input min/max, an arc of 9 as three runs of 3
// (arc_extrema_u16x2: 40 VIMNMX3/VIMNMX a side for the two pixels).
// Both run an exact pre-test first (fast_live, fast_live_u16x2): unless
// the second largest or second smallest of the 4 compass taps lies
// beyond the threshold, the score is 0 and the extrema are skipped.
//
// The dense tile (K1, K6): a 62 x 62 output tile, 8 warps, each lane
// owning two pixels of a row of the tile's 64 working columns (-1 ..
// 62, the NMS rim).  Phase 1 loads the clamped 70 x 70 window (clamping
// is the reference's edge pad) into shared memory with 2-D thread
// indexing; phase 2 computes, row by row across the warps, the FAST raw
// score on the 64 x 64 rim (-1 outside the image) and the blur's
// horizontal pass on 68 rows; phase 3 walks each warp down a strip of
// 8 output rows, sliding the vertical 7-tap blur and the NMS row maxima
// in registers, and stores.  Float lanes own the columns (lane - 1,
// lane + 31), so a warp's shared loads hit 32 banks; uint8 lanes own
// the adjacent pair (2 lane - 1, 2 lane), one 32-bit word of the
// 16-bit window, an odd tap offset a __byte_perm of two words.
//
// The tile body runs on two pixel types (the reference's dtype branch
// in _tile_outputs): float, with float arithmetic rounded step by step,
// and uint8_t, the paper's 8-bit datapath: a uint8 blur (the horizontal
// pass in 16-bit lanes, at most 255 * 36 = 9180, the vertical one in
// int32, at most 330,480 + 648) and an int16 score (raw taps in [0,
// 255], so the score lies in [-255, 255]).  Datapath<T> names the types
// of each.  K11 and K12 take float pixels only (the reference casts
// their input to float32).
#pragma once

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace frontend {

constexpr int TILE = 32;          // output tile edge of K11 and K12
constexpr int RAD = 3;            // blur and FAST circle radius

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Pixel, accumulator, blur and score types of each datapath.
template <typename T>
struct Datapath;
template <>
struct Datapath<float> {
  using Acc = float;
  using Blur = float;
  using Score = float;
};
template <>
struct Datapath<uint8_t> {
  using Acc = int;
  using Blur = uint8_t;
  using Score = int16_t;
};

// Load the (rows x cols) window of an (h, w) image whose top-left pixel
// is (y0, x0), every read clamped into the image, into ``dst`` (row
// stride ``cols``, converted to the accumulator type A), with ``nt``
// threads of the block.
template <typename T, typename A>
__device__ __forceinline__ void load_tile(const T* __restrict__ img, int h,
                                          int w, int y0, int x0, int rows,
                                          int cols, A* dst, int nt) {
  for (int i = threadIdx.x; i < rows * cols; i += nt) {
    const int r = i / cols, c = i % cols;
    const int gy = clampi(y0 + r, 0, h - 1);
    const int gx = clampi(x0 + c, 0, w - 1);
    dst[i] = static_cast<A>(img[static_cast<long long>(gy) * w + gx]);
  }
}

// 7 taps of the binomial blur [1, 4, 8, 10, 8, 4, 1] in order, each
// product and each sum rounded on its own (__fmul_rn/__fadd_rn), so nvcc
// cannot contract them into FMAs: the reference rounds both.
__device__ __forceinline__ float blur7_taps(float t0, float t1, float t2,
                                            float t3, float t4, float t5,
                                            float t6) {
  float acc = __fmul_rn(1.f, t0);
  acc = __fadd_rn(acc, __fmul_rn(4.f, t1));
  acc = __fadd_rn(acc, __fmul_rn(8.f, t2));
  acc = __fadd_rn(acc, __fmul_rn(10.f, t3));
  acc = __fadd_rn(acc, __fmul_rn(8.f, t4));
  acc = __fadd_rn(acc, __fmul_rn(4.f, t5));
  acc = __fadd_rn(acc, __fmul_rn(1.f, t6));
  return acc;
}

__device__ __forceinline__ float blur7(const float* p, int stride) {
  return blur7_taps(p[0], p[stride], p[2 * stride], p[3 * stride],
                    p[4 * stride], p[5 * stride], p[6 * stride]);
}

// The same 7 taps in int32, exact in any order.
__device__ __forceinline__ int blur7_taps(int t0, int t1, int t2, int t3,
                                          int t4, int t5, int t6) {
  return t0 + t6 + 4 * (t1 + t5) + 8 * (t2 + t4) + 10 * t3;
}

// The vertical pass's sum over the norm 36^2 = 1296: round half up with
// ``quantized``, else the plain IEEE quotient.
__device__ __forceinline__ float blur_norm(float vert, int quantized) {
  return quantized ? floorf(__fdiv_rn(__fadd_rn(vert, 648.f), 1296.f))
                   : __fdiv_rn(vert, 1296.f);
}

// The integer datapath's round half up, (vert + 648) / 1296 in integers
// (vert >= 0, so the quotient is the floor); always quantized.
__device__ __forceinline__ int blur_norm(int vert, int) {
  return (vert + 648) / 1296;
}

// The 16 Bresenham circle taps of radius 3 around ``p``, in order around
// the circle: (dx, dy) = (0, -3), (1, -3), (2, -2), (3, -1), (3, 0),
// (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0),
// (-3, -1), (-2, -2), (-1, -3), tap k at p[dy * stride + dx].
__device__ __forceinline__ void circle_taps(const float* p, int stride,
                                            float (&t)[16]) {
  t[0] = p[-3 * stride];
  t[1] = p[-3 * stride + 1];
  t[2] = p[-2 * stride + 2];
  t[3] = p[-stride + 3];
  t[4] = p[3];
  t[5] = p[stride + 3];
  t[6] = p[2 * stride + 2];
  t[7] = p[3 * stride + 1];
  t[8] = p[3 * stride];
  t[9] = p[3 * stride - 1];
  t[10] = p[2 * stride - 2];
  t[11] = p[stride - 3];
  t[12] = p[-3];
  t[13] = p[-stride - 3];
  t[14] = p[-2 * stride - 2];
  t[15] = p[-3 * stride - 1];
}

// lo = max over the 16 arcs of 9 contiguous taps of the arc's min, hi =
// min over the arcs of the arc's max.  van Herk / Gil-Werman on the
// blocks A = t[0..7] and B = t[8..15]: the arc from offset o of A is
// A's suffix from o and B's prefix through o, the arc from 8 + o is B's
// suffix from o and A's prefix through o.  A side takes 4 x 7 prefix and
// suffix extrema, 16 joins and 15 reductions: 59 two-input FMNMX.
__device__ __forceinline__ void arc_extrema(const float (&t)[16], float& lo,
                                            float& hi) {
  float pa[8], pb[8], qa[8], qb[8];     // prefix min (p) and max (q)
  pa[0] = qa[0] = t[0];
  pb[0] = qb[0] = t[8];
#pragma unroll
  for (int o = 1; o < 8; ++o) {
    pa[o] = fminf(pa[o - 1], t[o]);
    qa[o] = fmaxf(qa[o - 1], t[o]);
    pb[o] = fminf(pb[o - 1], t[8 + o]);
    qb[o] = fmaxf(qb[o - 1], t[8 + o]);
  }
  float sa = t[7], sb = t[15];          // suffix min
  float ra = t[7], rb = t[15];          // suffix max
  float l[8], u[8];
#pragma unroll
  for (int o = 7; o >= 0; --o) {
    if (o < 7) {
      sa = fminf(sa, t[o]);
      ra = fmaxf(ra, t[o]);
      sb = fminf(sb, t[8 + o]);
      rb = fmaxf(rb, t[8 + o]);
    }
    l[o] = fmaxf(fminf(sa, pb[o]), fminf(sb, pa[o]));
    u[o] = fminf(fmaxf(ra, qb[o]), fmaxf(rb, qa[o]));
  }
  lo = fmaxf(fmaxf(fmaxf(l[0], l[1]), fmaxf(l[2], l[3])),
             fmaxf(fmaxf(l[4], l[5]), fmaxf(l[6], l[7])));
  hi = fminf(fminf(fminf(u[0], u[1]), fminf(u[2], u[3])),
             fminf(fminf(u[4], u[5]), fminf(u[6], u[7])));
}

// Exact FAST pre-test.  Any 9 contiguous taps of 16 hold at least 2 of
// the compass taps 0, 4, 8, 12, and an arc above the threshold has every
// difference above ``threshold`` (bright) or below -``threshold``
// (dark).  So unless the second largest compass difference is above
// the threshold, or the second smallest below its negation, the
// thresholded score is exactly 0 and the arc extrema can be skipped.
// Of four taps a, b, c, d, with x = min(max(a, b), max(c, d)) and y =
// max(min(a, b), min(c, d)), the second largest is max(x, y) and the
// second smallest min(x, y); taken on raw taps, as the extrema are.  A
// warp skips the extrema where all its pixels fail, as on flat image.
__device__ __forceinline__ bool fast_live(float a, float b, float c, float d,
                                          float ctr, float threshold) {
  const float x = fminf(fmaxf(a, b), fmaxf(c, d));
  const float y = fmaxf(fminf(a, b), fminf(c, d));
  return __fsub_rn(fmaxf(x, y), ctr) > threshold ||
         -__fsub_rn(fminf(x, y), ctr) > threshold;
}

// Thresholded FAST-9/16 score of the pixel at ``p`` (its 16 circle taps
// lie at p[dy * stride + dx]): 0 if the pre-test fails, else
// max(bright, -dark) from the raw-tap arc extrema, 0 unless above
// ``threshold``.
__device__ __forceinline__ float fast_score(const float* p, int stride,
                                            float threshold) {
  const float ctr = p[0];
  if (!fast_live(p[-3 * stride], p[3], p[3 * stride], p[-3], ctr,
                 threshold))
    return 0.f;
  float t[16];
  circle_taps(p, stride, t);
  float lo, hi;
  arc_extrema(t, lo, hi);
  const float sc = fmaxf(__fsub_rn(lo, ctr), -__fsub_rn(hi, ctr));
  return sc > threshold ? sc : 0.f;
}

// arc_extrema for two pixels of uint8 taps, one per unsigned 16-bit lane,
// with DPX: the min (max) of taps i .. i + 2 for every i (16 VIMNMX3),
// an arc of 9 as three of those (16), then 8 more to reduce the 16 arcs:
// 40 a side for the two pixels.
__device__ __forceinline__ void arc_extrema_u16x2(const uint32_t (&t)[16],
                                                  uint32_t& lo,
                                                  uint32_t& hi) {
  uint32_t mn3[16], mx3[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mn3[i] = __vimin3_u16x2(t[i], t[(i + 1) & 15], t[(i + 2) & 15]);
    mx3[i] = __vimax3_u16x2(t[i], t[(i + 1) & 15], t[(i + 2) & 15]);
  }
  uint32_t mn9[16], mx9[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mn9[i] = __vimin3_u16x2(mn3[i], mn3[(i + 3) & 15], mn3[(i + 6) & 15]);
    mx9[i] = __vimax3_u16x2(mx3[i], mx3[(i + 3) & 15], mx3[(i + 6) & 15]);
  }
  lo = __vmaxu2(__vimax3_u16x2(__vimax3_u16x2(mn9[0], mn9[1], mn9[2]),
                               __vimax3_u16x2(mn9[3], mn9[4], mn9[5]),
                               __vimax3_u16x2(mn9[6], mn9[7], mn9[8])),
                __vimax3_u16x2(__vimax3_u16x2(mn9[9], mn9[10], mn9[11]),
                               __vimax3_u16x2(mn9[12], mn9[13], mn9[14]),
                               mn9[15]));
  hi = __vminu2(__vimin3_u16x2(__vimin3_u16x2(mx9[0], mx9[1], mx9[2]),
                               __vimin3_u16x2(mx9[3], mx9[4], mx9[5]),
                               __vimin3_u16x2(mx9[6], mx9[7], mx9[8])),
                __vimin3_u16x2(__vimin3_u16x2(mx9[9], mx9[10], mx9[11]),
                               __vimin3_u16x2(mx9[12], mx9[13], mx9[14]),
                               mx9[15]));
}

// The integer score of one lane from its arc extrema ``lo``, ``hi`` and
// centre ``c`` (all in [0, 255]): max(lo - c, c - hi), compared against
// the integer threshold floor(threshold), which for integer scores is
// the same compare.
__device__ __forceinline__ int fast_lane(int lo, int hi, int c, int thr) {
  const int sc = max(lo - c, c - hi);
  return sc > thr ? sc : 0;
}

// The threshold in a datapath's accumulator type.
__device__ __forceinline__ float acc_threshold(float threshold, float) {
  return threshold;
}
__device__ __forceinline__ int acc_threshold(float threshold, int) {
  return static_cast<int>(floorf(threshold));
}

// ---- The fused dense tile of K1 and K6 ----

constexpr int DENSE_NT = 256;                    // threads a block
constexpr int DENSE_WARPS = DENSE_NT / 32;
constexpr int DENSE_STRIP = 8;                   // rows a warp walks
constexpr int DENSE_TH = DENSE_WARPS * DENSE_STRIP - 2;   // 62 output rows
constexpr int DENSE_TW = 62;                     // output columns
constexpr int DENSE_SROWS = DENSE_TH + 2;        // score rows -1 .. TH
constexpr int DENSE_HROWS = DENSE_TH + 6;        // horizontal rows -3 .. TH + 2
constexpr int DENSE_IROWS = DENSE_TH + 8;        // window rows -4 .. TH + 3
constexpr int DENSE_ICOLS = DENSE_TW + 8;        // window columns -4 .. TW + 3
static_assert(DENSE_TW + 2 == 64, "a warp's lanes own 64 working columns");

// Shared memory of one tile.  Float: one pixel a cell, tile column j at
// cell j + 4 of ``in``, j + 1 of ``horiz`` and j + 2 of ``score``.
// uint8: two pixels a 32-bit word in 16-bit lanes, tile column j at
// 16-bit cell j + 5 of ``in``, so lane p's pair (2p - 1, 2p) is word p +
// 2; its horizontal sums are word p of ``horiz`` and its int16 raw
// scores word p + 1 of ``score``.  Cells no phase writes are read only
// for the working columns -1 and 62, which are never stored.
template <typename T>
struct DenseTile;
template <>
struct DenseTile<float> {
  float in[DENSE_IROWS][72];
  float horiz[DENSE_HROWS][64];
  float score[DENSE_SROWS][66];
};
template <>
struct DenseTile<uint8_t> {
  uint32_t in[DENSE_IROWS][36];
  uint32_t horiz[DENSE_HROWS][32];
  uint32_t score[DENSE_SROWS][34];
};

// Raises ``kernel``'s dynamic shared-memory limit to ``bytes`` the first
// time its launcher runs on the current device.  The attribute is per
// device and stays set, so later launches skip the driver call; ``done``
// is the launcher's own set of devices (bit d for device d), and two
// threads racing both set the same value.
template <typename K>
inline cudaError_t allow_dynamic_smem(K* kernel, int bytes,
                                      std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

__device__ __forceinline__ void put_cell(DenseTile<float>& s, int r, int c,
                                         float v) {
  s.in[r][c] = v;
}
__device__ __forceinline__ void put_cell(DenseTile<uint8_t>& s, int r, int c,
                                         uint8_t v) {
  reinterpret_cast<uint16_t*>(s.in[r])[c + 1] = v;
}

// Phase 1: the (IROWS x ICOLS) window at (ty0 - 4, tx0 - 4), clamped,
// a warp a row, lanes along it; window column c is tile column c - 4.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ img, int h,
                                            int w, int ty0, int tx0,
                                            DenseTile<T>& s, int warp,
                                            int lane) {
  int gx[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    gx[k] = clampi(tx0 - 4 + lane + 32 * k, 0, w - 1);
  for (int r = warp; r < DENSE_IROWS; r += DENSE_WARPS) {
    const T* row = img + static_cast<long long>(
                             clampi(ty0 - 4 + r, 0, h - 1)) * w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = lane + 32 * k;
      if (c < DENSE_ICOLS) put_cell(s, r, c, row[gx[k]]);
    }
  }
}

// Phase 2, FAST: score row i (tile row i - 1, inside the image).
__device__ __forceinline__ void fast_row(DenseTile<float>& s, int i, int lane,
                                         int tx0, int w, float thr) {
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int c = lane - 1 + 32 * half;
    const int gx = tx0 + c;
    s.score[i][c + 2] = (gx >= 0 && gx < w)
                            ? fast_score(&s.in[i + 3][c + 4], 72, thr)
                            : -1.f;
  }
}

// The pair of 16-bit cells at offset (DY, DX) from a pair's word ``ctr``
// of the uint8 window: a word for an even DX, else the high half of one
// word and the low half of the next.
template <int DY, int DX>
__device__ __forceinline__ uint32_t tap2(const uint32_t* ctr) {
  const uint32_t* row = ctr + DY * 36;
  if constexpr ((DX & 1) == 0) {
    return row[DX / 2];
  } else {
    return __byte_perm(row[(DX - 1) / 2], row[(DX + 1) / 2], 0x5432);
  }
}

// The pre-test (fast_live) on both lanes of the compass words a, b, c,
// d with DPX: true if either pixel may score.
__device__ __forceinline__ bool fast_live_u16x2(uint32_t a, uint32_t b,
                                                uint32_t c, uint32_t d,
                                                uint32_t ctr, int thr) {
  const uint32_t x = __vminu2(__vmaxu2(a, b), __vmaxu2(c, d));
  const uint32_t y = __vmaxu2(__vminu2(a, b), __vminu2(c, d));
  const uint32_t s2max = __vmaxu2(x, y), s2min = __vminu2(x, y);
  const int c0 = ctr & 0xffff, c1 = ctr >> 16;
  return static_cast<int>(s2max & 0xffff) - c0 > thr ||
         c0 - static_cast<int>(s2min & 0xffff) > thr ||
         static_cast<int>(s2max >> 16) - c1 > thr ||
         c1 - static_cast<int>(s2min >> 16) > thr;
}

__device__ __forceinline__ void fast_row(DenseTile<uint8_t>& s, int i,
                                         int lane, int tx0, int w, int thr) {
  const uint32_t* c = &s.in[i + 3][lane + 2];
  const uint32_t ctr = c[0];
  int s0 = 0, s1 = 0;
  if (fast_live_u16x2(tap2<-3, 0>(c), tap2<0, 3>(c), tap2<3, 0>(c),
                      tap2<0, -3>(c), ctr, thr)) {
    uint32_t t[16];
    t[0] = tap2<-3, 0>(c);
    t[1] = tap2<-3, 1>(c);
    t[2] = tap2<-2, 2>(c);
    t[3] = tap2<-1, 3>(c);
    t[4] = tap2<0, 3>(c);
    t[5] = tap2<1, 3>(c);
    t[6] = tap2<2, 2>(c);
    t[7] = tap2<3, 1>(c);
    t[8] = tap2<3, 0>(c);
    t[9] = tap2<3, -1>(c);
    t[10] = tap2<2, -2>(c);
    t[11] = tap2<1, -3>(c);
    t[12] = tap2<0, -3>(c);
    t[13] = tap2<-1, -3>(c);
    t[14] = tap2<-2, -2>(c);
    t[15] = tap2<-3, -1>(c);
    uint32_t lo, hi;
    arc_extrema_u16x2(t, lo, hi);
    s0 = fast_lane(lo & 0xffff, hi & 0xffff, ctr & 0xffff, thr);
    s1 = fast_lane(lo >> 16, hi >> 16, ctr >> 16, thr);
  }
  const int gx = tx0 + 2 * lane - 1;
  if (gx < 0 || gx >= w) s0 = -1;
  if (gx + 1 < 0 || gx + 1 >= w) s1 = -1;
  s.score[i][lane + 1] = static_cast<uint32_t>(static_cast<uint16_t>(s0)) |
                         (static_cast<uint32_t>(static_cast<uint16_t>(s1))
                          << 16);
}

// A score row outside the image: -1, so image borders never win NMS.
__device__ __forceinline__ void rim_row(DenseTile<float>& s, int i,
                                        int lane) {
  s.score[i][lane + 1] = -1.f;
  s.score[i][lane + 33] = -1.f;
}
__device__ __forceinline__ void rim_row(DenseTile<uint8_t>& s, int i,
                                        int lane) {
  s.score[i][lane + 1] = 0xffffffffu;
}

// Phase 2, blur: horizontal row i (tile row i - 3).
__device__ __forceinline__ void hblur_row(DenseTile<float>& s, int i,
                                          int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int c = lane - 1 + 32 * half;
    s.horiz[i][c + 1] = blur7(&s.in[i + 1][c + 1], 1);
  }
}

// Both lanes at once: every lane's sum is at most 255 * 36 = 9180, so
// no carry crosses into the high lane.
__device__ __forceinline__ void hblur_row(DenseTile<uint8_t>& s, int i,
                                          int lane) {
  const uint32_t* c = &s.in[i + 1][lane + 2];
  s.horiz[i][lane] = tap2<0, -3>(c) + tap2<0, 3>(c) +
                     4u * (tap2<0, -2>(c) + tap2<0, 2>(c)) +
                     8u * (tap2<0, -1>(c) + tap2<0, 1>(c)) + 10u * c[0];
}

// Phase 3: the ``n`` output rows from tile row ``r0`` of a warp's strip:
// vertical blur and norm, NMS (cs >= max of the 3 x 3 and cs > 0) or
// max(cs, 0), stored row-major (h, w).
__device__ __forceinline__ void out_strip(const DenseTile<float>& s,
                                          float* __restrict__ blur,
                                          float* __restrict__ score, int w,
                                          int ty0, int tx0, int r0, int n,
                                          int lane, int nms, int quantized) {
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int c = lane - 1 + 32 * half;
    const int gx = tx0 + c;
    if (c < 0 || c >= DENSE_TW || gx >= w) continue;
    float hv[DENSE_STRIP + 6], cs[DENSE_STRIP + 2], rm[DENSE_STRIP + 2];
#pragma unroll
    for (int k = 0; k < DENSE_STRIP + 6; ++k)
      if (k < n + 6) hv[k] = s.horiz[r0 + k][c + 1];
#pragma unroll
    for (int k = 0; k < DENSE_STRIP + 2; ++k) {
      if (k < n + 2) {
        const float* row = &s.score[r0 + k][c + 1];
        cs[k] = row[1];
        rm[k] = fmaxf(fmaxf(row[0], row[1]), row[2]);
      }
    }
#pragma unroll
    for (int k = 0; k < DENSE_STRIP; ++k) {
      if (k < n) {
        const float b = blur_norm(
            blur7_taps(hv[k], hv[k + 1], hv[k + 2], hv[k + 3], hv[k + 4],
                       hv[k + 5], hv[k + 6]),
            quantized);
        const float v = cs[k + 1];
        float out;
        if (nms) {
          const float m = fmaxf(fmaxf(rm[k], rm[k + 1]), rm[k + 2]);
          out = (v >= m && v > 0.f) ? v : 0.f;
        } else {
          out = fmaxf(v, 0.f);
        }
        const long long o = static_cast<long long>(ty0 + r0 + k) * w + gx;
        blur[o] = b;
        score[o] = out;
      }
    }
  }
}

__device__ __forceinline__ void out_strip(const DenseTile<uint8_t>& s,
                                          uint8_t* __restrict__ blur,
                                          int16_t* __restrict__ score, int w,
                                          int ty0, int tx0, int r0, int n,
                                          int lane, int nms, int quantized) {
  const int gx = tx0 + 2 * lane - 1;          // the low lane's column
  const bool ok0 = lane > 0 && gx < w;        // tile column 2 lane - 1
  const bool ok1 = lane < 31 && gx + 1 < w;   // tile column 2 lane
  if (!ok0 && !ok1) return;
  uint32_t hv[DENSE_STRIP + 6], cs[DENSE_STRIP + 2], rm[DENSE_STRIP + 2];
#pragma unroll
  for (int k = 0; k < DENSE_STRIP + 6; ++k)
    if (k < n + 6) hv[k] = s.horiz[r0 + k][lane];
#pragma unroll
  for (int k = 0; k < DENSE_STRIP + 2; ++k) {
    if (k < n + 2) {
      const uint32_t* row = &s.score[r0 + k][lane];
      cs[k] = row[1];
      rm[k] = __vimax3_s16x2(__byte_perm(row[0], row[1], 0x5432), row[1],
                             __byte_perm(row[1], row[2], 0x5432));
    }
  }
#pragma unroll
  for (int k = 0; k < DENSE_STRIP; ++k) {
    if (k < n) {
      const int b0 = blur_norm(
          blur7_taps(static_cast<int>(hv[k] & 0xffff),
                     static_cast<int>(hv[k + 1] & 0xffff),
                     static_cast<int>(hv[k + 2] & 0xffff),
                     static_cast<int>(hv[k + 3] & 0xffff),
                     static_cast<int>(hv[k + 4] & 0xffff),
                     static_cast<int>(hv[k + 5] & 0xffff),
                     static_cast<int>(hv[k + 6] & 0xffff)),
          quantized);
      const int b1 = blur_norm(
          blur7_taps(static_cast<int>(hv[k] >> 16),
                     static_cast<int>(hv[k + 1] >> 16),
                     static_cast<int>(hv[k + 2] >> 16),
                     static_cast<int>(hv[k + 3] >> 16),
                     static_cast<int>(hv[k + 4] >> 16),
                     static_cast<int>(hv[k + 5] >> 16),
                     static_cast<int>(hv[k + 6] >> 16)),
          quantized);
      const uint32_t m = __vimax3_s16x2(rm[k], rm[k + 1], rm[k + 2]);
      const int c0 = static_cast<int16_t>(cs[k + 1] & 0xffff);
      const int c1 = static_cast<int16_t>(cs[k + 1] >> 16);
      const int m0 = static_cast<int16_t>(m & 0xffff);
      const int m1 = static_cast<int16_t>(m >> 16);
      const int o0 = nms ? ((c0 >= m0 && c0 > 0) ? c0 : 0) : max(c0, 0);
      const int o1 = nms ? ((c1 >= m1 && c1 > 0) ? c1 : 0) : max(c1, 0);
      const long long o = static_cast<long long>(ty0 + r0 + k) * w + gx;
      if (ok0) {
        blur[o] = static_cast<uint8_t>(b0);
        score[o] = static_cast<int16_t>(o0);
      }
      if (ok1) {
        blur[o + 1] = static_cast<uint8_t>(b1);
        score[o + 1] = static_cast<int16_t>(o1);
      }
    }
  }
}

// The output tile at (ty0, tx0) of an (h, w) image ``img``: the 7x7 blur
// (quantized round-half-up, or the plain quotient) into ``blur`` and the
// FAST-9/16 score, 3x3-NMS'd (cs >= max and cs > 0) with ``nms`` or
// max(cs, 0) without, into ``score``; both row-major (h, w) like
// ``img``.  Score neighbours outside the image are -1 for NMS, and
// pixels past the image's edge are neither stored nor, where a whole
// row lies past it, computed, so the last partial tile of any shape is
// masked by the true (h, w).  On uint8_t pixels the blur is stored as
// uint8 and the score as int16, the -1 rim in int16 (``quantized`` is
// then 1; the wrapper checks it).  DENSE_NT threads; ``s`` in shared
// memory.
template <typename T>
__device__ __forceinline__ void dense_tile(
    const T* __restrict__ img, typename Datapath<T>::Blur* __restrict__ blur,
    typename Datapath<T>::Score* __restrict__ score, int h, int w, int ty0,
    int tx0, float threshold, int nms, int quantized, DenseTile<T>& s) {
  using A = typename Datapath<T>::Acc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const A thr = acc_threshold(threshold, A());
  load_window(img, h, w, ty0, tx0, s, warp, lane);
  __syncthreads();

  for (int i = warp; i < DENSE_SROWS; i += DENSE_WARPS) {
    const int gy = ty0 + i - 1;
    if (gy < 0 || gy >= h) {
      rim_row(s, i, lane);
    } else {
      fast_row(s, i, lane, tx0, w, thr);
    }
  }
  // Horizontal rows below h + 2 feed no output row.
  for (int i = warp; i < DENSE_HROWS && ty0 + i - 3 < h + 3;
       i += DENSE_WARPS)
    hblur_row(s, i, lane);
  __syncthreads();

  const int r0 = warp * DENSE_STRIP;
  const int n = min(DENSE_STRIP, min(DENSE_TH, h - ty0) - r0);
  if (n > 0)
    out_strip(s, blur, score, w, ty0, tx0, r0, n, lane, nms, quantized);
}

}  // namespace frontend
