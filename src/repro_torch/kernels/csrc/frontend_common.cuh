// Device code shared by the dense FE kernels: the fused dense FE over
// every slab (K1, frontend_fused.cu) and over one level (K6,
// frontend_level.cu), the FAST score map (K11, fast_detect.cu) and the
// 7x7 blur (K12, gaussian_blur.cu).  Each computes its pixels with the
// functions below, so the four cannot drift apart: K1 and K6 run the
// same tile body (dense_tile), and K11 followed by the NMS oracle and
// K12 are bit-equal to K1's score and blur.
//
// Every function reads a row-major tile in shared memory through a
// pointer and a row stride; the tile is loaded with clamped reads
// (load_tile), which is the reference's edge padding.
//
// The tile body runs on two pixel types (the reference's dtype branch
// in _tile_outputs): float, with float arithmetic rounded step by step,
// and uint8_t, the paper's 8-bit datapath, with int32 accumulators, a
// uint8 blur and an int16 score.  Datapath<T> names the types of each;
// blur7, blur_norm and fast_score have one overload for each
// accumulator type.  K1 and K6 instantiate both; K11 and K12 take float
// pixels only (the reference casts their input to float32).
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace frontend {

constexpr int TILE = 32;          // output tile edge of every dense kernel
constexpr int RAD = 3;            // blur and FAST circle radius

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bresenham circle of radius 3, (dx, dy), in order around the circle.
__constant__ int kCircle[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0},  {3, 1},  {2, 2},  {1, 3},
    {0, 3},  {-1, 3}, {-2, 2}, {-3, 1}, {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3}};

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
__device__ __forceinline__ float blur7(const float* p, int stride) {
  float acc = __fmul_rn(1.f, p[0]);
  acc = __fadd_rn(acc, __fmul_rn(4.f, p[stride]));
  acc = __fadd_rn(acc, __fmul_rn(8.f, p[2 * stride]));
  acc = __fadd_rn(acc, __fmul_rn(10.f, p[3 * stride]));
  acc = __fadd_rn(acc, __fmul_rn(8.f, p[4 * stride]));
  acc = __fadd_rn(acc, __fmul_rn(4.f, p[5 * stride]));
  acc = __fadd_rn(acc, __fmul_rn(1.f, p[6 * stride]));
  return acc;
}

// The same 7 taps in int32, exact in any order (at most 255 * 36 * 36).
__device__ __forceinline__ int blur7(const int* p, int stride) {
  return p[0] + 4 * p[stride] + 8 * p[2 * stride] + 10 * p[3 * stride] +
         8 * p[4 * stride] + 4 * p[5 * stride] + p[6 * stride];
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

// Thresholded FAST-9/16 score of the pixel at ``p`` (its 16 circle taps
// lie at p[dy * stride + dx]): max over the 16 arc starts of (min over a
// 9-tap bright arc, -max over a dark arc), 0 unless above ``threshold``.
// min and max are exact, so any association is bit-equal.
__device__ __forceinline__ float fast_score(const float* p, int stride,
                                            float threshold) {
  const float ctr = p[0];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    d[k] = __fsub_rn(p[kCircle[k][1] * stride + kCircle[k][0]], ctr);
  float bright = d[0], dark = d[0];
#pragma unroll
  for (int st = 0; st < 16; ++st) {
    float mn = d[st], mx = d[st];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = fminf(mn, d[(st + j) & 15]);
      mx = fmaxf(mx, d[(st + j) & 15]);
    }
    bright = st == 0 ? mn : fmaxf(bright, mn);
    dark = st == 0 ? mx : fminf(dark, mx);
  }
  const float sc = fmaxf(bright, -dark);
  return sc > threshold ? sc : 0.f;
}

// The same score on integer taps (differences in [-255, 255]) against
// the integer threshold floor(threshold), which for integer scores is
// the same compare.
__device__ __forceinline__ int fast_score(const int* p, int stride,
                                          int threshold) {
  const int ctr = p[0];
  int d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    d[k] = p[kCircle[k][1] * stride + kCircle[k][0]] - ctr;
  int bright = d[0], dark = d[0];
#pragma unroll
  for (int st = 0; st < 16; ++st) {
    int mn = d[st], mx = d[st];
#pragma unroll
    for (int j = 1; j < 9; ++j) {
      mn = min(mn, d[(st + j) & 15]);
      mx = max(mx, d[(st + j) & 15]);
    }
    bright = st == 0 ? mn : max(bright, mn);
    dark = st == 0 ? mx : min(dark, mx);
  }
  const int sc = max(bright, -dark);
  return sc > threshold ? sc : 0;
}

// The threshold in a datapath's accumulator type.
__device__ __forceinline__ float acc_threshold(float threshold, float) {
  return threshold;
}
__device__ __forceinline__ int acc_threshold(float threshold, int) {
  return static_cast<int>(floorf(threshold));
}

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int16_t vmax(int16_t a, int16_t b) {
  return a > b ? a : b;
}

// The fused dense tile of K1 and K6: a TILE x TILE output tile plus a
// halo of 4 (blur / FAST circle 3, NMS 1), DENSE_NT threads a block.
constexpr int DENSE_HALO = RAD + 1;
constexpr int DENSE_IW = TILE + 2 * DENSE_HALO;
constexpr int DENSE_NT = 256;

template <typename T>
struct DenseTile {
  using A = typename Datapath<T>::Acc;
  using S = typename Datapath<T>::Score;
  A in[DENSE_IW][DENSE_IW];              // the image window, clamped reads
  A horiz[TILE + 6][TILE];               // the blur's horizontal pass
  S score[TILE + 2][TILE + 2];           // raw FAST score, with the NMS rim
};

// The output tile at (ty0, tx0) of an (h, w) image ``img``: the 7x7 blur
// (quantized round-half-up, or the plain quotient) into ``blur`` and the
// FAST-9/16 score, 3x3-NMS'd (cs >= max and cs > 0) with ``nms`` or
// max(cs, 0) without, into ``score``; both row-major (h, w) like
// ``img``.  Score neighbours outside the image are -1 for NMS, and
// pixels past the image's edge are neither computed nor stored, so the
// last partial tile of any shape is masked by the true (h, w).  On
// uint8_t pixels the blur is stored as uint8 and the score as int16, the
// -1 rim in int16 (``quantized`` is then 1; the wrapper checks it).
template <typename T>
__device__ __forceinline__ void dense_tile(
    const T* __restrict__ img, typename Datapath<T>::Blur* __restrict__ blur,
    typename Datapath<T>::Score* __restrict__ score, int h, int w, int ty0,
    int tx0, float threshold, int nms, int quantized, DenseTile<T>& s) {
  using A = typename Datapath<T>::Acc;
  using B = typename Datapath<T>::Blur;
  using S = typename Datapath<T>::Score;
  const A thr = acc_threshold(threshold, A());
  load_tile(img, h, w, ty0 - DENSE_HALO, tx0 - DENSE_HALO, DENSE_IW,
            DENSE_IW, &s.in[0][0], DENSE_NT);
  __syncthreads();

  // Horizontal pass over the TILE + 6 rows the vertical pass needs.
  for (int i = threadIdx.x; i < (TILE + 6) * TILE; i += DENSE_NT) {
    const int r = i / TILE, c = i % TILE;
    s.horiz[r][c] = blur7(&s.in[r + 1][c + 1], 1);
  }

  // FAST-9/16 raw score on the (TILE + 2)^2 rim; -1 outside the true
  // image so image borders never win NMS.
  for (int i = threadIdx.x; i < (TILE + 2) * (TILE + 2); i += DENSE_NT) {
    const int r = i / (TILE + 2), c = i % (TILE + 2);
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    s.score[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                        ? static_cast<S>(fast_score(&s.in[r + 3][c + 3],
                                                    DENSE_IW, thr))
                        : static_cast<S>(-1);
  }
  __syncthreads();

  // Vertical pass, quantize, NMS, store.
  for (int i = threadIdx.x; i < TILE * TILE; i += DENSE_NT) {
    const int r = i / TILE, c = i % TILE;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= h || gx >= w) continue;
    const B b =
        static_cast<B>(blur_norm(blur7(&s.horiz[r][c], TILE), quantized));
    const S cs = s.score[r + 1][c + 1];
    const S zero = static_cast<S>(0);
    S out;
    if (nms) {
      S m = cs;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = vmax(m, s.score[r + dy][c + dx]);
      out = (cs >= m && cs > zero) ? cs : zero;
    } else {
      out = vmax(cs, zero);
    }
    const long long o = static_cast<long long>(gy) * w + gx;
    blur[o] = b;
    score[o] = out;
  }
}

}  // namespace frontend
