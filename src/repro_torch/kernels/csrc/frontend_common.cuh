// Device code shared by the dense FE kernels: the fused dense FE (K1,
// frontend_fused.cu), the FAST score map (K11, fast_detect.cu) and the
// 7x7 blur (K12, gaussian_blur.cu).  Each computes its pixels with the
// functions below, so the three cannot drift apart: K11 followed by the
// NMS oracle and K12 are bit-equal to K1's score and blur.
//
// Every function reads a row-major tile in shared memory through a
// pointer and a row stride; the tile is loaded with clamped reads
// (load_tile), which is the reference's edge padding.
#pragma once

#include <cuda_runtime.h>

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

// Load the (rows x cols) window of an (h, w) image whose top-left pixel
// is (y0, x0), every read clamped into the image, into ``dst`` (row
// stride ``cols``), with ``nt`` threads of the block.
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          int h, int w, int y0, int x0,
                                          int rows, int cols, float* dst,
                                          int nt) {
  for (int i = threadIdx.x; i < rows * cols; i += nt) {
    const int r = i / cols, c = i % cols;
    const int gy = clampi(y0 + r, 0, h - 1);
    const int gx = clampi(x0 + c, 0, w - 1);
    dst[i] = img[static_cast<long long>(gy) * w + gx];
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

// The vertical pass's sum over the norm 36^2 = 1296: round half up with
// ``quantized``, else the plain IEEE quotient.
__device__ __forceinline__ float blur_norm(float vert, int quantized) {
  return quantized ? floorf(__fdiv_rn(__fadd_rn(vert, 648.f), 1296.f))
                   : __fdiv_rn(vert, 1296.f);
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

}  // namespace frontend
