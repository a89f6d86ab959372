// Dense FE over every camera x pyramid level in one launch.
//
// Replaces the TPU kernel repro/kernels/frontend_fused.py::
// frontend_fused_pyramid_pallas (pl.pallas_call at line 305): for every
// pixel of every slab, the 7x7 binomial blur (quantized round-half-up)
// and the 3x3-NMS'd FAST-9/16 score, with -1 outside the slab's true
// (h, w) for NMS and edge-replicated taps.
//
// Bound on an H100 SXM at the paper's configuration (4 cameras, levels
// 720x1280 and 600x1067): 6.25 M pixels, each read once (4 B) and
// written twice (blur + score, 8 B): 75 MB, about 22 us at 3.35 TB/s.
// The arithmetic (about 210 float operations a pixel with the van Herk
// arc extrema the reference uses) is about 20 us at 67 TFLOP/s, so the
// kernel is bound by bytes, just.
//
// Design: one block per (slab, 32x32 output tile); the grid spans the
// largest slab and blocks past a smaller slab return at once.  The tile
// plus a halo of 4 is loaded into shared memory with clamped reads
// (clamping IS edge replication, so no padded canvas exists).  Blur runs
// horizontal then vertical, tap by tap in the reference's order, with
// __fmul_rn/__fadd_rn so nvcc cannot contract a multiply-add into an
// FMA (the reference rounds the product and the sum separately).  The
// FAST score is computed on the (tile+2)^2 rim so NMS needs no second
// pass.  The TPU workarounds (tile-aligned canvas, Unblocked halos, SMEM
// shape table) are gone: a 3-int table row per slab gives its offset
// and true shape.
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;            // output tile width
constexpr int TH = 32;            // output tile height
constexpr int HALO = 4;           // 3 (blur / FAST circle) + 1 (NMS)
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int NT = 256;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Bresenham circle of radius 3, (dx, dy), in order around the circle.
__constant__ int kCircle[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0},  {3, 1},  {2, 2},  {1, 3},
    {0, 3},  {-1, 3}, {-2, 2}, {-3, 1}, {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3}};

// 7 taps of the binomial blur in order, then a separately rounded add.
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

__global__ void __launch_bounds__(NT)
frontend_kernel(const float* __restrict__ in, float* __restrict__ blur,
                float* __restrict__ score, const long long* __restrict__ table,
                float threshold, int nms, int quantized) {
  const int s = blockIdx.z;
  const long long off = table[3 * s];
  const int h = static_cast<int>(table[3 * s + 1]);
  const int w = static_cast<int>(table[3 * s + 2]);
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  if (ty0 >= h || tx0 >= w) return;          // tile past a smaller slab

  __shared__ float s_in[IH][IW];
  __shared__ float s_h[TH + 6][TW];
  __shared__ float s_sc[TH + 2][TW + 2];
  const float* img = in + off;

  for (int i = threadIdx.x; i < IH * IW; i += NT) {
    const int r = i / IW, c = i % IW;
    const int gy = clampi(ty0 - HALO + r, 0, h - 1);
    const int gx = clampi(tx0 - HALO + c, 0, w - 1);
    s_in[r][c] = img[static_cast<long long>(gy) * w + gx];
  }
  __syncthreads();

  // Horizontal pass over the TH + 6 rows the vertical pass needs.
  for (int i = threadIdx.x; i < (TH + 6) * TW; i += NT) {
    const int r = i / TW, c = i % TW;
    s_h[r][c] = blur7(&s_in[r + 1][c + 1], 1);
  }

  // FAST-9/16 raw score on the (TH + 2) x (TW + 2) rim; -1 outside the
  // true image so image borders never win NMS.
  for (int i = threadIdx.x; i < (TH + 2) * (TW + 2); i += NT) {
    const int r = i / (TW + 2), c = i % (TW + 2);
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + c;
    float v = -1.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const float ctr = s_in[r + 3][c + 3];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        d[k] = __fsub_rn(s_in[r + 3 + kCircle[k][1]][c + 3 + kCircle[k][0]],
                         ctr);
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
      v = sc > threshold ? sc : 0.f;
    }
    s_sc[r][c] = v;
  }
  __syncthreads();

  // Vertical pass, quantize, NMS, store.
  for (int i = threadIdx.x; i < TH * TW; i += NT) {
    const int r = i / TW, c = i % TW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= h || gx >= w) continue;
    const float vert = blur7(&s_h[r][c], TW);
    const float b = quantized ? floorf(__fdiv_rn(__fadd_rn(vert, 648.f), 1296.f))
                              : __fdiv_rn(vert, 1296.f);
    const float cs = s_sc[r + 1][c + 1];
    float out;
    if (nms) {
      float m = cs;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, s_sc[r + dy][c + dx]);
      out = (cs >= m && cs > 0.f) ? cs : 0.f;
    } else {
      out = fmaxf(cs, 0.f);
    }
    const long long o = off + static_cast<long long>(gy) * w + gx;
    blur[o] = b;
    score[o] = out;
  }
}

}  // namespace

extern "C" int frontend_fused_pyramid(const float* in, float* blur,
                                      float* score, const long long* table,
                                      int n_slabs, int max_h, int max_w,
                                      float threshold, int nms, int quantized,
                                      cudaStream_t stream) {
  const dim3 grid((max_w + TW - 1) / TW, (max_h + TH - 1) / TH, n_slabs);
  frontend_kernel<<<grid, NT, 0, stream>>>(in, blur, score, table, threshold,
                                           nms, quantized);
  return static_cast<int>(cudaGetLastError());
}
