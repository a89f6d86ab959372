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
// and true shape.  The tile load, blur and FAST score are the shared
// device functions of frontend_common.cuh (also K11's and K12's).
#include "frontend_common.cuh"

namespace {

using frontend::blur7;
using frontend::blur_norm;
using frontend::fast_score;

constexpr int TW = frontend::TILE;    // output tile width
constexpr int TH = frontend::TILE;    // output tile height
constexpr int HALO = frontend::RAD + 1;  // blur / FAST circle + NMS
constexpr int IW = TW + 2 * HALO;
constexpr int IH = TH + 2 * HALO;
constexpr int NT = 256;

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
  frontend::load_tile(in + off, h, w, ty0 - HALO, tx0 - HALO, IH, IW,
                      &s_in[0][0], NT);
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
    s_sc[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                     ? fast_score(&s_in[r + 3][c + 3], IW, threshold)
                     : -1.f;
  }
  __syncthreads();

  // Vertical pass, quantize, NMS, store.
  for (int i = threadIdx.x; i < TH * TW; i += NT) {
    const int r = i / TW, c = i % TW;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= h || gx >= w) continue;
    const float b = blur_norm(blur7(&s_h[r][c], TW), quantized);
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
