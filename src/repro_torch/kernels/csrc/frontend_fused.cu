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
// and true shape.  The tile body is frontend_common.cuh's dense_tile,
// which the per-level kernel (K6, frontend_level.cu) runs too; its tile
// load, blur and FAST score are also K11's and K12's.
//
// Pixel types: the kernel is one template over the pixel type, launched
// as frontend_kernel<float> (frontend_fused_pyramid) and as
// frontend_kernel<unsigned char> (frontend_fused_pyramid_u8), the
// reference's uint8 datapath: int32 arithmetic, a uint8 blur and an
// int16 score, 4 B a pixel of traffic instead of 12.
#include "frontend_common.cuh"

namespace {

constexpr int T = frontend::TILE;

template <typename P>
__global__ void __launch_bounds__(frontend::DENSE_NT)
frontend_kernel(const P* __restrict__ in,
                typename frontend::Datapath<P>::Blur* __restrict__ blur,
                typename frontend::Datapath<P>::Score* __restrict__ score,
                const long long* __restrict__ table, float threshold,
                int nms, int quantized) {
  const int s = blockIdx.z;
  const long long off = table[3 * s];
  const int h = static_cast<int>(table[3 * s + 1]);
  const int w = static_cast<int>(table[3 * s + 2]);
  const int ty0 = blockIdx.y * T;
  const int tx0 = blockIdx.x * T;
  if (ty0 >= h || tx0 >= w) return;          // tile past a smaller slab

  __shared__ frontend::DenseTile<P> tile;
  frontend::dense_tile(in + off, blur + off, score + off, h, w, ty0, tx0,
                       threshold, nms, quantized, tile);
}

template <typename P>
int launch(const P* in, typename frontend::Datapath<P>::Blur* blur,
           typename frontend::Datapath<P>::Score* score,
           const long long* table, int n_slabs, int max_h, int max_w,
           float threshold, int nms, int quantized, cudaStream_t stream) {
  const dim3 grid((max_w + T - 1) / T, (max_h + T - 1) / T, n_slabs);
  frontend_kernel<P><<<grid, frontend::DENSE_NT, 0, stream>>>(
      in, blur, score, table, threshold, nms, quantized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int frontend_fused_pyramid(const float* in, float* blur,
                                      float* score, const long long* table,
                                      int n_slabs, int max_h, int max_w,
                                      float threshold, int nms, int quantized,
                                      cudaStream_t stream) {
  return launch(in, blur, score, table, n_slabs, max_h, max_w, threshold,
                nms, quantized, stream);
}

extern "C" int frontend_fused_pyramid_u8(const uint8_t* in, uint8_t* blur,
                                         int16_t* score,
                                         const long long* table, int n_slabs,
                                         int max_h, int max_w,
                                         float threshold, int nms,
                                         int quantized, cudaStream_t stream) {
  return launch(in, blur, score, table, n_slabs, max_h, max_w, threshold,
                nms, quantized, stream);
}
