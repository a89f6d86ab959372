// Dense FE of one pyramid level, all cameras, in one launch.
//
// Replaces the TPU kernel repro/kernels/frontend_fused.py::
// frontend_fused_pallas (pl.pallas_call at line 255; body _kernel and
// _tile_outputs): for every pixel of a (B, h, w) batch of one level, the
// 7x7 binomial blur (quantized round-half-up, or the plain quotient) and
// the FAST-9/16 score, 3x3-NMS'd with -1 outside the true (h, w), or
// max(score, 0) without NMS; taps past the border replicate the edge
// pixel.  It serves the per-level FE schedule
// (orb.extract_features_per_level), 1 launch a level.
//
// Bound on an H100 SXM at the paper's configuration (4 cameras): level
// 0 is 3.69 M pixels, each read once (4 B) and written twice (blur +
// score, 8 B), 44 MB, 13 us at 3.35 TB/s; level 1 (600 x 1067) 31 MB,
// 9 us.  About 200 float operations a pixel are 11 us and 8 us at 67
// TFLOP/s, so each launch is bound by bytes, just, as K1 is.
//
// Design: K1's (frontend_fused.cu) on one level.  One 256-thread block
// per (camera, 32x32 output tile), the grid (ceil(w/32), ceil(h/32), B)
// over the level's true shape, so no block idles; the tile body is
// frontend_common.cuh's dense_tile, the same device code K1 runs, which
// masks the last partial tile by the true (h, w) both in the NMS rim
// (-1) and in the store.  The TPU's 128 x 128 tile alignment, its
// FUSED_HALO edge-padded canvas and Unblocked halo windows are gone:
// clamped reads are the edge pad.
//
// Pixel types: one template, launched as frontend_level_kernel<float>
// (frontend_fused) and frontend_level_kernel<unsigned char>
// (frontend_fused_u8, the uint8 datapath of dense_tile).
#include "frontend_common.cuh"

namespace {

constexpr int T = frontend::TILE;

template <typename P>
__global__ void __launch_bounds__(frontend::DENSE_NT)
frontend_level_kernel(
    const P* __restrict__ in,
    typename frontend::Datapath<P>::Blur* __restrict__ blur,
    typename frontend::Datapath<P>::Score* __restrict__ score, int h, int w,
    float threshold, int nms, int quantized) {
  const long long img = static_cast<long long>(blockIdx.z) * h * w;
  __shared__ frontend::DenseTile<P> tile;
  frontend::dense_tile(in + img, blur + img, score + img, h, w,
                       blockIdx.y * T, blockIdx.x * T, threshold, nms,
                       quantized, tile);
}

template <typename P>
int launch(const P* in, typename frontend::Datapath<P>::Blur* blur,
           typename frontend::Datapath<P>::Score* score, int B, int h,
           int w, float threshold, int nms, int quantized,
           cudaStream_t stream) {
  const dim3 grid((w + T - 1) / T, (h + T - 1) / T, B);
  frontend_level_kernel<P><<<grid, frontend::DENSE_NT, 0, stream>>>(
      in, blur, score, h, w, threshold, nms, quantized);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int frontend_fused(const float* in, float* blur, float* score,
                              int B, int h, int w, float threshold, int nms,
                              int quantized, cudaStream_t stream) {
  return launch(in, blur, score, B, h, w, threshold, nms, quantized, stream);
}

extern "C" int frontend_fused_u8(const uint8_t* in, uint8_t* blur,
                                 int16_t* score, int B, int h, int w,
                                 float threshold, int nms, int quantized,
                                 cudaStream_t stream) {
  return launch(in, blur, score, B, h, w, threshold, nms, quantized, stream);
}
