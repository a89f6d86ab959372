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
// 9 us.  K1's arithmetic a pixel at each instruction's pipe rate
// (chip_smoke.py) is about 33 us and 23 us with FAST on every pixel,
// but with the arc extrema only where the exact FAST pre-test passes
// (under 1% of the rendered scene's pixels) about 9 us and 6 us: bound
// by bytes, as K1 is.
//
// Design: K1's (frontend_fused.cu) on one level.  One 256-thread block
// per (camera, 62 x 62 output tile), the grid (ceil(w/62), ceil(h/62),
// B) over the level's true shape, so no block idles; the tile body is
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

constexpr int TH = frontend::DENSE_TH;
constexpr int TW = frontend::DENSE_TW;

template <typename P>
__global__ void __launch_bounds__(frontend::DENSE_NT, 4)
frontend_level_kernel(
    const P* __restrict__ in,
    typename frontend::Datapath<P>::Blur* __restrict__ blur,
    typename frontend::Datapath<P>::Score* __restrict__ score, int h, int w,
    float threshold, int nms, int quantized) {
  const long long img = static_cast<long long>(blockIdx.z) * h * w;
  extern __shared__ __align__(16) unsigned char smem[];
  frontend::dense_tile(in + img, blur + img, score + img, h, w,
                       blockIdx.y * TH, blockIdx.x * TW, threshold, nms,
                       quantized,
                       *reinterpret_cast<frontend::DenseTile<P>*>(smem));
}

template <typename P>
int launch(const P* in, typename frontend::Datapath<P>::Blur* blur,
           typename frontend::Datapath<P>::Score* score, int B, int h,
           int w, float threshold, int nms, int quantized,
           cudaStream_t stream) {
  constexpr int bytes = sizeof(frontend::DenseTile<P>);
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      frontend::allow_dynamic_smem(frontend_level_kernel<P>, bytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, B);
  frontend_level_kernel<P><<<grid, frontend::DENSE_NT, bytes, stream>>>(
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
