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
// written twice (blur + score, 8 B): 75 MB, 22 us at 3.35 TB/s.  The
// arithmetic, each instruction class at its sm_90 pipe rate
// (chip_smoke.py, FAST_PIPES_PER_PIXEL and BLUR_NMS_PIPES_PER_PIXEL):
// every pixel's FAST on the cheaper schedule (the arc extrema 118, two
// subtractions) is 129 compare/min/max at 64 a clock per SM and 36
// float adds and multiplies at 128, 56 us; but the arc extrema are
// needed only where the exact pre-test passes (under 1% of the rendered
// scene's pixels), and the blur, NMS and pre-test take about 15 us, so
// on such frames the kernel is bound by bytes.  The uint8 variant moves
// 4 B a pixel (7.5 us) against about 20 int32 instructions a pixel (7.6
// us; the horizontal blur two pixels an instruction), its extrema DPX
// three-input min/max on packed 16-bit lanes.
//
// Design: one block per (slab, 62 x 62 output tile); the grid spans the
// largest slab and blocks past a smaller slab return at once (288 of
// 2,016 at the paper's configuration).  The tile body is
// frontend_common.cuh's dense_tile, which the per-level kernel (K6,
// frontend_level.cu) runs too: a clamped 70 x 70 window in shared
// memory, the FAST raw score on the 64 x 64 rim (an exact pre-test on
// the compass taps, then the reference's van Herk arc extrema, DPX on
// uint8), the horizontal blur pass on 68 rows, then each warp slides
// the vertical pass and the NMS down 8 output rows in registers.  The
// window is read with clamped scalar loads, a warp a row: clamping IS
// the reference's edge replication, which a TMA tile load (zeros out of
// bounds) would not give at the ragged edge, and a window row starts at
// any alignment (odd widths, slab offsets), so 16-byte accesses do not
// fit either.  The blur runs tap by tap in the reference's order with
// __fmul_rn/__fadd_rn, so nvcc cannot contract a multiply-add into an
// FMA.  The tile's shared memory (54,464 B float, 27,488 B uint8) is
// dynamic, above the 48 KB static limit.  The TPU workarounds
// (tile-aligned canvas, Unblocked halos, SMEM shape table) are gone: a
// 3-int table row per slab gives its offset and true shape.  Its FAST
// score is also K11's, its blur K12's.
//
// Pixel types: the kernel is one template over the pixel type, launched
// as frontend_kernel<float> (frontend_fused_pyramid) and as
// frontend_kernel<unsigned char> (frontend_fused_pyramid_u8), the
// reference's uint8 datapath: a uint8 blur and an int16 score, 4 B a
// pixel of traffic instead of 12.
#include "frontend_common.cuh"

namespace {

constexpr int TH = frontend::DENSE_TH;
constexpr int TW = frontend::DENSE_TW;

template <typename P>
__global__ void __launch_bounds__(frontend::DENSE_NT, 4)
frontend_kernel(const P* __restrict__ in,
                typename frontend::Datapath<P>::Blur* __restrict__ blur,
                typename frontend::Datapath<P>::Score* __restrict__ score,
                const long long* __restrict__ table, float threshold,
                int nms, int quantized) {
  const int s = blockIdx.z;
  const long long off = table[3 * s];
  const int h = static_cast<int>(table[3 * s + 1]);
  const int w = static_cast<int>(table[3 * s + 2]);
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;
  if (ty0 >= h || tx0 >= w) return;          // tile past a smaller slab

  extern __shared__ __align__(16) unsigned char smem[];
  frontend::dense_tile(in + off, blur + off, score + off, h, w, ty0, tx0,
                       threshold, nms, quantized,
                       *reinterpret_cast<frontend::DenseTile<P>*>(smem));
}

template <typename P>
int launch(const P* in, typename frontend::Datapath<P>::Blur* blur,
           typename frontend::Datapath<P>::Score* score,
           const long long* table, int n_slabs, int max_h, int max_w,
           float threshold, int nms, int quantized, cudaStream_t stream) {
  constexpr int bytes = sizeof(frontend::DenseTile<P>);
  static std::atomic<unsigned long long> smem_set{0};
  const cudaError_t err =
      frontend::allow_dynamic_smem(frontend_kernel<P>, bytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((max_w + TW - 1) / TW, (max_h + TH - 1) / TH, n_slabs);
  frontend_kernel<P><<<grid, frontend::DENSE_NT, bytes, stream>>>(
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
