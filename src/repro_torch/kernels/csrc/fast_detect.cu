// FAST-9/16 score map of a batch of images in one launch.
//
// Replaces the TPU kernel repro/kernels/fast_detect.py::
// fast_score_map_pallas (pl.pallas_call at line 66, body _kernel): per
// pixel, the 16 Bresenham circle taps minus the center, for each of the
// 16 arc starts the min and max over 9 contiguous taps, then
// max(bright, -dark), kept where it is above the threshold and 0
// elsewhere.  Taps past the border replicate the edge pixel.
//
// Bound on an H100 SXM for one 720 x 1280 level: 0.92 M pixels read
// once and written once (7.4 MB, 2.2 us at 3.35 TB/s) against the
// cheaper of the reference's schedule and this one, counted at each
// instruction's pipe rate (chip_smoke.py, FAST_PIPES_PER_PIXEL): 2 float
// subtractions at 128 a clock per SM and 121 compare/min/max at 64 (the
// arc extrema 118), 6.7 us.  The extrema are needed only where the exact pre-test
// passes (under 1% of the rendered scene's pixels; the pre-test itself
// 0.7 us), so on such images the kernel is bound by bytes.
//
// Design: one 256-thread block per (image, 32x32 output tile), as K12
// tiles; the tile plus a halo of 3 is loaded into shared memory with
// clamped reads (the reference's edge pad, so the TPU's tile-aligned
// padded copy and its Unblocked halo windows are gone), and each thread
// scores its pixels with frontend_common.cuh's fast_score, the same
// device function K1 runs: the compass pre-test, then the van Herk arc
// extrema on the raw taps (59 FMNMX a side), the centre subtracted once
// a side.
#include "frontend_common.cuh"

namespace {

constexpr int T = frontend::TILE;
constexpr int HALO = frontend::RAD;
constexpr int IW = T + 2 * HALO;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
fast_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
            int w, float threshold) {
  const long long img = static_cast<long long>(blockIdx.z) * h * w;
  const int ty0 = blockIdx.y * T;
  const int tx0 = blockIdx.x * T;
  __shared__ float s_in[IW][IW];
  frontend::load_tile(in + img, h, w, ty0 - HALO, tx0 - HALO, IW, IW,
                      &s_in[0][0], NT);
  __syncthreads();
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int r = i / T, c = i % T;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= h || gx >= w) continue;
    out[img + static_cast<long long>(gy) * w + gx] =
        frontend::fast_score(&s_in[r + HALO][c + HALO], IW, threshold);
  }
}

}  // namespace

extern "C" int fast_score_map(const float* in, float* out, int B, int h,
                              int w, float threshold, cudaStream_t stream) {
  const dim3 grid((w + T - 1) / T, (h + T - 1) / T, B);
  fast_kernel<<<grid, NT, 0, stream>>>(in, out, h, w, threshold);
  return static_cast<int>(cudaGetLastError());
}
