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
// once and written once (7.4 MB, 2.2 us at 3.35 TB/s) against about 306
// float operations a pixel (16 differences, 16 arcs of 8 min and 8 max,
// the running extrema and the threshold: 0.28 G, 4.2 us at 67 TFLOP/s),
// so the kernel is bound by operations.
//
// Design: one 256-thread block per (image, 32x32 output tile), as K1
// tiles; the tile plus a halo of 3 is loaded into shared memory with
// clamped reads (the reference's edge pad, so the TPU's tile-aligned
// padded copy and its Unblocked halo windows are gone), and each thread
// scores its pixels with frontend_common.cuh's fast_score, the same
// device function K1 runs.
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
