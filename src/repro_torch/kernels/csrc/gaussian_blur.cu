// Separable 7x7 binomial blur of a batch of images in one launch.
//
// Replaces the TPU kernel repro/kernels/gaussian_blur.py::
// gaussian_blur7_pallas (pl.pallas_call at line 59, body _kernel): the
// horizontal pass [1, 4, 8, 10, 8, 4, 1], then the vertical one, each
// summed tap by tap in order, over the norm 36^2 with the quantized
// round half up or the plain quotient.  Taps past the border replicate
// the edge pixel.
//
// Bound on an H100 SXM for one 720 x 1280 level: 0.92 M pixels read
// once and written once (7.4 MB, 2.2 us at 3.35 TB/s) against 33 FP32
// instructions a pixel (two passes of 7 multiplies and 6 adds, the norm's
// add and floor, the IEEE divide's 5 FFMA), its FCHK and its reciprocal
// at their pipes' rates (chip_smoke.py BLUR_PIPES_PER_PIXEL: about
// 1.2 us), so the kernel is bound by bytes.
//
// Design: one 256-thread block per (image, 32x32 output tile), as K1
// tiles; the tile plus a halo of 3 is loaded into shared memory with
// clamped reads (the reference's edge pad: no padded copy, no Unblocked
// halo), the horizontal pass fills a (32 + 6) x 32 shared buffer and the
// vertical pass reads it.  Both passes are frontend_common.cuh's blur7,
// with __fmul_rn/__fadd_rn and an IEEE divide, the same device code K1
// runs, so nvcc cannot contract a multiply-add into an FMA (which would
// differ from the reference in the last bit on float frames).
#include "frontend_common.cuh"

namespace {

constexpr int T = frontend::TILE;
constexpr int HALO = frontend::RAD;
constexpr int IW = T + 2 * HALO;
constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
blur_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
            int w, int quantized) {
  const long long img = static_cast<long long>(blockIdx.z) * h * w;
  const int ty0 = blockIdx.y * T;
  const int tx0 = blockIdx.x * T;
  __shared__ float s_in[IW][IW];
  __shared__ float s_h[IW][T];
  frontend::load_tile(in + img, h, w, ty0 - HALO, tx0 - HALO, IW, IW,
                      &s_in[0][0], NT);
  __syncthreads();
  for (int i = threadIdx.x; i < IW * T; i += NT) {
    const int r = i / T, c = i % T;
    s_h[r][c] = frontend::blur7(&s_in[r][c], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * T; i += NT) {
    const int r = i / T, c = i % T;
    const int gy = ty0 + r, gx = tx0 + c;
    if (gy >= h || gx >= w) continue;
    out[img + static_cast<long long>(gy) * w + gx] =
        frontend::blur_norm(frontend::blur7(&s_h[r][c], T), quantized);
  }
}

}  // namespace

extern "C" int gaussian_blur7(const float* in, float* out, int B, int h,
                              int w, int quantized, cudaStream_t stream) {
  const dim3 grid((w + T - 1) / T, (h + T - 1) / T, B);
  blur_kernel<<<grid, NT, 0, stream>>>(in, out, h, w, quantized);
  return static_cast<int>(cudaGetLastError());
}
