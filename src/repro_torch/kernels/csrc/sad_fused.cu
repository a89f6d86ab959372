// SAD-only Feature Matcher: the whole SAD table for caller-given
// window centers, in one launch.
//
// Replaces the TPU kernel repro/kernels/matcher_fused.py::
// sad_fused_pallas (pl.pallas_call at line 292, body _sad_only_kernel
// with _clamped_start and _sad_row): per (pair, keypoint), the
// (patch, patch) left window around the rounded, clamped left center
// against the (patch, patch + 2R) right strip around the rounded,
// clamped right center, the int32 SAD at each of the 2R + 1 shifts.
// The caller takes the argmin (VisualSystem.sad_rectify).
//
// Bound on an H100 SXM at sad_rectify's shapes (2 pairs x 1000
// keypoints, 11 x 11 windows, +-5 shifts): under 1 MB of window and
// strip pixels plus the 88 KB table, about 0.2 us at 3.35 TB/s; the SAD
// terms at the int32 rate (chip_smoke.py sad_bound) well under that.
// Both are far below a launch's latency: the kernel is bound by launch
// latency.
//
// Design: one warp per (pair, keypoint), eight per block, one launch
// over every pair.  The window and strip are read from the images in
// global memory with clamped reads, which is the reference's edge
// padding: the TPU's edge-padded, tile-aligned slabs resident in VMEM
// (_pad_fm_slab) are not built.  The sweep is K3's (matcher_common.cuh
// sweep_rows: both read row by row, lane = column, through the warp's
// shared buffer; lane r then holds row r of both in registers and sums
// every shift at once; one transposing reduction), and lanes 0..2R write
// the table row.
//
// Pixel types: one template, launched as sad_only_kernel<float, ...>
// (sad_fused) and sad_only_kernel<unsigned char, ...> (sad_fused_u8, on
// the uint8 datapath's images); the SAD is int32 either way.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 8;

template <typename Pix, int PM, int RM>
__global__ void __launch_bounds__(WARPS * 32)
sad_only_kernel(const float* __restrict__ xyl, const float* __restrict__ xyr,
                const Pix* __restrict__ il, const Pix* __restrict__ ir,
                int* __restrict__ table, int P, int K, int H, int W,
                int patch, int sad_range) {
  __shared__ int s_buf[WARPS][matcher::SweepBuffer<PM, RM>::WORDS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (q >= static_cast<long long>(P) * K) return;    // whole warp leaves
  const int p = static_cast<int>(q / K);
  // The paper's <11, 5> sizes as constants; the generic <MAXP, MAXR>
  // instantiation takes them from the arguments.
  constexpr bool kGeneric = PM == MAXP && RM == MAXR;
  const int pw = kGeneric ? patch : PM, pr = kGeneric ? sad_range : RM;
  const long long img = static_cast<long long>(p) * H * W;
  const matcher::ImageRows<Pix> left(il + img, H, W, xyl[2 * q],
                                     xyl[2 * q + 1], pw / 2, pw / 2);
  const matcher::ImageRows<Pix> right(ir + img, H, W, xyr[2 * q],
                                      xyr[2 * q + 1], pw / 2,
                                      (pw + 2 * pr) / 2);
  int sads[matcher::Shifts<RM>::GROUPS];
  matcher::sweep_rows<PM, RM, true>(left, right, pw, pr, lane, s_buf[warp],
                                    sads);
  matcher::sweep_store<RM>(sads, pr, lane, table + q * (2 * pr + 1));
}

template <typename Pix, int PM, int RM>
int launch_sizes(const float* xyl, const float* xyr, const Pix* il,
                 const Pix* ir, int* table, int P, int K, int H, int W,
                 int patch, int sad_range, cudaStream_t stream) {
  const long long n = static_cast<long long>(P) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  sad_only_kernel<Pix, PM, RM><<<grid, WARPS * 32, 0, stream>>>(
      xyl, xyr, il, ir, table, P, K, H, W, patch, sad_range);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pix>
int launch(const float* xyl, const float* xyr, const Pix* il, const Pix* ir,
           int* table, int P, int K, int H, int W, int patch, int sad_range,
           cudaStream_t stream) {
  if (patch < 1 || patch > MAXP || sad_range < 0 || sad_range > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  if (patch == 11 && sad_range == 5)
    return launch_sizes<Pix, 11, 5>(xyl, xyr, il, ir, table, P, K, H, W,
                                    patch, sad_range, stream);
  return launch_sizes<Pix, MAXP, MAXR>(xyl, xyr, il, ir, table, P, K, H, W,
                                       patch, sad_range, stream);
}

}  // namespace

extern "C" int sad_fused(const float* xyl, const float* xyr, const float* il,
                         const float* ir, int* table, int P, int K, int H,
                         int W, int patch, int sad_range,
                         cudaStream_t stream) {
  return launch(xyl, xyr, il, ir, table, P, K, H, W, patch, sad_range,
                stream);
}

extern "C" int sad_fused_u8(const float* xyl, const float* xyr,
                            const uint8_t* il, const uint8_t* ir, int* table,
                            int P, int K, int H, int W, int patch,
                            int sad_range, cudaStream_t stream) {
  return launch(xyl, xyr, il, ir, table, P, K, H, W, patch, sad_range,
                stream);
}
