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
// strip pixels plus the 88 KB table, about 0.2 us at 3.35 TB/s; 2.7 M
// SAD terms at 3 operations, about 0.1 us at 67 TFLOP/s.  Both are far
// below a launch's latency: the kernel is bound by launch latency.
//
// Design: one warp per (pair, keypoint), eight per block, one launch
// over every pair.  The window and strip are read from the images in
// global memory with clamped reads (matcher_common.cuh), which is the
// reference's edge padding: the TPU's edge-padded, tile-aligned slabs
// resident in VMEM (_pad_fm_slab) are not built.  The sweep reduces each
// shift's SAD over the warp, and lanes 0..2R write the table row.
//
// Pixel types: one template, launched as sad_only_kernel<float>
// (sad_fused) and sad_only_kernel<unsigned char> (sad_fused_u8, on the
// uint8 datapath's images); the SAD is int32 either way.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 8;

template <typename Pix>
__global__ void __launch_bounds__(WARPS * 32)
sad_only_kernel(const float* __restrict__ xyl, const float* __restrict__ xyr,
                const Pix* __restrict__ il, const Pix* __restrict__ ir,
                int* __restrict__ table, int P, int K, int H, int W,
                int patch, int sad_range) {
  __shared__ int s_l[WARPS][MAXP * MAXP];
  __shared__ int s_r[WARPS][MAXP * (MAXP + 2 * MAXR)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (q >= static_cast<long long>(P) * K) return;    // whole warp leaves
  const int p = static_cast<int>(q / K);
  const long long img = static_cast<long long>(p) * H * W;
  matcher::load_windows(il + img, ir + img, H, W, xyl[2 * q], xyl[2 * q + 1],
                        xyr[2 * q], xyr[2 * q + 1], patch, sad_range, lane,
                        s_l[warp], s_r[warp]);
  const int sweep = 2 * sad_range + 1;
  int mine = 0;
  for (int s = 0; s < sweep; ++s) {
    const int acc = matcher::warp_sad(s_l[warp], s_r[warp], patch,
                                      sad_range, s, lane);
    if (lane == s) mine = acc;
  }
  if (lane < sweep) table[q * sweep + lane] = mine;
}

template <typename Pix>
int launch(const float* xyl, const float* xyr, const Pix* il, const Pix* ir,
           int* table, int P, int K, int H, int W, int patch, int sad_range,
           cudaStream_t stream) {
  if (patch > MAXP || sad_range > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(P) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  sad_only_kernel<Pix><<<grid, WARPS * 32, 0, stream>>>(
      xyl, xyr, il, ir, table, P, K, H, W, patch, sad_range);
  return static_cast<int>(cudaGetLastError());
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
