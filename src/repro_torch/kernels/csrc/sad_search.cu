// SAD sweep of the unfused Feature Matcher schedule: the int32 SAD
// table of caller-gathered windows, in one launch.
//
// Replaces the TPU kernel repro/kernels/sad_rectify.py::
// sad_search_pallas (pl.pallas_call at line 44, body _kernel at :27):
// per keypoint, the (P, P) left patch against the (P, P + 2R) right
// strip at each of the 2R + 1 shifts, both truncated to int32 (the
// reference's astype, toward zero) before the differences.  The caller
// (core.matching.sad_rectify_unfused) gathers the windows with
// ref.gather_patches and takes the first-occurrence argmin.
//
// Bound on an H100 SXM at one 720p pair (1000 keypoints, 11 x 11
// windows, +-5 shifts): 1000 x (121 + 231) float32 pixels in and the
// 44 KB table out, about 0.4 us at 3.35 TB/s; their truncation and the
// SAD terms at their pipes' rates (chip_smoke.py) well under that.  Both
// are far below a launch's latency: the kernel is bound by launch
// latency.
//
// Design: one warp per keypoint row, eight per block, running the fused
// matcher's sweep (matcher_common.cuh sweep_rows) on the gathered
// windows: the warp reads them row by row, lane = column, truncated to
// int32, through its shared buffer; lane r then holds row r of its patch
// and strip in registers and sums every shift at once; one transposing
// reduction leaves shift s in lane s, and lanes 0..2R write the table
// row.  The TPU's 128-row blocks and the padding of K to them are not
// needed: K is any size.  Windows up to MAXP px and sweeps up to +-MAXR
// px are held; the wrapper refuses larger ones.
#include "matcher_common.cuh"

namespace {

using matcher::MAXP;
using matcher::MAXR;

constexpr int WARPS = 8;

template <int PM, int RM>
__global__ void __launch_bounds__(WARPS * 32)
sad_search_kernel(const float* __restrict__ lp, const float* __restrict__ rs,
                  int* __restrict__ table, int K, int patch, int sad_range) {
  __shared__ int s_buf[WARPS][matcher::SweepBuffer<PM, RM>::WORDS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * WARPS + warp;
  if (q >= K) return;                     // whole warp leaves
  // The paper's <11, 5> sizes as constants; the generic <MAXP, MAXR>
  // instantiation takes them from the arguments.
  constexpr bool kGeneric = PM == MAXP && RM == MAXR;
  const int pw = kGeneric ? patch : PM, pr = kGeneric ? sad_range : RM;
  const int sw = pw + 2 * pr;             // strip width
  const matcher::GatheredRows left{lp + static_cast<long long>(q) * pw * pw,
                                   pw};
  const matcher::GatheredRows right{rs + static_cast<long long>(q) * pw * sw,
                                    sw};
  int sads[matcher::Shifts<RM>::GROUPS];
  matcher::sweep_rows<PM, RM, true>(left, right, pw, pr, lane, s_buf[warp],
                                    sads);
  matcher::sweep_store<RM>(sads, pr, lane,
                           table + static_cast<long long>(q) * (2 * pr + 1));
}

}  // namespace

extern "C" int sad_search(const float* lp, const float* rs, int* table,
                          int K, int patch, int sad_range,
                          cudaStream_t stream) {
  if (patch < 1 || patch > MAXP || sad_range < 0 || sad_range > MAXR)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((K + WARPS - 1) / WARPS));
  if (patch == 11 && sad_range == 5)
    sad_search_kernel<11, 5><<<grid, WARPS * 32, 0, stream>>>(
        lp, rs, table, K, patch, sad_range);
  else
    sad_search_kernel<MAXP, MAXR><<<grid, WARPS * 32, 0, stream>>>(
        lp, rs, table, K, patch, sad_range);
  return static_cast<int>(cudaGetLastError());
}
