// The whole Feature Matcher stage of a frame in one launch.
//
// Replaces the TPU kernel repro/kernels/matcher_fused.py::
// match_rectify_fused_pallas (pl.pallas_call at line 208): per left
// feature of every stereo pair, the masked Hamming argmin over the
// pair's right features (row band, disparity range, same level, both
// valid; ties to the lowest index), the max_hamming gate with the
// fallback to right feature 0, and the int32 SAD of an 11x11 window
// against an 11x21 strip over the +-5 shifts, first-occurrence argmin.
//
// Bound on an H100 SXM at the paper's configuration (2 pairs x 1000 x
// 1000 features): about 0.3 MB of descriptors, meta rows and window
// pixels, 0.1 us at 3.35 TB/s; 2 M candidate pairs at ~10 operations
// for the search-region test (plus 26 for the few inside it) and 2.7 M
// SAD terms at 3: about 28 M operations, 0.4 us at 67 TFLOP/s.  Either
// is far below a launch's latency: the kernel is bound by launch
// latency and by each warp's serial walk over the right features.
//
// Design: one warp per left feature, eight per block, one launch over
// all pairs.  Lanes stride over the right features in index order,
// each keeping a strict-< running minimum, and a shuffle reduction on
// (distance, index) keeps the lowest index among equal distances — the
// reference's first-occurrence argmin.  Centers round half to even
// (rintf, not roundf) and clamp into the image; the window and strip
// are read from the level-0 images in global memory with clamped reads
// (the TPU kept whole slabs resident in VMEM), truncated to int32 as
// the reference's astype, and the SAD is summed in int32, so any order
// is exact.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int BIG = 1 << 20;
constexpr int MAXP = 15;                  // largest window the kernel holds
constexpr int MAXR = 15;                  // largest sweep half-range
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(WARPS * 32)
match_kernel(const int* __restrict__ dl, const float* __restrict__ ml,
             const int* __restrict__ dr, const float* __restrict__ mr,
             const float* __restrict__ il, const float* __restrict__ ir,
             int* __restrict__ dist_out, int* __restrict__ idx_out,
             float* __restrict__ rxy_out, int* __restrict__ sad_out, int P,
             int K, int M, int H, int W, float row_band, float max_disp,
             int max_hamming, int patch, int sad_range) {
  __shared__ int s_l[WARPS][MAXP * MAXP];
  __shared__ int s_r[WARPS][MAXP * (MAXP + 2 * MAXR)];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * WARPS + warp;
  if (q >= static_cast<long long>(P) * K) return;    // whole warp leaves
  const int p = static_cast<int>(q / K);

  const float lx = ml[4 * q], ly = ml[4 * q + 1], llv = ml[4 * q + 2];
  const bool lvalid = ml[4 * q + 3] > 0.5f;
  unsigned d[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = static_cast<unsigned>(dl[8 * q + k]);

  const int* drp = dr + static_cast<long long>(p) * M * 8;
  const float* mrp = mr + static_cast<long long>(p) * M * 4;
  int best = BIG, bidx = -1;
  if (lvalid) {
    for (int j = lane; j < M; j += 32) {
      const float* m = mrp + 4 * j;
      const float dx = __fsub_rn(lx, m[0]);
      const float dy = fabsf(__fsub_rn(ly, m[1]));
      if (!(dy <= row_band && dx >= 0.f && dx <= max_disp && llv == m[2] &&
            m[3] > 0.5f))
        continue;                         // BIG: never improves the min
      int dd = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        dd += __popc(d[k] ^ static_cast<unsigned>(drp[8 * j + k]));
      if (dd < best) {
        best = dd;
        bidx = j;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, o);
    const int oi = __shfl_xor_sync(FULL, bidx, o);
    if (ob < best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
    }
  }

  const bool ok = bidx >= 0 && best <= max_hamming && lvalid;
  const int eff = ok ? bidx : 0;
  const float rx = mrp[4 * eff], ry = mrp[4 * eff + 1];

  // SAD rectification.
  const int half = patch / 2;
  const int sw = patch + 2 * sad_range;     // strip width
  const int xl = clampi(static_cast<int>(rintf(lx)), 0, W - 1);
  const int yl = clampi(static_cast<int>(rintf(ly)), 0, H - 1);
  const int xr = clampi(static_cast<int>(rintf(rx)), 0, W - 1);
  const int yr = clampi(static_cast<int>(rintf(ry)), 0, H - 1);
  const float* imgl = il + static_cast<long long>(p) * H * W;
  const float* imgr = ir + static_cast<long long>(p) * H * W;
  int* sl = s_l[warp];
  int* sr = s_r[warp];
  for (int i = lane; i < patch * patch; i += 32) {
    const int gy = clampi(yl - half + i / patch, 0, H - 1);
    const int gx = clampi(xl - half + i % patch, 0, W - 1);
    sl[i] = static_cast<int>(imgl[static_cast<long long>(gy) * W + gx]);
  }
  for (int i = lane; i < patch * sw; i += 32) {
    const int gy = clampi(yr - half + i / sw, 0, H - 1);
    const int gx = clampi(xr - sw / 2 + i % sw, 0, W - 1);
    sr[i] = static_cast<int>(imgr[static_cast<long long>(gy) * W + gx]);
  }
  __syncwarp();

  int best_sad = 0, best_s = 0;
  for (int s = 0; s <= 2 * sad_range; ++s) {
    int acc = 0;
    for (int i = lane; i < patch * patch; i += 32) {
      const int r = i / patch, c = i % patch;
      acc += abs(sl[i] - sr[r * sw + c + s]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    if (s == 0 || acc < best_sad) {
      best_sad = acc;
      best_s = s;
    }
  }

  if (lane == 0) {
    dist_out[q] = best;
    idx_out[q] = bidx;
    rxy_out[2 * q] = rx;
    rxy_out[2 * q + 1] = ry;
    sad_out[q] = best_s;
  }
}

}  // namespace

extern "C" int match_rectify_fused(const int* dl, const float* ml,
                                   const int* dr, const float* mr,
                                   const float* il, const float* ir,
                                   int* dist, int* idx, float* rxy, int* sad,
                                   int P, int K, int M, int H, int W,
                                   float row_band, float max_disp,
                                   int max_hamming, int patch, int sad_range,
                                   cudaStream_t stream) {
  if (patch > MAXP || sad_range > MAXR) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(P) * K;
  const dim3 grid(static_cast<unsigned>((n + WARPS - 1) / WARPS));
  match_kernel<<<grid, WARPS * 32, 0, stream>>>(
      dl, ml, dr, mr, il, ir, dist, idx, rxy, sad, P, K, M, H, W, row_band,
      max_disp, max_hamming, patch, sad_range);
  return static_cast<int>(cudaGetLastError());
}
