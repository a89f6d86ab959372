// Device code shared by the Feature Matcher kernels: the fused matcher
// (matcher_fused.cu), the match-only kernel (match_fused.cu), the
// SAD-only kernel (sad_fused.cu) and the unfused schedule's single-pair
// Hamming matcher (hamming_match.cu) and SAD sweep (sad_search.cu).
// Each kernel gives one warp to one left feature (or one caller-given
// center pair, or one gathered window row); the helpers below are what
// that warp runs.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace matcher {

constexpr int BIG = 1 << 20;              // distance of a masked-out pair
constexpr int MAXP = 15;                  // largest window the kernels hold
constexpr int MAXR = 15;                  // largest sweep half-range
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Masked Hamming argmin of one left feature (descriptor ``d``, meta row
// lx, ly, level; the caller has checked that it is valid) over the M
// right features of its pair.  Lanes stride over the right features in
// index order, each keeping a strict-< running minimum; a shuffle
// reduction on (distance, index) then keeps the lowest index among
// equal distances, the reference's first-occurrence argmin.  The mask
// is the reference's: dx = xl - xr and dy = |yl - yr| in float32,
// 0 <= dx <= max_disp, dy <= row_band, same level, right valid.  Every
// lane returns (best, index); (BIG, -1) when no candidate survives.
__device__ __forceinline__ void warp_hamming_argmin(
    const unsigned (&d)[8], float lx, float ly, float llv,
    const int* __restrict__ drp, const float* __restrict__ mrp, int M,
    float row_band, float max_disp, int lane, int& best_out, int& idx_out) {
  int best = BIG, bidx = -1;
  for (int j = lane; j < M; j += 32) {
    const float* m = mrp + 4 * j;
    const float dx = __fsub_rn(lx, m[0]);
    const float dy = fabsf(__fsub_rn(ly, m[1]));
    if (!(dy <= row_band && dx >= 0.f && dx <= max_disp && llv == m[2] &&
          m[3] > 0.5f))
      continue;                           // BIG: never improves the min
    int dd = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dd += __popc(d[k] ^ static_cast<unsigned>(drp[8 * j + k]));
    if (dd < best) {
      best = dd;
      bidx = j;
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
  best_out = best;
  idx_out = bidx;
}

// Read the (patch, patch) left window around (lx, ly) and the
// (patch, patch + 2 * sad_range) right strip around (rx, ry) into the
// warp's shared buffers, as int32.  Centers round half to even (rintf,
// not roundf) and clamp into the H x W image; every pixel read clamps
// too, which is the reference's edge padding.  Pixels truncate to int32
// as the reference's astype: float pixels, or uint8_t ones (the uint8
// datapath's level-0 images), whose int32 values are the same on an
// integer-valued frame, so the SAD table is too.
template <typename P>
__device__ __forceinline__ void load_windows(
    const P* __restrict__ imgl, const P* __restrict__ imgr, int H, int W,
    float lx, float ly, float rx, float ry, int patch, int sad_range,
    int lane, int* sl, int* sr) {
  const int half = patch / 2;
  const int sw = patch + 2 * sad_range;   // strip width
  const int xl = clampi(static_cast<int>(rintf(lx)), 0, W - 1);
  const int yl = clampi(static_cast<int>(rintf(ly)), 0, H - 1);
  const int xr = clampi(static_cast<int>(rintf(rx)), 0, W - 1);
  const int yr = clampi(static_cast<int>(rintf(ry)), 0, H - 1);
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
}

// The int32 SAD of the window against the strip at shift s, reduced
// over the warp (every lane returns the sum; integer, so exact in any
// order).
__device__ __forceinline__ int warp_sad(const int* sl, const int* sr,
                                        int patch, int sad_range, int s,
                                        int lane) {
  const int sw = patch + 2 * sad_range;
  int acc = 0;
  for (int i = lane; i < patch * patch; i += 32) {
    const int r = i / patch, c = i % patch;
    acc += abs(sl[i] - sr[r * sw + c + s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

}  // namespace matcher
