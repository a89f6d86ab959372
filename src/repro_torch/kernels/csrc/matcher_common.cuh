// Device code shared by the Feature Matcher kernels: the fused matcher
// (matcher_fused.cu, K3), the match-only kernel (match_fused.cu, K4), the
// SAD-only kernel (sad_fused.cu, K5) and the unfused schedule's
// single-pair Hamming matcher (hamming_match.cu, K9) and SAD sweep
// (sad_search.cu, K10).
//
// The search (K3, K4, K9): a block owns one batch row (a stereo pair)
// and a tile of left features, one warp each.  It stages the row's right
// features' meta rows into shared memory once, CHUNK at a time (16 B
// each, vector loads when the tensors are 16-byte aligned), so every
// warp's walk reads one float4 of shared memory a candidate; inside the
// search region only it reads the candidate's descriptor (two uint4).
// K4 stages the descriptors too (32 B each): it also serves the temporal
// window, 48 rows each way, where many candidates pass.  K3 and K9 match
// stereo pairs (a 2-row band, a few candidates a left feature) and read
// them from L2 on demand, which measured faster there (PERF.md).  Lanes
// stride over the right features in index order, across chunks too
// (CHUNK is a multiple of 32), each keeping a strict-< running minimum,
// and a shuffle reduction on (distance, index) keeps the lowest index
// among equal distances: the reference's first-occurrence argmin,
// whatever the chunking.
//
// The SAD sweep (K3, K5, K10): lane r holds row r of the (P, P) left
// window and of the (P, P + 2R) right strip in registers (read row by
// row, lane = column, through a small shared buffer in K5 and K10; each
// lane its own row in K3, which measured faster there) and sums
// |L[r][c] - R[r][c + s]| for every shift s at once; one transposing
// reduction over the rows (15 shuffles for up to 16 shifts) leaves the
// SAD of shift s in lane s.  The sums are int32, so any order is exact.
// sweep_rows is a template over the largest window and range it holds:
// <11, 5> is the paper's configuration, its guards fold away and its
// loops unroll; <MAXP, MAXR> serves every other size.
#pragma once

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace matcher {

constexpr int BIG = 1 << 20;              // distance of a masked-out pair
constexpr int MAXP = 15;                  // largest window the kernels hold
constexpr int MAXR = 15;                  // largest sweep half-range
constexpr unsigned FULL = 0xffffffffu;
// Right features staged at a time: 1024 x (16 B of meta row + 32 B of
// descriptor) = 48 KB, the most a block takes without opting in to more.
// A multiple of 32, so a lane's right features stay in index order across
// chunks.
constexpr int CHUNK = 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Dynamic shared memory of a search block for M right features.
template <bool kStageDesc>
inline int search_smem_bytes(int M) {
  return (M < CHUNK ? M : CHUNK) * (kStageDesc ? 16 + 32 : 16);
}

// Are the meta rows and descriptors 16-byte aligned (vector staging)?
inline int rows_aligned(const void* meta, const void* desc) {
  return ((reinterpret_cast<uintptr_t>(meta) |
           reinterpret_cast<uintptr_t>(desc)) & 15u) == 0;
}

// Copy right features base .. base + n - 1 (n <= CHUNK) of one batch row
// into shared memory: meta row i to s_meta[i] and, with kStageDesc,
// descriptor i to s_desc[2 i], s_desc[2 i + 1].  Every thread of the
// NT-thread block takes part; each issues all its loads before its
// stores.
template <int NT, bool kStageDesc>
__device__ __forceinline__ void stage_rows(const float* __restrict__ mr,
                                           const int* __restrict__ dr,
                                           int base, int n, bool vec,
                                           float4* s_meta, uint4* s_desc) {
  if (vec) {
    constexpr int PER = CHUNK / NT;
    const float4* m4 = reinterpret_cast<const float4*>(mr) + base;
    const uint4* d4 = reinterpret_cast<const uint4*>(dr) + 2 * base;
    float4 m[PER];
    uint4 a[PER], b[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < n) {
        m[k] = __ldg(m4 + i);
        if constexpr (kStageDesc) {
          a[k] = __ldg(d4 + 2 * i);
          b[k] = __ldg(d4 + 2 * i + 1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int i = threadIdx.x + k * NT;
      if (i < n) {
        s_meta[i] = m[k];
        if constexpr (kStageDesc) {
          s_desc[2 * i] = a[k];
          s_desc[2 * i + 1] = b[k];
        }
      }
    }
  } else {
    float* sm = reinterpret_cast<float*>(s_meta);
    int* sd = reinterpret_cast<int*>(s_desc);
    for (int i = threadIdx.x; i < 4 * n; i += NT) sm[i] = mr[4 * base + i];
    if constexpr (kStageDesc)
      for (int i = threadIdx.x; i < 8 * n; i += NT) sd[i] = dr[8 * base + i];
  }
}

// One warp's walk over a staged chunk (global indices base .. base + n
// - 1): the reference's mask in float32 (dx = xl - xr and dy = |yl - yr|,
// 0 <= dx <= max_disp, dy <= row_band, same level, right valid), then the
// Hamming distance of the candidates inside it, into the lane's strict-<
// running minimum.  The candidate's descriptor: the staged one
// (kStaged: ``s_desc``), or row base + j of ``dr`` in global memory, read
// through the read-only cache (two 16-byte loads when ``vec``).
template <bool kStaged>
__device__ __forceinline__ void walk_chunk(
    const unsigned (&d)[8], float lx, float ly, float llv,
    const float4* s_meta, const uint4* s_desc, const int* __restrict__ dr,
    bool vec, int base, int n, float row_band, float max_disp, int lane,
    int& best, int& bidx) {
#pragma unroll 4
  for (int j = lane; j < n; j += 32) {
    const float4 m = s_meta[j];
    const float dx = __fsub_rn(lx, m.x);
    const float dy = fabsf(__fsub_rn(ly, m.y));
    if (!(dy <= row_band && dx >= 0.f && dx <= max_disp && llv == m.z &&
          m.w > 0.5f))
      continue;                           // BIG: never improves the min
    uint4 a, b;
    if constexpr (kStaged) {
      a = s_desc[2 * j];
      b = s_desc[2 * j + 1];
    } else if (vec) {
      const uint4* g = reinterpret_cast<const uint4*>(dr) + 2 * (base + j);
      a = __ldg(g);
      b = __ldg(g + 1);
    } else {
      const unsigned* g = reinterpret_cast<const unsigned*>(dr) +
                          8 * (base + j);
      a = make_uint4(__ldg(g), __ldg(g + 1), __ldg(g + 2), __ldg(g + 3));
      b = make_uint4(__ldg(g + 4), __ldg(g + 5), __ldg(g + 6), __ldg(g + 7));
    }
    const int dd = __popc(d[0] ^ a.x) + __popc(d[1] ^ a.y) +
                   __popc(d[2] ^ a.z) + __popc(d[3] ^ a.w) +
                   __popc(d[4] ^ b.x) + __popc(d[5] ^ b.y) +
                   __popc(d[6] ^ b.z) + __popc(d[7] ^ b.w);
    if (dd < best) {
      best = dd;
      bidx = base + j;
    }
  }
}

// Masked Hamming argmin of every warp's left feature (descriptor ``d``,
// meta lx, ly, level) over the M right features of the block's batch row
// (``mr``: M meta rows, ``dr``: M descriptors), staged in ``smem``
// (search_smem_bytes(M)).  Every thread of the block calls it (it stages
// and waits at barriers); ``search`` says
// whether this warp has a valid left feature to search (uniform over the
// warp).  Every lane returns (best, index), (BIG, -1) when no candidate
// survives or the warp does not search.
template <int NT, bool kStageDesc>
__device__ __forceinline__ void block_argmin(
    bool search, const unsigned (&d)[8], float lx, float ly, float llv,
    const float* __restrict__ mr, const int* __restrict__ dr, int M,
    bool vec, float row_band, float max_disp, void* smem, int lane,
    int& best_out, int& idx_out) {
  // smem: the meta rows (cap of them), then the descriptors.
  const int cap = M < CHUNK ? M : CHUNK;
  float4* s_meta = static_cast<float4*>(smem);
  uint4* s_desc = reinterpret_cast<uint4*>(s_meta + cap);
  int best = BIG, bidx = -1;
  for (int base = 0; base < M; base += CHUNK) {
    const int n = M - base < CHUNK ? M - base : CHUNK;
    if (base) __syncthreads();            // the last chunk's walks are done
    stage_rows<NT, kStageDesc>(mr, dr, base, n, vec, s_meta, s_desc);
    __syncthreads();
    if (search)
      walk_chunk<kStageDesc>(d, lx, ly, llv, s_meta, s_desc, dr, vec, base,
                             n, row_band, max_disp, lane, best, bidx);
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

// The (patch, patch) left window / (patch, patch + 2 R) right strip of an
// image around a float center: rounded half to even (rintf, not roundf)
// and clamped into the H x W image; every read clamps too, which is the
// reference's edge padding.  Pixels truncate to int32 as the reference's
// astype: float pixels, or uint8_t ones (the uint8 datapath's level-0
// images), whose int32 values are the same on an integer-valued frame.
template <typename Pix>
struct ImageRows {
  const Pix* __restrict__ img;
  int H, W, y0, x0;                       // top-left corner, may lie outside

  __device__ __forceinline__ ImageRows(const Pix* img_, int H_, int W_,
                                       float cx, float cy, int half_h,
                                       int half_w)
      : img(img_), H(H_), W(W_),
        y0(clampi(static_cast<int>(rintf(cy)), 0, H_ - 1) - half_h),
        x0(clampi(static_cast<int>(rintf(cx)), 0, W_ - 1) - half_w) {}

  __device__ __forceinline__ int operator()(int r, int c) const {
    const int gy = clampi(y0 + r, 0, H - 1);
    const int gx = clampi(x0 + c, 0, W - 1);
    return static_cast<int>(img[static_cast<long long>(gy) * W + gx]);
  }
};

// Rows of a caller-gathered float window (K10): pixel (r, c) at
// base[r * stride + c], truncated to int32.
struct GatheredRows {
  const float* __restrict__ base;
  int stride;

  __device__ __forceinline__ int operator()(int r, int c) const {
    return static_cast<int>(base[r * stride + c]);
  }
};

// The 2 RM + 1 shifts a <PM, RM> sweep holds, in groups of 16 (one a
// lane).
template <int RM>
struct Shifts {
  static constexpr int GROUPS = (2 * RM + 1 + 15) / 16;
};

// A coalesced sweep whose strip row and window row fit one warp-wide row
// together (PM + 2 RM + PM <= 32, as the paper's 21 + 11) reads them one
// load a row, lane = column, into the warp's shared buffer of PM rows
// (stride 33: lane r reading row r hits bank r + c, no two lanes alike),
// and lane r then takes row r from it.  Other sweeps read each lane's row
// straight from global memory.
constexpr int SAD_STRIDE = 33;
template <int PM, int RM, bool kCoalesced = true>
struct SweepBuffer {
  static constexpr bool PACKED = kCoalesced && PM + (PM + 2 * RM) <= 32;
  static constexpr int WORDS = PACKED ? PM * SAD_STRIDE : 1;
};

// The all-shift SAD sweep of a (p, p) window against a (p, p + 2 rng)
// strip, p <= PM and rng <= RM: lane r < p takes row r of both (``left``
// and ``right`` give the int32 pixel (r, c); ``buf`` is the warp's
// SweepBuffer<PM, RM, kCoalesced>, unused unless PACKED) and sums every
// shift's |L[r][c] - R[r][c + s]| in acc[s];
// then acc is summed over the rows by a transposing butterfly, after
// which lane l < 16 holds the SAD of shift 16 g + l in out[g].  Every
// lane of the warp takes part.
template <int PM, int RM, bool kCoalesced, typename Left, typename Right>
__device__ __forceinline__ void sweep_rows(
    const Left& left, const Right& right, int p, int rng, int lane,
    int* buf, int (&out)[Shifts<RM>::GROUPS]) {
  constexpr int G = Shifts<RM>::GROUPS;
  constexpr int SWM = PM + 2 * RM;
  const int sw = p + 2 * rng;
  int acc[16 * G];
#pragma unroll
  for (int s = 0; s < 16 * G; ++s) acc[s] = 0;
  int lrow[PM], rrow[SWM];
  if constexpr (SweepBuffer<PM, RM, kCoalesced>::PACKED) {
#pragma unroll
    for (int r = 0; r < PM; ++r) {        // lanes: strip, then window
      if (r >= p) continue;
      int v = 0;
      if (lane < sw)
        v = right(r, lane);
      else if (lane < sw + p)
        v = left(r, lane - sw);
      buf[r * SAD_STRIDE + lane] = v;
    }
    __syncwarp();
    if (lane < p) {
#pragma unroll
      for (int c = 0; c < PM; ++c)
        if (c < p) lrow[c] = buf[lane * SAD_STRIDE + sw + c];
#pragma unroll
      for (int c = 0; c < SWM; ++c)
        if (c < sw) rrow[c] = buf[lane * SAD_STRIDE + c];
    }
  } else if (lane < p) {
#pragma unroll
    for (int c = 0; c < PM; ++c)
      if (c < p) lrow[c] = left(lane, c);
#pragma unroll
    for (int c = 0; c < SWM; ++c)
      if (c < sw) rrow[c] = right(lane, c);
  }
  if (lane < p) {
#pragma unroll
    for (int s = 0; s < 2 * RM + 1; ++s) {
      if (s > 2 * rng) continue;
#pragma unroll
      for (int c = 0; c < PM; ++c)
        if (c < p) acc[s] += abs(lrow[c] - rrow[c + s]);
    }
  }
  // Transposing sum over lanes 0..15 (rows): at step o a lane keeps half
  // of its 2 o values (the upper half if bit o of its lane is set) and
  // adds the partner's copy of that half; lane l ends with value l & 15.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int o = 8 >> step;              // constants once unrolled, so
      const bool hi = (lane & o) != 0;      // acc stays in registers
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i >= o) continue;
        const int lo_v = acc[16 * g + i], hi_v = acc[16 * g + i + o];
        acc[16 * g + i] = (hi ? hi_v : lo_v) +
                          __shfl_xor_sync(FULL, hi ? lo_v : hi_v, o);
      }
    }
    out[g] = acc[16 * g];
  }
}

// First-occurrence argmin over the sweep's shifts 0 .. 2 rng (strict < in
// shift order, i.e. the lexicographic minimum of (SAD, shift)); every lane
// returns it.
template <int RM>
__device__ __forceinline__ int sweep_argmin(
    const int (&out)[Shifts<RM>::GROUPS], int rng, int lane) {
  int best = INT_MAX, shift = INT_MAX;
#pragma unroll
  for (int g = 0; g < Shifts<RM>::GROUPS; ++g) {
    const int s = 16 * g + (lane & 15);
    if (lane < 16 && s <= 2 * rng && out[g] < best) {
      best = out[g];
      shift = s;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ob = __shfl_xor_sync(FULL, best, o);
    const int os = __shfl_xor_sync(FULL, shift, o);
    if (ob < best || (ob == best && os < shift)) {
      best = ob;
      shift = os;
    }
  }
  return shift;
}

// Lanes l < 16 write the sweep's SADs to row[16 g + l], shifts 0 .. 2 rng.
template <int RM>
__device__ __forceinline__ void sweep_store(
    const int (&out)[Shifts<RM>::GROUPS], int rng, int lane,
    int* __restrict__ row) {
#pragma unroll
  for (int g = 0; g < Shifts<RM>::GROUPS; ++g) {
    const int s = 16 * g + lane;
    if (lane < 16 && s <= 2 * rng) row[s] = out[g];
  }
}

}  // namespace matcher
