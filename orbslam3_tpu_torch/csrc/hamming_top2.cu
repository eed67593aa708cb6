// Kernel B1: Hamming distance + top-2 with the projection-search window.
//
// Replaces the Pallas TPU kernel `_kernel` of orbslam3_tpu/ops/pallas_match.py
// (:56, launched by `_top2_call` at pallas_match.py:155). For every query row
// q it returns, over the key rows k:
//   d1[q]  the best distance, d2[q] the second best (equal to d1 when the best
//          is tied), j1[q] the index of the best, the lowest index on ties;
// where the distance of key k is popc(a_q ^ b_k) over 256 bits, or exactly
// 1e9 when key k is invalid or (windowed) outside the query's window:
//   |u_q - u_k| <= r_q, |v_q - v_k| <= r_q (float32), lo_q <= octave_k <= hi_q.
// These are the float32 values of the reference's XLA path
// (matching._mask_matrix + window_mask + best_two): the same on every row,
// whatever the inputs (NaN or infinite positions, radius 0, M = 1, ties).
// The N x M matrix is never stored. Ratio test, max distance and query
// validity are applied by the caller, as in the reference. Any M >= 1 is
// taken: the keys are folded in tiles of 1024 in index order (5).
//
// What bounds it on the H100 (3.35 TB/s; `__popc` at 132 SMs x 16/clk x
// 1.98 GHz = 4.2 T/s), at the main path's calls (inputs read once, outputs
// written once):
//   call                                  bytes    byte floor  op floor
//   local map, windowed 16384 x 1024      1.09 MB  0.33 us     8 popc per
//   motion model, windowed 1024 x 1024    0.11 MB  0.03 us       in-window
//   fuse into a neighbour, windowed 1024² 0.11 MB  0.03 us       valid pair
//   fuse into the keyframe, 4096 x 1000   0.31 MB  0.09 us       (a few per query)
//   cross-check, unwindowed 1024 x 1024   0.08 MB  0.02 us     8.4 M popc, 2.0 us
// A windowed call's window holds a few keys of ~1000, so its floor is the
// launch itself (about 1 us through a CUDA graph on this card); the
// cross-check is bound by popcounts.
//
// Design, against that bound:
// (1) Visit only the keys a window can hold. Each block stages the window
//     data of a tile of up to 1024 keys (u, v, octave, validity: 13 bytes a key,
//     not the 32 descriptor bytes) in shared memory and lists the valid keys
//     by cell of a 32 x 32 grid over the extent of the valid keys with
//     finite positions (a counting sort: shared-memory atomics, then a block
//     scan). A query walks the cells its box [u - r, u + r] x [v - r, v + r]
//     overlaps (one contiguous slot range per cell row) and applies the
//     exact float32 window and octave tests to those keys only; a key that
//     passes reads its 32 descriptor bytes from L2, and that load overlaps
//     the rest of the walk. The box's edges are rounded outwards (directed
//     rounding) from a radius widened by 2^-22 r and mapped to cells by the
//     same monotone float32 function as the keys' (a key that passes
//     |u_q - u_k| <= r_q in float32 lies within r_q (1 + 2^-23) of u_q in
//     exact arithmetic), so every key that passes lies in a visited cell,
//     whatever the values. Keys with a non-finite coordinate sit in one
//     extra bucket that every query visits (it is empty on the main path). A
//     query with a NaN position or radius, or a negative radius, passes no
//     key (the plain mask is False there).
// (2) Short dependency chains. The staging issues all its loads at once and
//     the block's first queries are loaded while it stages; a windowed query
//     takes 16 lanes, so a warp runs two queries at a time and merges each
//     over four shuffle rounds (8 lanes and four queries above 2048 queries).
//     Blocks of 4 warps: a 1024-query call runs 128 blocks, larger calls up
//     to 4 per SM with the queries strided over them. What is left of a
//     windowed launch is latency: the staging's global round trip, its
//     barriers and atomics, and the query's own.
// (3) Unwindowed (the cross-check), each block stages all descriptors in
//     index order, [word][key] with a 4-word pad per word row so that the
//     coalesced stores and the warp's reads of consecutive keys are free of
//     bank conflicts, and a warp's 32 lanes walk every key of a query.
// (4) Ties. Keys are visited in no fixed order, so the fold breaks ties on
//     the index explicitly: (d < d1 || d == d1 && j < j1) replaces the best,
//     anything else lowers d2; the lanes merge the same way. The result (the
//     minimum, its lowest index, the second of the multiset) does not depend
//     on the order. Keys that are not visited read 1e9: with none visited,
//     d1 = 1e9 and j1 = 0 (the lowest index), d2 = 1e9 when M >= 2 and +inf
//     when M == 1 (as best_two gives); with one visited, d2 = 1e9 when M >= 2.
// (5) More than 1024 keys (nFeatures 1200 or 2000 in ORB-SLAM3's own EuRoC
//     and KITTI settings), as the TPU kernel folds over key tiles on its
//     grid's second axis: the block stages the keys 1024 at a time, in index
//     order, and each query's (d1, d2, j1) carries across the tiles in
//     registers, keys indexed by the tile's base plus the slot. The
//     block's queries then advance in rounds that every warp runs, since
//     each tile's staging is a block barrier. Up to 1024 keys the kernel is
//     the single-tile instance, which stages once before its query loop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kMaxKeys = 1024;  // keys staged at once: one tile
constexpr int kWarps = 4;       // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSM = 4;
constexpr int kKeysPerThread = kMaxKeys / kThreads;
constexpr int kGrid = 32;                // cells per side of the window grid
constexpr int kCells = kGrid * kGrid;    // bucket kCells: non-finite keys
constexpr int kBuckets = kCells + 1;
constexpr int kPad = kMaxKeys + 4;       // word-row stride of staged descriptors
constexpr float kMasked = 1e9f;          // the reference's masked distance

// Windowed staging: the keys' window data in index order, and the valid
// keys' indices in cell order.
struct WindowKeys {
  float u[kMaxKeys];
  float v[kMaxKeys];
  int oct[kMaxKeys];
  uint8_t ok[kMaxKeys];     // valid
  uint16_t idx[kMaxKeys];   // key index of each slot
  int start[kBuckets + 1];  // first slot of each bucket; start[kBuckets] = staged keys
};

// Unwindowed staging: every descriptor, in index order.
struct AllKeys {
  uint32_t desc[8 * kPad];  // word w of key k at desc[w * kPad + k]
  uint8_t valid[kMaxKeys];
};

struct Top2 {
  float d1, d2;
  int j1;
};

__device__ __forceinline__ bool beats(float d, int j, float d1, int j1) {
  return d < d1 || (d == d1 && j < j1);
}

__device__ __forceinline__ void fold(Top2& t, float d, int j) {
  if (beats(d, j, t.d1, t.j1)) {
    t.d2 = t.d1;
    t.d1 = d;
    t.j1 = j;
  } else {
    t.d2 = fminf(t.d2, d);
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool b_wins = beats(b.d1, b.j1, a.d1, a.j1);
  const Top2& w = b_wins ? b : a;
  const Top2& l = b_wins ? a : b;
  return {w.d1, fminf(w.d2, l.d1), w.j1};
}

// cell(x) = floor((x - lo) * scale) in float32: monotone in x (rounding is),
// for keys and box edges alike.
struct Axis {
  float lo, scale, min, max;  // min/max: extent of the finite staged keys
};

__device__ __forceinline__ float cell_of(float x, const Axis& a) {
  return floorf((x - a.lo) * a.scale);
}

__device__ __forceinline__ int key_cell(float x, const Axis& a) {
  return (int)fminf(fmaxf(cell_of(x, a), 0.f), kGrid - 1.f);
}

// First and last cell a box edge can reach; NaN widens to the whole axis.
__device__ __forceinline__ int first_cell(float x, const Axis& a) {
  const float t = cell_of(x, a);
  return t > 0.f ? (int)fminf(t, kGrid - 1.f) : 0;
}

__device__ __forceinline__ int last_cell(float x, const Axis& a) {
  const float t = cell_of(x, a);
  return t < kGrid - 1.f ? (int)fmaxf(t, 0.f) : kGrid - 1;
}

__device__ __forceinline__ Axis make_axis(float mn, float mx) {
  if (!(mx >= mn)) return {0.f, 0.f, INFINITY, -INFINITY};  // no finite key
  const float scale = kGrid / (mx - mn);  // inf when the extent is 0 or too small
  return {mn, isfinite(scale) ? scale : 0.f, mn, mx};
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Exclusive scan of s[0..n) in place (n <= kThreads * per); returns the total.
template <int per>
__device__ int block_exclusive_scan(int* s, int n, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = threadIdx.x * per;
  int vals[per];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    vals[i] = base + i < n ? s[base + i] : 0;
    sum += vals[i];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  int run = before + incl - sum;
#pragma unroll
  for (int i = 0; i < per; ++i) {
    if (base + i < n) s[base + i] = run;
    run += vals[i];
  }
  return total;
}

// Stage the keys' window data and list the valid keys by cell (windowed
// calls): a counting sort, shared-memory atomics then a block scan.
__device__ void stage_window_keys(WindowKeys& s, const uint8_t* __restrict__ valid_b,
                                  const float* __restrict__ uvk, const int* __restrict__ octk,
                                  int M, Axis& ax, Axis& ay) {
  __shared__ float s_ext[4][kWarps];
  __shared__ int s_tot[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float ku[kKeysPerThread], kv[kKeysPerThread];
  int ko[kKeysPerThread];
  bool ok[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {  // coalesced, every load issued at once
    const int k = min((int)threadIdx.x + i * kThreads, M - 1);
    ok[i] = valid_b == nullptr || valid_b[k] != 0;
    ku[i] = uvk[2 * k];
    kv[i] = uvk[2 * k + 1];
    ko[i] = octk[k];
  }
  for (int c = threadIdx.x; c <= kBuckets; c += kThreads) s.start[c] = 0;
  float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = (int)threadIdx.x + i * kThreads;
    ok[i] = ok[i] && k < M;
    if (k < M) {
      s.u[k] = ku[i];
      s.v[k] = kv[i];
      s.oct[k] = ko[i];
      s.ok[k] = ok[i];
    }
    if (ok[i] && isfinite(ku[i]) && isfinite(kv[i])) {
      umin = fminf(umin, ku[i]);
      umax = fmaxf(umax, ku[i]);
      vmin = fminf(vmin, kv[i]);
      vmax = fmaxf(vmax, kv[i]);
    }
  }
  umin = warp_min(umin);
  vmin = warp_min(vmin);
  umax = -warp_min(-umax);
  vmax = -warp_min(-vmax);
  if (lane == 0) {
    s_ext[0][warp] = umin;
    s_ext[1][warp] = umax;
    s_ext[2][warp] = vmin;
    s_ext[3][warp] = vmax;
  }
  __syncthreads();
  umin = s_ext[0][0], umax = s_ext[1][0], vmin = s_ext[2][0], vmax = s_ext[3][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    umin = fminf(umin, s_ext[0][w]);
    umax = fmaxf(umax, s_ext[1][w]);
    vmin = fminf(vmin, s_ext[2][w]);
    vmax = fmaxf(vmax, s_ext[3][w]);
  }
  ax = make_axis(umin, umax);
  ay = make_axis(vmin, vmax);

  // Count per bucket (the atomic's old value is the key's rank in its
  // bucket), scan, scatter. Keys next to each other in index order tend to
  // share a cell, and a warp's atomics on one address serialise, so here a
  // thread takes keys 37 apart (37 is odd: a bijection of the block's 128
  // keys that also keeps the warp's reads of u and v in distinct banks).
  int key[kKeysPerThread], bucket[kKeysPerThread], rank[kKeysPerThread];
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i) {
    const int k = i * kThreads + (((int)threadIdx.x * 37) & (kThreads - 1));
    key[i] = k;
    bucket[i] = -1;
    if (k < M && s.ok[k]) {
      const float u = s.u[k], v = s.v[k];
      bucket[i] = isfinite(u) && isfinite(v) ? key_cell(v, ay) * kGrid + key_cell(u, ax) : kCells;
      rank[i] = atomicAdd(&s.start[bucket[i]], 1);
    }
  }
  __syncthreads();
  const int total =
      block_exclusive_scan<(kBuckets + kThreads - 1) / kThreads>(s.start, kBuckets, s_tot);
  if (threadIdx.x == 0) s.start[kBuckets] = total;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kKeysPerThread; ++i)
    if (bucket[i] >= 0) s.idx[s.start[bucket[i]] + rank[i]] = (uint16_t)key[i];
  __syncthreads();
}

// Every descriptor and validity flag, in index order (unwindowed calls).
__device__ void stage_all_keys(AllKeys& s, const uint32_t* __restrict__ b,
                               const uint8_t* __restrict__ valid_b, int M) {
  if ((reinterpret_cast<uintptr_t>(b) & 15) == 0) {
    for (int i = threadIdx.x; i < 2 * M; i += kThreads) {  // half a row per thread
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(b) + i);
      uint32_t* d = s.desc + 4 * (i & 1) * kPad + (i >> 1);
      d[0] = x.x;
      d[kPad] = x.y;
      d[2 * kPad] = x.z;
      d[3 * kPad] = x.w;
    }
  } else {
    for (int i = threadIdx.x; i < 8 * M; i += kThreads) s.desc[(i & 7) * kPad + (i >> 3)] = b[i];
  }
  for (int k = threadIdx.x; k < M; k += kThreads) s.valid[k] = valid_b ? valid_b[k] : (uint8_t)1;
  __syncthreads();
}

__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, bool aligned16,
                                         uint32_t (&w)[8]) {
  if (aligned16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
    w[4] = y.x, w[5] = y.y, w[6] = y.z, w[7] = y.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ int hamming(const uint32_t (&a)[8], const uint32_t (&b)[8]) {
  int h = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) h += __popc(a[w] ^ b[w]);
  return h;
}

struct Query {
  uint32_t a[8];
  float u, v, r;
  int lo, hi;
};

// kLanes lanes take one query: 32 unwindowed; windowed 16, or 8 for large
// query counts, where more queries in flight per warp pay more than lanes.
// kTiled: M > kMaxKeys, folded over key tiles (design note 5).
template <bool kWindowed, int kLanes, bool kTiled>
__global__ void __launch_bounds__(kThreads)
hamming_top2_kernel(const uint32_t* __restrict__ a,      // (N, 8)
                    const uint32_t* __restrict__ b,      // (M, 8)
                    const uint8_t* __restrict__ valid_b, // (M,) or null
                    const float* __restrict__ uvq,       // (N, 2)
                    const float* __restrict__ uvk,       // (M, 2)
                    const float* __restrict__ rad,       // (N,) at rad_stride (0 or 1)
                    int rad_stride,
                    const int* __restrict__ octk,        // (M,)
                    const int* __restrict__ lo,          // (N,)
                    const int* __restrict__ hi,          // (N,)
                    int N, int M,
                    float* __restrict__ d1_out, float* __restrict__ d2_out,
                    int* __restrict__ j1_out) {
  constexpr int kGroups = 32 / kLanes;  // queries a warp runs at once
  __shared__ __align__(16) std::conditional_t<kWindowed, WindowKeys, AllKeys> s;
  const int lane = threadIdx.x & 31;
  const int sub = lane % kLanes;
  const bool aligned16 = ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const int stride = gridDim.x * kWarps * kGroups;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroups + lane / kLanes;

  auto load_query = [&](int q, Query& x) {
    q = min(q, N - 1);  // a warp's idle groups compute a real row and store nothing
    load_row(a + (size_t)q * 8, aligned16, x.a);
    if constexpr (kWindowed) {
      x.u = uvq[2 * q];
      x.v = uvq[2 * q + 1];
      x.r = rad[(size_t)q * rad_stride];
      x.lo = lo[q];
      x.hi = hi[q];
    }
  };

  Query x;
  load_query(first, x);  // in flight while the block stages the keys
  Axis ax, ay;
  // Stage the keys base .. base + tile_keys(base) - 1.
  auto tile_keys = [&](int base) { return kTiled ? min(M - base, kMaxKeys) : M; };
  auto stage = [&](int base) {
    const uint8_t* vb = valid_b ? valid_b + base : nullptr;
    if constexpr (kWindowed)
      stage_window_keys(s, vb, uvk + 2 * (size_t)base, octk + base, tile_keys(base), ax, ay);
    else
      stage_all_keys(s, b + 8 * (size_t)base, vb, tile_keys(base));
  };
  if constexpr (!kTiled) {
    stage(0);
    if (first - lane / kLanes >= N) return;  // warp-uniform: no query for this warp
  }
  // The block's first query: tiled, every warp runs each round (barriers).
  const int round0 = first - ((threadIdx.x >> 5) * kGroups + lane / kLanes);

  for (int q = first; kTiled ? q - first + round0 < N : q - lane / kLanes < N; q += stride) {
    Query next;
    load_query(q + stride, next);  // the next query's loads overlap this one
    Top2 t = {INFINITY, INFINITY, 0x7fffffff};
    for (int base = 0; base < (kTiled ? M : 1); base += kMaxKeys) {
      if constexpr (kTiled) {
        __syncthreads();  // every warp is done with the previous tile
        stage(base);
      }
      if constexpr (!kWindowed) {
        // Every key folds, an invalid one at the masked distance, as in the
        // plain version: no branch, so the loads of unrolled steps overlap.
        const int mt = tile_keys(base);
#pragma unroll 4
        for (int k = sub; k < mt; k += kLanes) {
          uint32_t w[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) w[i] = s.desc[i * kPad + k];
          fold(t, s.valid[k] ? (float)hamming(x.a, w) : kMasked, base + k);
        }
      } else {
        // A key that passes starts the load of its descriptor and is folded
        // at the next pass or after the walk, so the load overlaps the walk.
        int pend_k = -1;
        uint32_t pend[8];
        auto visit = [&](int s0, int s1) {
          for (int i = s0 + sub; i < s1; i += kLanes) {
            const int k = s.idx[i];
            if (!(fabsf(x.u - s.u[k]) <= x.r && fabsf(x.v - s.v[k]) <= x.r &&
                  s.oct[k] >= x.lo && s.oct[k] <= x.hi))
              continue;
            if (pend_k >= 0) fold(t, (float)hamming(x.a, pend), pend_k);
            pend_k = base + k;
            load_row(b + (size_t)pend_k * 8, aligned16, pend);
          }
        };
        if (!(isnan(x.u) || isnan(x.v) || isnan(x.r) || x.r < 0.f)) {
          const float rr = __fmul_ru(x.r, 1.f + 0x1p-22f);
          const float u0 = __fadd_rd(x.u, -rr), u1 = __fadd_ru(x.u, rr);
          const float v0 = __fadd_rd(x.v, -rr), v1 = __fadd_ru(x.v, rr);
          // NaN edges (inf - inf) fail these tests and keep the grid.
          if (!(u1 < ax.min || u0 > ax.max || v1 < ay.min || v0 > ay.max)) {
            const int cx0 = first_cell(u0, ax), cx1 = last_cell(u1, ax);
            const int cy1 = last_cell(v1, ay);
            for (int cy = first_cell(v0, ay); cy <= cy1; ++cy)
              visit(s.start[cy * kGrid + cx0], s.start[cy * kGrid + cx1 + 1]);
          }
          visit(s.start[kCells], s.start[kBuckets]);
        }
        if (pend_k >= 0) fold(t, (float)hamming(x.a, pend), pend_k);
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      Top2 o;
      o.d1 = __shfl_xor_sync(0xffffffffu, t.d1, off);
      o.d2 = __shfl_xor_sync(0xffffffffu, t.d2, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
      t = merge(t, o);
    }
    if (sub == 0 && q < N) {
      if (t.d1 == INFINITY) {  // no key visited: every key reads 1e9
        t.d1 = kMasked;
        t.j1 = 0;
        t.d2 = M >= 2 ? kMasked : INFINITY;
      } else if (t.d2 == INFINITY && M >= 2) {  // one key visited
        t.d2 = kMasked;
      }
      d1_out[q] = t.d1;
      d2_out[q] = t.d2;
      j1_out[q] = t.j1;
    }
    x = next;
  }
}

// The card's SM count, read once per process (one card).
int sm_count(cudaError_t& err) {
  static int sms = 0;
  static cudaError_t st = [] {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return e;
  }();
  err = st;
  return sms;
}

}  // namespace

// a (N, 32) u8 and b (M, 32) u8 descriptors, 4-aligned (read as 8 u32 words a
// row); valid_b (M,) bool or null; windowed != 0 reads uvq (N, 2) f32, uvk
// (M, 2) f32, rad f32 at rad[q * rad_stride] (rad_stride 0: one radius for all
// queries), octk (M,) i32, lo (N,) i32, hi (N,) i32. Outputs d1, d2 (N,) f32
// and j1 (N,) i32. All device pointers, contiguous. M >= 1.
extern "C" int hamming_top2_launch(const uint32_t* a, const uint32_t* b,
                                   const uint8_t* valid_b, const float* uvq,
                                   const float* uvk, const float* rad, int rad_stride,
                                   const int* octk, const int* lo, const int* hi,
                                   int windowed, int N, int M, float* d1,
                                   float* d2, int* j1, cudaStream_t stream) {
  if (M < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  cudaError_t err;
  const int sms = sm_count(err);
  if (err != cudaSuccess) return (int)err;
  const int lanes = !windowed ? 32 : N > 2048 ? 8 : 16;
  const int per_block = kWarps * (32 / lanes);
  const int blocks = std::min((N + per_block - 1) / per_block, kBlocksPerSM * sms);
  auto kernel = M <= kMaxKeys
      ? (!windowed    ? hamming_top2_kernel<false, 32, false>
         : lanes == 8 ? hamming_top2_kernel<true, 8, false>
                      : hamming_top2_kernel<true, 16, false>)
      : (!windowed    ? hamming_top2_kernel<false, 32, true>
         : lanes == 8 ? hamming_top2_kernel<true, 8, true>
                      : hamming_top2_kernel<true, 16, true>);
  kernel<<<blocks, kThreads, 0, stream>>>(a, b, valid_b, uvq, uvk, rad, rad_stride, octk, lo, hi,
                                          N, M, d1, d2, j1);
  return (int)cudaGetLastError();
}
