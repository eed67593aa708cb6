// Hamming distance + top-2 reduction, with the projection-search window.
//
// Replaces the Pallas TPU kernel `_kernel` of orbslam3_tpu/ops/pallas_match.py
// (:56, launched by `_top2_call` at pallas_match.py:155). For every query row
// q it returns, over the key rows k:
//   d1[q]  the best distance, d2[q] the second best (equal to d1 when the best
//          is tied), j1[q] the index of the best, the lowest index on ties;
// where the distance of key k is popc(a_q ^ b_k) over 256 bits, or exactly
// 1e9 when key k is invalid or (windowed) outside the query's window:
//   |u_q - u_k| <= r_q, |v_q - v_k| <= r_q, lo_q <= octave_k <= hi_q.
// These are the float32 values of the reference's XLA path
// (matching._mask_matrix + window_mask + best_two). The N x M matrix is never
// stored. Ratio test, max distance and query validity are applied by the
// caller, as in the reference.
//
// What bounds it on the H100: the popcount rate of the integer units. The
// local-map search is 16384 x 1024 pairs x 8 words = about 134 M `__popc`
// (plus as many XORs and adds) per call before the window prunes any; on
// 132 SMs at 16 popc/clk/SM that is ~40 us unpruned. The distance is exact
// (no bit-matmul identity, no tensor cores). The design answers the bound by
// (1) testing the window first, so out-of-window keys skip their 8 popcounts
// (the window keeps a few keys of 1024 per query at EuRoC shapes), and
// (2) staging a tile of keys in shared memory once per block, transposed to
// [word][key] so a warp's 32 lanes read 32 consecutive words without bank
// conflicts, while each warp walks its queries over the tile.
//
// Order: each lane folds its keys in increasing index with a strict `<`
// (lowest index wins a tie), and the warp then merges the 32 partial
// (d1, j1, d2) triples with a tie-break on index — the same result as the
// sequential fold of the TPU kernel and as `lax.top_k`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileKeys = 512;   // keys staged in shared memory per tile
constexpr int kWarps = 8;        // warps per block
constexpr int kQueriesPerWarp = 4;
constexpr float kInf = 1e9f;     // the reference's masked distance

struct Top2 {
  float d1, d2;
  int j1;
};

__device__ __forceinline__ void fold(Top2& t, float d, int j) {
  if (d < t.d1) {
    t.d2 = t.d1;
    t.d1 = d;
    t.j1 = j;
  } else if (d < t.d2) {
    t.d2 = d;
  }
}

__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  const bool b_wins = (b.d1 < a.d1) || (b.d1 == a.d1 && b.j1 < a.j1);
  const Top2& w = b_wins ? b : a;
  const Top2& l = b_wins ? a : b;
  Top2 r;
  r.d1 = w.d1;
  r.j1 = w.j1;
  r.d2 = fminf(w.d2, l.d1);
  return r;
}

__global__ void __launch_bounds__(kWarps * 32)
hamming_top2_kernel(const uint32_t* __restrict__ a,      // (N, 8)
                    const uint32_t* __restrict__ b,      // (M, 8)
                    const uint8_t* __restrict__ valid_b, // (M,) or null
                    const float* __restrict__ uvq,       // (N, 2)
                    const float* __restrict__ uvk,       // (M, 2)
                    const float* __restrict__ rad,       // (N,)
                    const int* __restrict__ octk,        // (M,)
                    const int* __restrict__ lo,          // (N,)
                    const int* __restrict__ hi,          // (N,)
                    int windowed, int N, int M,
                    float* __restrict__ d1_out, float* __restrict__ d2_out,
                    int* __restrict__ j1_out) {
  __shared__ uint32_t s_words[8][kTileKeys];
  __shared__ float s_u[kTileKeys];
  __shared__ float s_v[kTileKeys];
  __shared__ int s_oct[kTileKeys];
  __shared__ uint8_t s_valid[kTileKeys];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = (blockIdx.x * kWarps + warp) * kQueriesPerWarp;

  uint32_t qa[kQueriesPerWarp][8];
  float qu[kQueriesPerWarp], qv[kQueriesPerWarp], qr[kQueriesPerWarp];
  int qlo[kQueriesPerWarp], qhi[kQueriesPerWarp];
  Top2 acc[kQueriesPerWarp];
#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    const int q = min(q0 + i, N - 1);  // rows past N are computed, not stored
#pragma unroll
    for (int w = 0; w < 8; ++w) qa[i][w] = a[(size_t)q * 8 + w];
    if (windowed) {
      qu[i] = uvq[2 * q];
      qv[i] = uvq[2 * q + 1];
      qr[i] = rad[q];
      qlo[i] = lo[q];
      qhi[i] = hi[q];
    }
    acc[i].d1 = INFINITY;
    acc[i].d2 = INFINITY;
    acc[i].j1 = 0x7fffffff;
  }

  for (int t0 = 0; t0 < M; t0 += kTileKeys) {
    const int nt = min(kTileKeys, M - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < nt * 8; i += blockDim.x) {
      const int k = i >> 3, w = i & 7;
      s_words[w][k] = b[(size_t)(t0 + k) * 8 + w];
    }
    for (int k = threadIdx.x; k < nt; k += blockDim.x) {
      s_valid[k] = valid_b ? valid_b[t0 + k] : (uint8_t)1;
      if (windowed) {
        s_u[k] = uvk[2 * (t0 + k)];
        s_v[k] = uvk[2 * (t0 + k) + 1];
        s_oct[k] = octk[t0 + k];
      }
    }
    __syncthreads();

    for (int k = lane; k < nt; k += 32) {
      const bool kv = s_valid[k] != 0;
#pragma unroll
      for (int i = 0; i < kQueriesPerWarp; ++i) {
        bool ok = kv;
        if (windowed && ok) {
          ok = fabsf(qu[i] - s_u[k]) <= qr[i] && fabsf(qv[i] - s_v[k]) <= qr[i] &&
               s_oct[k] >= qlo[i] && s_oct[k] <= qhi[i];
        }
        float d = kInf;
        if (ok) {
          int h = 0;
#pragma unroll
          for (int w = 0; w < 8; ++w) h += __popc(qa[i][w] ^ s_words[w][k]);
          d = (float)h;
        }
        fold(acc[i], d, t0 + k);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kQueriesPerWarp; ++i) {
    Top2 t = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Top2 o;
      o.d1 = __shfl_xor_sync(0xffffffffu, t.d1, off);
      o.d2 = __shfl_xor_sync(0xffffffffu, t.d2, off);
      o.j1 = __shfl_xor_sync(0xffffffffu, t.j1, off);
      t = merge(t, o);
    }
    const int q = q0 + i;
    if (lane == 0 && q < N) {
      d1_out[q] = t.d1;
      d2_out[q] = t.d2;
      j1_out[q] = t.j1;
    }
  }
}

}  // namespace

// a (N, 32) u8 and b (M, 32) u8 descriptors (read as 8 u32 words a row);
// valid_b (M,) bool or null; windowed != 0 reads uvq (N, 2) f32, uvk (M, 2)
// f32, rad (N,) f32, octk (M,) i32, lo (N,) i32, hi (N,) i32. Outputs d1, d2
// (N,) f32 and j1 (N,) i32. All device pointers, contiguous.
extern "C" int hamming_top2_launch(const uint32_t* a, const uint32_t* b,
                                   const uint8_t* valid_b, const float* uvq,
                                   const float* uvk, const float* rad,
                                   const int* octk, const int* lo, const int* hi,
                                   int windowed, int N, int M, float* d1,
                                   float* d2, int* j1, cudaStream_t stream) {
  if (N <= 0 || M <= 0) return (int)cudaSuccess;
  const int per_block = kWarps * kQueriesPerWarp;
  const int blocks = (N + per_block - 1) / per_block;
  hamming_top2_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      a, b, valid_b, uvq, uvk, rad, octk, lo, hi, windowed, N, M, d1, d2, j1);
  return (int)cudaGetLastError();
}
