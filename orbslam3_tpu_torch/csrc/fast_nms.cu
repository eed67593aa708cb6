// Kernel B2: FAST-9/16 segment test + margin score + 3x3 non-max
// suppression, in one launch over shared-memory halo tiles.
//
// Replaces the Pallas TPU kernel `_fast_nms_kernel`
// (orbslam3_tpu/ops/pallas_fast.py:60, launched by `fast_score_nms_pallas`
// at pallas_fast.py:141). It computes the same function as the plain
// version `fast_score_nms_plain` (ops/features.py of this package), and the
// reference's XLA path `features.fast_score` + `features._nms3` away from
// the border (the reference wraps with `jnp.roll` there; both versions of
// the port read 0 outside the image):
//   score = 3x3-NMS(is_min ? max(sum max((r-c)-t,0), sum max((c-r)-t,0)) : 0),
//   pass_ini = is_min && is_ini,
// with t = min_th, is_x a cyclic run of >= 9 ring taps all brighter than
// c + th or all darker than c - th (th = min_th or ini_th), the 16 taps of
// the radius-3 circle read as 0 outside the image, and NMS keeping ties
// (score >= every neighbour; neighbours outside the image ignored).
//
// What bounds it on the H100, at the EuRoC atlas (2400 x 768 float32):
//   bytes: the atlas read once (7.4 MB), score (7.4 MB) and pass_ini
//     (1.8 MB) written once: 16.6 MB, 4.95 us at 3.35 TB/s;
//   float32 operations: ~205 a pixel (per tap 4 threshold compares and,
//     for each of the two sums, a subtraction, a max and an add; 9 maxima
//     for the NMS), 11.3 us at 33.5 T/s;
//   but also ~60 operations a pixel that are not float arithmetic: placing
//     64 compare results into four 16-bit masks and testing each for a run.
// So it is bound by instruction issue, not by memory: an SM issues one
// warp instruction per scheduler per clock, and compares, selects, maxima,
// shifts and logic go to a pipe of half that rate. The first version made
// two launches: one thread per pixel doing 16 bounds-tested global loads (4
// compares, a 64-bit address and a select per tap), the pre-NMS score
// written to a scratch map, then read back with 9 more bounds-tested loads
// per pixel: ~31 MB of traffic, 814 SASS instructions per pixel.
//
// Design, against that bound:
// (1) One block of 512 threads per 64 x 32 output tile (900 blocks on the
//     atlas). The block stages the (32 + 8) x (64 + 8) input pixels its
//     taps reach (3 px of ring and 1 px of NMS reach on each side) in
//     shared memory, coalesced along rows, reading 0 outside the image:
//     exactly the plain version's zero padding. The row stride is odd
//     (73 floats), so a warp's column reads hit distinct banks.
// (2) The tile plus a 1-px ring (34 x 66 positions) is scored from shared
//     memory: each tap is a load at a constant offset from one base address
//     (an immediate in the instruction), with no bounds test and no 64-bit
//     address arithmetic. Positions outside the image score 0 without
//     running the test on the padding: the plain version's max pool pads
//     with -inf, and since scores are >= 0, 0 is the same there. Each thread
//     scores 4 positions of the inner tile, keeping their pass_ini in
//     registers, and threads 0..195 score one position of the ring.
// (3) After one barrier, each thread suppresses its 4 inner positions from
//     the shared score tile and writes score and pass_ini once each. The
//     pre-NMS score never leaves shared memory.
// (4) Work moved to the full-rate float pipe: a compare yields 1.0f or 0.0f
//     (FSET) and an FMA adds it times 2^i into a float mask (exact: a sum of
//     distinct powers of two below 2^16), instead of a predicate, a select
//     and an integer OR; max(x, 0) is (x + |x|) / 2 folded into the FMA that
//     adds it to the score sum (exact while |x| < 2^127: doubling and
//     halving are exact, and the FMA rounds once, as the plain add does).
//     (c - r) - t is (-d) - t with d = r - c, the same float (round-to-
//     nearest is symmetric). The run test takes 4 doubling steps (runs of 2,
//     4, 8, then 9) instead of 8 shifted ANDs. With predicates, selects and
//     FMNMX the same tiles were bound by that half-rate pipe (PERF.md §6);
//     64 x 32 tiles beat 64 x 16 because the ring and halo are a smaller
//     share of a taller tile.
//
// Float semantics follow the plain version exactly for finite inputs below
// 2^126 in magnitude (any image of grey levels): the compares are
// r > c + th and r < c - th (not (r - c) > th, which rounds differently on
// non-integer inputs), and the terms (r - c) - t and (c - r) - t are summed
// in ring order with explicit round-to-nearest intrinsics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;  // outputs per tile row
constexpr int kTileH = 32;  // output rows per tile
constexpr int kThreads = 512;
constexpr int kReach = 4;                  // 3 px of FAST ring + 1 px of NMS
constexpr int kInW = kTileW + 2 * kReach;  // 72 staged columns
constexpr int kInH = kTileH + 2 * kReach;  // 40 staged rows
constexpr int kInStride = kInW + 1;        // odd: column reads hit distinct banks
constexpr int kExtW = kTileW + 2;          // scored positions: the tile and a 1-px ring
constexpr int kExtH = kTileH + 2;
constexpr int kExtStride = kExtW + 1;
constexpr int kRowsPerThread = kTileW * kTileH / kThreads;  // 4 inner positions a thread
constexpr int kRing = 2 * kExtW + 2 * kTileH;               // 196 ring positions
constexpr int kStageLoads = (kInW * kInH + kThreads - 1) / kThreads;

static_assert(kThreads % kTileW == 0 && kRing <= kThreads, "tile shape");

// Contiguous run >= 9 over the 16-cycle of a mask held as a float (the sum
// of 2^i over the set taps): with w the mask doubled, a[p] = w[p] & .. &
// w[p + k - 1] for runs of k = 2, 4, 8, then 9.
__device__ __forceinline__ bool arc9(float mask) {
  const uint32_t bits = (uint32_t)mask;
  const uint32_t w = bits | (bits << 16);
  uint32_t a = w & (w >> 1);
  a &= a >> 2;
  a &= a >> 4;
  a &= a >> 1;
  return (a & 0xFFFFu) != 0u;
}

// 1.0f when a > b, else 0.0f (also when either is NaN): one FSET.
__device__ __forceinline__ float gt(float a, float b) {
  float m;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// s + max(x, 0), rounded once: (x + |x|) / 2 is max(x, 0) exactly.
__device__ __forceinline__ float add_relu(float s, float x) {
  return __fmaf_rn(0.5f, __fadd_rn(x, fabsf(x)), s);
}

// FAST score of the pixel at `p` (a shared-memory tile with row stride
// kInStride and at least 3 staged pixels on every side); sets pass_ini.
__device__ __forceinline__ float fast_score(const float* p, float min_th, float ini_th,
                                            bool& pass_ini) {
  // The circle of radius 3 in features._FAST_OFFSETS order, as (dx, dy).
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int dy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  const float c = p[0];
  const float hi_min = __fadd_rn(c, min_th), lo_min = __fsub_rn(c, min_th);
  const float hi_ini = __fadd_rn(c, ini_th), lo_ini = __fsub_rn(c, ini_th);
  float b_min = 0.f, d_min = 0.f, b_ini = 0.f, d_ini = 0.f;  // masks as sums of 2^i
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float r = p[dy[i] * kInStride + dx[i]];
    const float bit = (float)(1u << i);
    b_min = __fmaf_rn(gt(r, hi_min), bit, b_min);
    d_min = __fmaf_rn(gt(lo_min, r), bit, d_min);
    b_ini = __fmaf_rn(gt(r, hi_ini), bit, b_ini);
    d_ini = __fmaf_rn(gt(lo_ini, r), bit, d_ini);
    const float d = __fsub_rn(r, c);  // and c - r == -d exactly
    sb = add_relu(sb, __fsub_rn(d, min_th));
    sd = add_relu(sd, __fsub_rn(-d, min_th));
  }
  const bool is_min = arc9(b_min) || arc9(d_min);
  pass_ini = is_min && (arc9(b_ini) || arc9(d_ini));
  return is_min ? fmaxf(sb, sd) : 0.f;
}

__global__ void __launch_bounds__(kThreads)
fast_nms_tile_kernel(const float* __restrict__ img, float* __restrict__ score,
                     uint8_t* __restrict__ ini, int H, int W, float min_th, float ini_th) {
  __shared__ float s_in[kInH * kInStride];    // input pixel (y0 - 4 + r, x0 - 4 + c)
  __shared__ float s_sc[kExtH * kExtStride];  // pre-NMS score at (y0 - 1 + r, x0 - 1 + c)
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;

  // (1) Stage: every load issued before any is used.
  float v[kStageLoads];
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / kInW, c = i - r * kInW;
    const int y = y0 - kReach + r, x = x0 - kReach + c;
    v[k] = i < kInW * kInH && y >= 0 && y < H && x >= 0 && x < W ? img[(size_t)y * W + x] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < kInW * kInH) s_in[(i / kInW) * kInStride + i % kInW] = v[k];
  }
  __syncthreads();

  // (2) Score the inner tile (4 rows a thread, pass_ini kept) and the ring.
  const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
  const int x = x0 + tx;
  bool pass[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int iy = ty + k * (kThreads / kTileW);
    float s = 0.f;
    pass[k] = false;
    if (y0 + iy < H && x < W)
      s = fast_score(s_in + (iy + kReach) * kInStride + tx + kReach, min_th, ini_th, pass[k]);
    s_sc[(iy + 1) * kExtStride + tx + 1] = s;
  }
  if (threadIdx.x < kRing) {
    const int i = threadIdx.x;
    int er, ec;  // position in the extended tile
    if (i < kExtW) {
      er = 0, ec = i;
    } else if (i < 2 * kExtW) {
      er = kExtH - 1, ec = i - kExtW;
    } else if (i < 2 * kExtW + kTileH) {
      er = 1 + i - 2 * kExtW, ec = 0;
    } else {
      er = 1 + i - 2 * kExtW - kTileH, ec = kExtW - 1;
    }
    const int y = y0 - 1 + er, xr = x0 - 1 + ec;
    float s = 0.f;
    bool unused;
    if (y >= 0 && y < H && xr >= 0 && xr < W)
      s = fast_score(s_in + (er + kReach - 1) * kInStride + ec + kReach - 1, min_th, ini_th,
                     unused);
    s_sc[er * kExtStride + ec] = s;
  }
  __syncthreads();

  // (3) Suppress and write each output once.
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int iy = ty + k * (kThreads / kTileW);
    const int y = y0 + iy;
    if (y >= H || x >= W) continue;
    const float* q = s_sc + (iy + 1) * kExtStride + tx + 1;
    const float c = q[0];
    float m = c;
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr)
#pragma unroll
      for (int dc = -1; dc <= 1; ++dc) m = fmaxf(m, q[dr * kExtStride + dc]);
    const size_t o = (size_t)y * W + x;
    score[o] = c >= m ? c : 0.f;
    ini[o] = (uint8_t)pass[k];
  }
}

}  // namespace

// img (H, W) f32 in; score (H, W) f32 and ini (H, W) bool out. All device
// pointers, contiguous. H, W >= 0 (an empty image launches nothing).
extern "C" int fast_nms_launch(const float* img, float* score, uint8_t* ini, int H, int W,
                               float min_th, float ini_th, cudaStream_t stream) {
  if (H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  fast_nms_tile_kernel<<<grid, kThreads, 0, stream>>>(img, score, ini, H, W, min_th, ini_th);
  return (int)cudaGetLastError();
}
