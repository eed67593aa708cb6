// Fused FAST-9/16 segment test + margin score, then 3x3 non-max suppression.
//
// Replaces the Pallas TPU kernel `_fast_nms_kernel`
// (orbslam3_tpu/ops/pallas_fast.py:60, launched by `fast_score_nms_pallas`
// at pallas_fast.py:141). It computes the same function as the plain
// version `fast_score_nms_plain` (ops/features.py of this package) and as
// the reference's XLA path `features.fast_score` + `features._nms3`:
//
//   pass 1, one thread per pixel: read the 16 ring taps (zero outside the
//     image), build the brighter/darker bitmasks at min_th and at ini_th,
//     test each for a cyclic run of >= 9 set bits, and write the margin
//     score max(sum max(r-c-th,0), sum max(c-r-th,0)) at min_th corners (0
//     elsewhere) and pass_ini (a corner at both thresholds);
//   pass 2: 3x3 NMS that keeps ties (score >= every neighbour), with
//     neighbours outside the image ignored.
//
// What bounds it on the H100: memory traffic, not arithmetic. At the EuRoC
// atlas (2400 x 768 float32, 7.4 MB) pass 1 reads the image once (the 16
// taps hit L1/L2) and writes 7.4 MB of score + 1.8 MB of pass_ini; pass 2
// reads the 7.4 MB score and writes 7.4 MB: about 15 MB read and 17 MB
// written per frame, a few microseconds at 3.35 TB/s. The design answers
// that by doing all per-pixel arithmetic in registers (the TPU kernel's
// VMEM scratch planes become per-thread registers) and by keeping the
// intermediate score map to one scratch buffer that the wrapper allocates.
// The TPU kernel's whole-level-in-VMEM limit (2.6 MB) does not exist here.
//
// Float semantics follow the plain version exactly: comparisons are
// r > c + th and r < c - th, the score terms (r - c) - th and (c - r) - th
// are summed in ring order; no multiply is involved, so no FMA contraction
// can change a bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// FAST circle of radius 3, (dx, dy), same order as features._FAST_OFFSETS.
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ bool arc9(uint32_t bits) {
  // Contiguous run >= 9 over the 16-cycle: AND of 9 shifted copies of the
  // doubled mask (features.fast_score::arc9).
  uint32_t w = bits | (bits << 16);
  uint32_t acc = w;
#pragma unroll
  for (int j = 1; j < 9; ++j) acc &= (w >> j);
  return (acc & 0xFFFFu) != 0u;
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ score,
                                  uint8_t* __restrict__ ini, int H, int W,
                                  float min_th, float ini_th) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float c = img[(size_t)y * W + x];
  const float c_hi_min = c + min_th, c_lo_min = c - min_th;
  const float c_hi_ini = c + ini_th, c_lo_ini = c - ini_th;
  uint32_t b_min = 0u, d_min = 0u, b_ini = 0u, d_ini = 0u;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int xx = x + kDx[i], yy = y + kDy[i];
    const float r = (xx >= 0 && xx < W && yy >= 0 && yy < H)
                        ? img[(size_t)yy * W + xx]
                        : 0.f;
    b_min |= (uint32_t)(r > c_hi_min) << i;
    d_min |= (uint32_t)(r < c_lo_min) << i;
    b_ini |= (uint32_t)(r > c_hi_ini) << i;
    d_ini |= (uint32_t)(r < c_lo_ini) << i;
    sb = __fadd_rn(sb, fmaxf(__fsub_rn(__fsub_rn(r, c), min_th), 0.f));
    sd = __fadd_rn(sd, fmaxf(__fsub_rn(__fsub_rn(c, r), min_th), 0.f));
  }
  const bool is_min = arc9(b_min) || arc9(d_min);
  const bool is_ini = arc9(b_ini) || arc9(d_ini);
  const size_t o = (size_t)y * W + x;
  score[o] = is_min ? fmaxf(sb, sd) : 0.f;
  ini[o] = (uint8_t)(is_ini && is_min);
}

__global__ void nms3_kernel(const float* __restrict__ s, float* __restrict__ out,
                            int H, int W) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const float v = s[(size_t)y * W + x];
  float m = v;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int xx = x + dx, yy = y + dy;
      if (xx >= 0 && xx < W && yy >= 0 && yy < H)
        m = fmaxf(m, s[(size_t)yy * W + xx]);
    }
  }
  out[(size_t)y * W + x] = (v >= m) ? v : 0.f;
}

}  // namespace

// img (H, W) f32 in; score (H, W) f32 and ini (H, W) bool out; scratch
// (H, W) f32 holds the pre-NMS score. All device pointers, contiguous.
extern "C" int fast_nms_launch(const float* img, float* score, uint8_t* ini,
                               float* scratch, int H, int W, float min_th,
                               float ini_th, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
  fast_score_kernel<<<grid, block, 0, stream>>>(img, scratch, ini, H, W,
                                                min_th, ini_th);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms3_kernel<<<grid, block, 0, stream>>>(scratch, score, H, W);
  return (int)cudaGetLastError();
}
