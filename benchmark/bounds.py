"""The least time of each kernel call on an H100 SXM: a frozen copy of the
bound arithmetic of `orbslam3_tpu_torch/kernel_bench.py` (`b1_bound`,
`b2_bound`); B1's pairs are counted with the reference's window mask
(`reference/match.py`, a copy of `ops/matching.py::window_mask`).

A bound is the larger of the bytes read once and written once at the HBM
rate and the operations the call's data needs at the peak rate of their
type (NVIDIA's data sheet figures for the SXM part at its 700 W limit).
Plain PyTorch; nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.match import window_mask

HBM_BYTES_PER_S = 3.35e12
# `__popc`: 16 per SM per clock (compute capability 9.0), 132 SMs, 1.98 GHz.
POPC_PER_S = 132 * 16 * 1.98e9
# float32 outside the tensor cores: 128 lanes per SM per clock (the data
# sheet's 67 TFLOP/s counts a fused multiply-add as two).
FP32_OPS_PER_S = 132 * 128 * 1.98e9
# B2's float32 operations per atlas pixel: per ring tap 4 threshold compares
# and, for each of the two score sums, 2 subtractions, a max and an add; 4
# thresholds per pixel; 9 maxima for the NMS (integer bit work not counted).
B2_FP32_OPS_PER_PIXEL = 16 * (4 + 2 * 4) + 4 + 9

# Kernel names as the profiler reports them.
B1_KERNELS = ("hamming_top2_kernel",)
B2_KERNELS = ("fast_nms_tile_kernel",)


def _bound(nbytes: float, ops: float, ops_per_s: float) -> Dict[str, float]:
    byte_us, op_us = nbytes / HBM_BYTES_PER_S * 1e6, ops / ops_per_s * 1e6
    return {"bytes": float(nbytes), "ops": float(ops), "bound_us": max(byte_us, op_us)}


def b1_pairs(n: int, m: int, valid_b=None, window=None, block: int = 8192) -> int:
    """Valid (query, key) pairs of one B1 call: every valid key for every
    query, or those inside each query's window (counted in row blocks)."""
    ok = None if valid_b is None else valid_b.to(torch.bool)
    if window is None:
        return n * (m if ok is None else int(ok.sum()))
    uv_q, uv_k, r, oct_k, lo, hi = window
    r = torch.as_tensor(r)
    pairs = 0
    for i in range(0, n, block):
        j = min(n, i + block)
        ri = r if r.dim() == 0 or r.numel() == 1 else r[i:j]
        mk = window_mask(uv_q[i:j], uv_k, ri, oct_k, None if lo is None else lo[i:j],
                         None if hi is None else hi[i:j])
        if ok is not None:
            mk &= ok[None, :]
        pairs += int(mk.sum())
    return pairs


def b1_bound(n: int, m: int, valid_b=None, window=None,
             radius_shared: bool = False) -> Dict[str, float]:
    """B1's least time: inputs and outputs once; 8 popcounts per valid key
    in each query's window. `window` is (uv_q, uv_k, radius, octave_k,
    octave_lo, octave_hi); `radius_shared` when one radius serves every
    query (read once)."""
    nbytes = 32 * (n + m) + 12 * n + (m if valid_b is not None else 0)
    if window is not None:
        nbytes += 8 * n + 8 * m + 4 * m + 8 * n + 4 * (1 if radius_shared else n)
    return _bound(nbytes, 8 * b1_pairs(n, m, valid_b, window), POPC_PER_S)


def b2_bound(height: int, width: int) -> Dict[str, float]:
    """B2's least time over an atlas of height x width pixels: the float32
    atlas in, the float32 score and bool pass_ini out;
    B2_FP32_OPS_PER_PIXEL float32 operations per pixel."""
    px = height * width
    return _bound(4 * px + 5 * px, B2_FP32_OPS_PER_PIXEL * px, FP32_OPS_PER_S)
