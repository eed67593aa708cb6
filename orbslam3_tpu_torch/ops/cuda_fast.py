"""Kernel B2: FAST-9/16 + score + 3x3 NMS in one launch (`csrc/fast_nms.cu`).

Replaces the Pallas kernel of `orbslam3_tpu/ops/pallas_fast.py`. In the
JAX package that kernel is opt-in and refused above 2.6 MB, so at EuRoC
size the reference runs its XLA version (`features.fast_score` +
`features._nms3`); the CUDA kernel computes that same function over the
whole pyramid atlas and is the port's main path.

On a CPU tensor the wrapper runs `features.fast_score_nms_plain`; on a
CUDA tensor it launches the kernel or raises. It converts nothing: the
image is a contiguous 2-D float32 tensor, and only the two outputs are
allocated.
"""

from __future__ import annotations

from typing import Tuple

import torch

from orbslam3_tpu_torch.ops import _build
from orbslam3_tpu_torch.ops import features as feat

LAUNCHES = 0  # wrapper calls that launched the kernel


def fast_score_nms(img: torch.Tensor, min_th: float, ini_th: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score after 3x3 NMS (H, W) f32, pass_ini (H, W) bool) of a float32
    image (H, W); border taps read 0."""
    if not _build.use_kernel(img):
        return feat.fast_score_nms_plain(img, min_th, ini_th)
    global LAUNCHES
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"fast_score_nms takes a contiguous 2-D float32 image, got {img.dtype} "
                         f"{tuple(img.shape)} with strides {img.stride()}")
    H, W = img.shape
    score = torch.empty_like(img)
    ini = torch.empty((H, W), dtype=torch.bool, device=img.device)
    if img.numel() == 0:
        return score, ini
    _build.launch("fast_nms_launch", _build.ptr(img), _build.ptr(score), _build.ptr(ini),
                  H, W, float(min_th), float(ini_th))
    LAUNCHES += 1
    return score, ini
