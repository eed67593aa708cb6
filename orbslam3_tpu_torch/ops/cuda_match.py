"""Kernel B1: Hamming distance + top-2 with the projection window
(`csrc/hamming_top2.cu`).

Replaces the Pallas kernel of `orbslam3_tpu/ops/pallas_match.py`
(`_kernel`, launched by `_top2_call`). On a CPU tensor the wrapper runs
the plain version, `best_two` over the masked dense Hamming matrix of
`ops/matching.py`; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from orbslam3_tpu_torch.ops import _build
from orbslam3_tpu_torch.ops import matching

LAUNCHES = 0  # wrapper calls that launched the kernel


class MatchWindow(NamedTuple):
    """Per-query / per-key attributes of the projection search window."""

    uv_q: torch.Tensor  # (N, 2) predicted pixel positions of the queries
    uv_k: torch.Tensor  # (M, 2) keypoint pixel positions
    radius_q: torch.Tensor  # (N,) search radius per query (pixels)
    octave_k: torch.Tensor  # (M,) keypoint octave
    octave_lo: torch.Tensor  # (N,) inclusive lower octave gate
    octave_hi: torch.Tensor  # (N,) inclusive upper octave gate


def hamming_top2_plain(desc_a, desc_b, valid_b=None, window: Optional[MatchWindow] = None):
    """`best_two(_mask_matrix(hamming_matrix(a, b), None, valid_b))`, with
    the window mask folded in when given."""
    D = matching._mask_matrix(matching.hamming_matrix(desc_a, desc_b), None, valid_b)
    if window is not None:
        m = matching.window_mask(window.uv_q, window.uv_k, window.radius_q,
                                 window.octave_k, window.octave_lo, window.octave_hi)
        D = torch.where(m, D, matching.INF)
    return matching.best_two(D)


def hamming_top2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                 valid_b: Optional[torch.Tensor] = None,
                 window: Optional[MatchWindow] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best (N,) f32, second (N,) f32, argbest (N,) i32) per query row of
    `desc_a` (N, 32) u8 over the key rows of `desc_b` (M, 32) u8. Query
    validity is the caller's: invalid rows return values that are masked
    afterwards, as in the reference."""
    if not _build.use_kernel(desc_a):
        return hamming_top2_plain(desc_a, desc_b, valid_b, window)
    global LAUNCHES
    for name, d in (("desc_a", desc_a), ("desc_b", desc_b)):
        if d.dtype != torch.uint8 or d.dim() != 2 or d.shape[1] != 32:
            raise ValueError(f"{name} must be (n, 32) uint8, got {d.dtype} {tuple(d.shape)}")
    dev = desc_a.device
    n, m = desc_a.shape[0], desc_b.shape[0]
    # The kernel reads each 32-byte row as 8 u32 words: rows must be 4-aligned.
    a = desc_a.contiguous() if desc_a.data_ptr() % 4 == 0 else desc_a.clone()
    b = desc_b.contiguous() if desc_b.data_ptr() % 4 == 0 else desc_b.clone()
    vb = None if valid_b is None else valid_b.to(torch.bool).contiguous()
    d1 = torch.empty(n, dtype=torch.float32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    j1 = torch.empty(n, dtype=torch.int32, device=dev)
    wargs = [None] * 6
    if window is not None:
        wargs = [
            window.uv_q.to(torch.float32).contiguous(),
            window.uv_k.to(torch.float32).contiguous(),
            window.radius_q.to(torch.float32).expand(n).contiguous(),
            window.octave_k.to(torch.int32).contiguous(),
            window.octave_lo.to(torch.int32).contiguous(),
            window.octave_hi.to(torch.int32).contiguous(),
        ]
    # The kernel reads raw pointers: every input lies on the card, at its shape.
    shapes = [(b, (m, 32)), (vb, (m,))] + list(zip(wargs, [(n, 2), (m, 2), (n,), (m,), (n,), (n,)]))
    for x, shape in shapes:
        if x is not None and (x.device != dev or tuple(x.shape) != shape):
            raise ValueError(f"hamming_top2: expected {shape} on {dev}, got {tuple(x.shape)} on {x.device}")
    _build.launch(
        "hamming_top2_launch", _build.ptr(a), _build.ptr(b), _build.ptr(vb),
        *(_build.ptr(w) for w in wargs), int(window is not None), n, m,
        _build.ptr(d1), _build.ptr(d2), _build.ptr(j1),
    )
    LAUNCHES += 1
    return d1, d2, j1
