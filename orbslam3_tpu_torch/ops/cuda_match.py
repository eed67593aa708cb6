"""Kernel B1: Hamming distance + top-2 with the projection window
(`csrc/hamming_top2.cu`).

Replaces the Pallas kernel of `orbslam3_tpu/ops/pallas_match.py`
(`_kernel`, launched by `_top2_call`). On a CPU tensor the wrapper runs
the plain version, `best_two` over the masked dense Hamming matrix of
`ops/matching.py`; on a CUDA tensor it launches the kernel or raises.

The kernel takes the documented types as they are and the wrapper converts
nothing: (n, 32) uint8 descriptors on 4-byte boundaries, bool key validity,
float32 positions and radius, int32 octaves, every tensor contiguous on the
queries' device. The radius is (n,) or one value for all queries (0-d, or
expanded with stride 0), passed by stride, never copied. Any number of
keys from 1: the kernel folds over them in tiles of 1024. A window without
octaves (`octave_k` None, as the loop closer's Sim3 projection asks) gets
an open band: octave 0 for every key and [INT32_MIN, INT32_MAX] for every
query, which every key passes, so the kernel stays as it is.
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
    octave_k: Optional[torch.Tensor] = None  # (M,) keypoint octave; None: no octave gate
    octave_lo: Optional[torch.Tensor] = None  # (N,) inclusive lower gate; None: open
    octave_hi: Optional[torch.Tensor] = None  # (N,) inclusive upper gate; None: open


_I32 = torch.iinfo(torch.int32)


def open_band(window: Optional[MatchWindow], n: int, m: int) -> Optional[MatchWindow]:
    """`window` with its missing octave gates filled by the open band, as
    `matching.window_mask` reads them: no `octave_k`, no octave test at all;
    no `octave_lo` or `octave_hi`, that side open."""
    if window is None or None not in (window.octave_k, window.octave_lo, window.octave_hi):
        return window
    dev = window.uv_q.device

    def full(k, v):
        return torch.full((k,), v, dtype=torch.int32, device=dev)

    if window.octave_k is None:
        return window._replace(octave_k=full(m, 0), octave_lo=full(n, _I32.min),
                               octave_hi=full(n, _I32.max))
    return window._replace(
        octave_lo=full(n, _I32.min) if window.octave_lo is None else window.octave_lo,
        octave_hi=full(n, _I32.max) if window.octave_hi is None else window.octave_hi)


def hamming_top2_plain(desc_a, desc_b, valid_b=None, window: Optional[MatchWindow] = None):
    """`best_two(_mask_matrix(hamming_matrix(a, b), None, valid_b))`, with
    the window mask folded in when given."""
    D = matching._mask_matrix(matching.hamming_matrix(desc_a, desc_b), None, valid_b)
    if window is not None:
        m = matching.window_mask(window.uv_q, window.uv_k, window.radius_q,
                                 window.octave_k, window.octave_lo, window.octave_hi)
        D = torch.where(m, D, matching.INF)
    return matching.best_two(D)


def _require(name: str, x: torch.Tensor, dtype: torch.dtype, shape, dev: torch.device) -> None:
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(f"hamming_top2: {name} must be a contiguous {dtype} {shape} on {dev}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _radius_stride(r: torch.Tensor, n: int, dev: torch.device) -> int:
    """0 for one radius shared by all queries, else 1; raises on anything else."""
    if r.dim() == 0:
        stride = 0
    elif tuple(r.shape) == (n,):
        stride = r.stride(0) if n > 1 else 0
    else:
        stride = -1
    if r.device != dev or r.dtype != torch.float32 or stride not in (0, 1):
        raise ValueError(f"hamming_top2: radius_q must be float32 () or ({n},) with stride 0 "
                         f"or 1 on {dev}, got {r.dtype} {tuple(r.shape)} on {r.device}")
    return stride


def kernel_args(desc_a: torch.Tensor, desc_b: torch.Tensor,
                valid_b: Optional[torch.Tensor] = None,
                window: Optional[MatchWindow] = None) -> Tuple[int, int, int]:
    """(n, m, radius stride) of a call the kernel takes as it is; raises
    ValueError on anything else (type, shape, layout, device, no keys)."""
    dev = desc_a.device
    n = desc_a.shape[0] if desc_a.dim() == 2 else -1
    m = desc_b.shape[0] if desc_b.dim() == 2 else -1
    _require("desc_a", desc_a, torch.uint8, (n, 32), dev)
    _require("desc_b", desc_b, torch.uint8, (m, 32), dev)
    if m < 1:
        raise ValueError("hamming_top2: no keys; the kernel takes 1 or more")
    # The kernel reads each 32-byte row as 8 u32 words.
    if desc_a.data_ptr() % 4 or desc_b.data_ptr() % 4:
        raise ValueError("hamming_top2: descriptors must start on a 4-byte boundary")
    if valid_b is not None:
        _require("valid_b", valid_b, torch.bool, (m,), dev)
    if window is None:
        return n, m, 0
    window = open_band(window, n, m)
    for name, x, dtype, shape in (
            ("uv_q", window.uv_q, torch.float32, (n, 2)),
            ("uv_k", window.uv_k, torch.float32, (m, 2)),
            ("octave_k", window.octave_k, torch.int32, (m,)),
            ("octave_lo", window.octave_lo, torch.int32, (n,)),
            ("octave_hi", window.octave_hi, torch.int32, (n,))):
        _require(name, x, dtype, shape, dev)
    return n, m, _radius_stride(window.radius_q, n, dev)


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
    window = open_band(window, desc_a.shape[0], desc_b.shape[0])
    n, m, rad_stride = kernel_args(desc_a, desc_b, valid_b, window)
    dev = desc_a.device
    d1 = torch.empty(n, dtype=torch.float32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    j1 = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return d1, d2, j1
    uvq, uvk, rad, octk, lo, hi = (_build.ptr(w) for w in (window or [None] * 6))
    _build.launch(
        "hamming_top2_launch", _build.ptr(desc_a), _build.ptr(desc_b), _build.ptr(valid_b),
        uvq, uvk, rad, rad_stride, octk, lo, hi, int(window is not None), n, m,
        _build.ptr(d1), _build.ptr(d2), _build.ptr(j1),
    )
    LAUNCHES += 1
    return d1, d2, j1
