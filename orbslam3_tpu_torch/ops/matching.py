"""Binary descriptor matching on torch tensors — the port of
`orbslam3_tpu/ops/matching.py`.

The dense functions (`hamming_matrix`, `best_two`, `match_nn` with an
arbitrary `extra_mask`) are plain tensor code, as in the reference. The
two matchers of the tracking slice go through kernel B1
(`ops/cuda_match.py::hamming_top2`) on CUDA tensors:

* `search_by_projection` (windowed, one-sided) at every size — the
  reference's N·M >= 2^22 dispatch threshold was a TPU choice and the
  outputs are identical either way;
* the unmasked cross-checked `match_nn`, as two launches with the operands
  swapped (`pallas_match.match_nn_fused`).

All distances are float32 small integers; invalid or out-of-window pairs
read exactly INF = 1e9. Ties go to the lowest index.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

TH_LOW = 50
TH_HIGH = 100
INF = 1e9
HISTO_LENGTH = 30  # rotation histogram bins (ref ORBmatcher HISTO_LENGTH)


class Matches(NamedTuple):
    idx: torch.Tensor  # (N,) int32 — best column per row (-1 invalid)
    dist: torch.Tensor  # (N,) float32
    valid: torch.Tensor  # (N,) bool


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 -> (..., 256) float32 bits in {0, 1}."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], 256).to(torch.float32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """(..., N,32) x (..., M,32) uint8 -> (..., N,M) float32 Hamming
    distances (leading axes batch). Exact: the bit dot products are integers
    <= 256 and the float32 sums are lossless (TF32 is off, see the package
    docstring)."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    return a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * (a @ b.transpose(-1, -2))


def _mask_matrix(D, valid_a: Optional[torch.Tensor], valid_b: Optional[torch.Tensor]):
    if valid_a is not None:
        D = torch.where(valid_a[:, None], D, INF)
    if valid_b is not None:
        D = torch.where(valid_b[None, :], D, INF)
    return D


def best_two(D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best and second-best along axis 1 and the argmin (lowest index on
    ties, so the second equals the best when the best is tied)."""
    j = torch.argmin(D, dim=1)
    d1 = D.gather(1, j[:, None])[:, 0]
    d2 = D.scatter(1, j[:, None], float("inf")).amin(dim=1)
    return d1, d2, j.to(torch.int32)


def window_mask(uv_query, uv_kp, radius, octave_kp=None, octave_lo=None, octave_hi=None):
    """(N,M) bool: keypoint inside the query's pixel window and octave band."""
    du = torch.abs(uv_query[:, 0:1] - uv_kp[None, :, 0])
    dv = torch.abs(uv_query[:, 1:2] - uv_kp[None, :, 1])
    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_query.device)
    r = r.expand(uv_query.shape[0])[:, None]
    m = (du <= r) & (dv <= r)
    if octave_kp is not None:
        if octave_lo is not None:
            m &= octave_kp[None, :] >= octave_lo[:, None]
        if octave_hi is not None:
            m &= octave_kp[None, :] <= octave_hi[:, None]
    return m


def _ratio_ok(d1, d2, max_dist, ratio):
    return (d1 <= max_dist) & (d1 <= ratio * d2)


def match_nn(desc_a, desc_b, valid_a=None, valid_b=None, max_dist: float = TH_LOW,
             ratio: float = 0.9, cross_check: bool = True,
             extra_mask: Optional[torch.Tensor] = None) -> Matches:
    """Mutual nearest-neighbour matching with the Lowe ratio test.

    Without `extra_mask` this runs through kernel B1 on CUDA tensors (the
    cross-check is a second launch with the operands swapped; it agrees with
    the dense column argmin on every column a valid match can point at).
    With `extra_mask` (N,M) it is dense tensor code."""
    if extra_mask is None:
        from orbslam3_tpu_torch.ops import cuda_match

        d1, d2, j = cuda_match.hamming_top2(desc_a, desc_b, valid_b)
        ok = _ratio_ok(d1, d2, max_dist, ratio)
        if valid_a is not None:
            ok &= valid_a
        if cross_check:
            _, _, back = cuda_match.hamming_top2(desc_b, desc_a, valid_a)
            rows = torch.arange(desc_a.shape[0], device=desc_a.device, dtype=torch.int32)
            ok &= back[j.to(torch.int64)] == rows
        return Matches(idx=torch.where(ok, j, -1), dist=d1, valid=ok)
    D = _mask_matrix(hamming_matrix(desc_a, desc_b), valid_a, valid_b)
    D = torch.where(extra_mask, D, INF)
    d1, d2, j = best_two(D)
    ok = _ratio_ok(d1, d2, max_dist, ratio)
    if cross_check:
        back = torch.argmin(D, dim=0).to(torch.int32)
        ok &= back[j.to(torch.int64)] == torch.arange(D.shape[0], device=D.device, dtype=torch.int32)
    return Matches(idx=torch.where(ok, j, -1), dist=d1, valid=ok)


def search_by_projection(desc_query, uv_query, valid_query, desc_kp, uv_kp, valid_kp,
                         radius, octave_kp=None, octave_lo=None, octave_hi=None,
                         max_dist: float = TH_HIGH, ratio: float = 0.9) -> Matches:
    """Project-and-match: pixel window + octave band, ratio test within the
    window (kernel B1 on CUDA tensors). Without `octave_kp` (or one side of
    the band) the band is open, as in the reference's `window_mask`."""
    from orbslam3_tpu_torch.ops import cuda_match

    r = torch.as_tensor(radius, dtype=torch.float32, device=uv_query.device)
    window = cuda_match.MatchWindow(uv_query, uv_kp, r.expand(uv_query.shape[0]),
                                    octave_kp, octave_lo, octave_hi)
    d1, d2, j = cuda_match.hamming_top2(desc_query, desc_kp, valid_kp, window)
    ok = _ratio_ok(d1, d2, max_dist, ratio) & valid_query
    return Matches(idx=torch.where(ok, j, -1), dist=d1, valid=ok)


def rotation_consistency(angle_a: torch.Tensor, angle_b: torch.Tensor, matches: Matches,
                         keep_bins: int = 3) -> Matches:
    """Keep only the matches whose angle difference falls in the
    `keep_bins` most popular of HISTO_LENGTH histogram bins (ref
    `ORBmatcher.cc` rotHist, `ComputeThreeMaxima`). Equal counts rank the
    lower bin first, as `lax.top_k` does (C2): a stable descending sort."""
    d_ang = angle_a - angle_b[torch.clamp(matches.idx, min=0).to(torch.int64)]
    # `jnp.remainder`'s float form: the exact fmod, shifted into [0, 360).
    d_deg = torch.fmod(d_ang * (180.0 / math.pi), 360.0)
    d_deg = torch.where(d_deg < 0, d_deg + 360.0, d_deg)
    bins = torch.clamp((d_deg * HISTO_LENGTH / 360.0).to(torch.int32), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=bins.device).index_add(
        0, bins.to(torch.int64), matches.valid.to(torch.int32))
    top = torch.sort(hist, descending=True, stable=True)[1][:keep_bins]
    ok = matches.valid & torch.any(bins[:, None].to(torch.int64) == top[None, :], dim=1)
    return Matches(idx=torch.where(ok, matches.idx, -1), dist=matches.dist, valid=ok)


def assign_unique(matches: Matches, n_cols: int) -> Matches:
    """Keep the lowest-distance row per column; ties go to the first row.
    (Scatter-min is order-independent, so duplicate indices are safe.)"""
    col = torch.clamp(matches.idx, min=0).to(torch.int64)
    dist = torch.where(matches.valid, matches.dist, float("inf"))
    best = torch.full((n_cols,), float("inf"), dtype=dist.dtype, device=dist.device)
    best = best.scatter_reduce(0, col, dist, reduce="amin")
    is_best = matches.valid & (matches.dist <= best[col])
    big = torch.iinfo(torch.int32).max
    rows = torch.arange(matches.idx.shape[0], dtype=torch.int32, device=col.device)
    first = torch.full((n_cols,), big, dtype=torch.int32, device=col.device)
    first = first.scatter_reduce(0, col, torch.where(is_best, rows, big), reduce="amin")
    ok = is_best & (first[col] == rows)
    return Matches(idx=torch.where(ok, matches.idx, -1), dist=matches.dist, valid=ok)
