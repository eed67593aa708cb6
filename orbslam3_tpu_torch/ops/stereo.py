"""Stereo correspondence on torch tensors — the port of the rectified and
RGB-D parts of `orbslam3_tpu/ops/stereo.py` (`Frame::ComputeStereoMatches`,
`Frame::ComputeStereoFromRGBD`). The two-camera fisheye match
(`match_stereo_fisheye`) is ROADMAP A12.

The scanline match is dense tensor code, as in the reference, where it is
XLA and no Pallas kernel: its gates (a row tolerance set by the right
keypoint's octave, a one-sided disparity range, an octave band relative to
the left keypoint) are an arbitrary (N, M) mask, which kernel B1's window
cannot express, so `matching.match_nn` takes them as `extra_mask`. The SAD
refinement is one gather over the 11 shifts; nothing is read back to the
host.

The median-SAD outlier cut follows the reference bit for bit (ROADMAP C11):
the reference takes `jnp.median` over the SADs with NaN at every row that
is not a match, and a NaN median becomes +inf, so the cut acts only when
every row of the frame matched. Then the median is the mean of the two
middle values for an even count. `torch.nanmedian` would differ on both
counts (it skips NaN and returns the lower middle value).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import matching

W_SHIFT = 5  # the SAD search covers +-5 px around the matched right keypoint
HALF = 5  # 11x11 SAD window


class StereoMatches(NamedTuple):
    ur: torch.Tensor  # (N,) refined right-image u per left feature; -1 = none
    depth: torch.Tensor  # (N,) bf / disparity; -1 = none
    valid: torch.Tensor  # (N,) bool


def _median_like_reference(x: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """`jnp.median(where(ok, x, nan))` with a NaN result read as +inf: +inf
    unless every row is ok, else the midpoint of the sorted middle pair."""
    n = x.shape[0]
    s = torch.sort(x).values
    mid = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(ok.all(), mid, torch.full_like(mid, float("inf")))


def _div(a: float, x: torch.Tensor) -> torch.Tensor:
    """a / x in x's dtype by true division (`float / tensor` is
    `reciprocal(x) * a` in PyTorch, up to an ulp away from the reference)."""
    return torch.full_like(x, a) / x


def _patches(img: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor) -> torch.Tensor:
    """(N, 11, 11) pixels around (cx, cy), indices clipped into the image."""
    H, Wd = img.shape
    r = torch.arange(-HALF, HALF + 1, device=img.device)
    gx = torch.clamp(cx[:, None, None] + r[None, None, :], 0, Wd - 1)
    gy = torch.clamp(cy[:, None, None] + r[None, :, None], 0, H - 1)
    return img[gy, gx]


def match_stereo_rectified(fl: feat.Features, fr_: feat.Features, img_left: torch.Tensor,
                           img_right: torch.Tensor, bf: float, scale_factors: torch.Tensor,
                           min_z: float = 0.1) -> StereoMatches:
    """Rectified stereo matching for every left keypoint at once: the
    row gate |v_l - v_r| <= 2 scale(octave_r), the disparity gate
    [0.01, bf / min_z], the octave gate +-1; the best Hamming match within
    (TH_HIGH + TH_LOW) / 2, no ratio test; then the 11x11 SAD over +-5 px
    (on float32 copies of the uint8 images, so every SAD is an exact
    integer), the parabola fit (an unbracketed minimum or |delta| > 1 is
    rejected) and the median-SAD cut (module docstring)."""
    max_d = bf / min_z
    L = scale_factors.shape[0]
    du = fl.uv[:, 0:1] - fr_.uv[None, :, 0]
    dv = torch.abs(fl.uv[:, 1:2] - fr_.uv[None, :, 1])
    r_tol = 2.0 * scale_factors[torch.clamp(fr_.octave, 0, L - 1).to(torch.int64)]
    mask = ((dv <= r_tol[None, :]) & (du >= 0.01) & (du <= max_d)
            & (torch.abs(fl.octave[:, None] - fr_.octave[None, :]) <= 1))
    m = matching.match_nn(fl.desc, fr_.desc, fl.valid, fr_.valid,
                          max_dist=(matching.TH_HIGH + matching.TH_LOW) // 2,
                          ratio=1.0, cross_check=False, extra_mask=mask)

    # SAD refinement at level-0 resolution (the reference works at the
    # keypoint's octave; the JAX package simplified this, and so does the port).
    xl = torch.round(fl.uv[:, 0]).to(torch.int64)  # half to even, as jnp.round
    yl = torch.round(fl.uv[:, 1]).to(torch.int64)
    xr0 = torch.round(fr_.uv[torch.clamp(m.idx, min=0).to(torch.int64), 0]).to(torch.int64)
    patch_l = _patches(img_left, xl, yl)
    patch_l = patch_l - patch_l[:, HALF:HALF + 1, HALF:HALF + 1]
    shifts = torch.arange(-W_SHIFT, W_SHIFT + 1, device=xl.device)
    N = xl.shape[0]
    p = _patches(img_right, (xr0[:, None] + shifts[None, :]).reshape(-1),
                 yl[:, None].expand(N, shifts.shape[0]).reshape(-1))
    p = p.reshape(N, shifts.shape[0], 2 * HALF + 1, 2 * HALF + 1)
    p = p - p[:, :, HALF:HALF + 1, HALF:HALF + 1]
    sads = torch.sum(torch.abs(p - patch_l[:, None]), dim=(2, 3))  # (N, 11)
    best = torch.argmin(sads, dim=1)  # the first index on ties, as jnp.argmin
    bracketed = (best > 0) & (best < 2 * W_SHIFT)
    best_c = torch.clamp(best, 1, 2 * W_SHIFT - 1)
    s_m1 = sads.gather(1, (best_c - 1)[:, None])[:, 0]
    s_0 = sads.gather(1, best_c[:, None])[:, 0]
    s_p1 = sads.gather(1, (best_c + 1)[:, None])[:, 0]
    denom = s_m1 + s_p1 - 2 * s_0
    delta = torch.where(torch.abs(denom) > 1e-6, 0.5 * (s_m1 - s_p1) / denom,
                        torch.zeros_like(denom))
    delta_ok = torch.abs(delta) <= 1.0
    delta = torch.clamp(delta, -1.0, 1.0)
    ur = xr0.to(torch.float32) + (best_c - W_SHIFT).to(torch.float32) + delta

    disparity = fl.uv[:, 0] - ur
    ok = m.valid & bracketed & delta_ok & (disparity > 0.01) & (disparity < max_d)
    # Median-SAD outlier cut, 1.5 * 1.4 * median (Frame.cc:1115-1130), as the
    # reference computes it (ROADMAP C11).
    ok = ok & (s_0 <= 2.1 * _median_like_reference(s_0, ok))
    minus1 = torch.full_like(ur, -1.0)
    depth = torch.where(ok, _div(bf, torch.clamp(disparity, min=1e-6)), minus1)
    return StereoMatches(ur=torch.where(ok, ur, minus1), depth=depth, valid=ok)


def depth_to_ur(uv: torch.Tensor, valid: torch.Tensor, depth_map: torch.Tensor,
                bf: float) -> StereoMatches:
    """RGB-D (`ComputeStereoFromRGBD`): the depth at each keypoint's nearest
    pixel and the virtual right coordinate ur = u - bf / d; a depth <= 0 is
    no measurement."""
    H, W = depth_map.shape
    x = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 0, H - 1)
    d = depth_map[y, x]
    ok = valid & (d > 0)
    minus1 = torch.full_like(d, -1.0)
    ur = torch.where(ok, uv[:, 0] - _div(bf, torch.clamp(d, min=1e-6)), minus1)
    return StereoMatches(ur=ur, depth=torch.where(ok, d, minus1), valid=ok)
