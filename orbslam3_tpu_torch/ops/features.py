"""ORB feature extraction on torch tensors — the port of
`orbslam3_tpu/ops/features.py::extract` and what it calls.

Same organisation as the reference: all pyramid levels are stacked into
one atlas image, FAST + NMS run once over the atlas (kernel B2,
`ops/cuda_fast.py`, on CUDA tensors), a spatially balanced top-k is taken
per level, and one (N, 46, 46) patch gather serves the IC angle, the
in-patch Gaussian blur and steered BRIEF.

Where the reference used TPU-shaped formulations, the port computes the
same numbers directly:

* the pyramid resize builds `jax.image.resize(method="bilinear")`'s
  antialiased triangle weights in numpy (scale as a Python float, as JAX
  does) and applies them as two float32 matmuls, (Wy^T @ img) @ Wx;
* `_extract_patches` is a plain index gather (the reference's one-hot
  bf16 matmuls pick the same integers);
* BRIEF compares the blurred patch rounded to bfloat16, as the
  reference's one-hot bf16 einsum does.

Ties in every top-k and sort break on the lowest index (stable sorts), as
`lax.top_k` and `jnp.argsort` do.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from orbslam3_tpu_torch import spans

EDGE_THRESHOLD = 19  # border where no keypoints live
PATCH_RADIUS = 15  # IC-angle patch radius
CELL = 32  # selection cell size


class OrbParams(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0


class Features(NamedTuple):
    """Fixed-capacity keypoint set for one image (all tensors length N)."""

    uv: torch.Tensor  # (N,2) float32 — level-0 pixel coords
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) float32 radians
    desc: torch.Tensor  # (N,32) uint8 packed descriptor
    valid: torch.Tensor  # (N,) bool

    @property
    def n(self):
        return self.uv.shape[0]


# ---------------------------------------------------------------------------
# Static tables (recomputed in numpy exactly as the reference builds them)
# ---------------------------------------------------------------------------

# FAST circle of radius 3 (dx, dy), standard ordering.
_FAST_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)


def _brief_pattern(seed: int = 42, n_pairs: int = 256, sigma: float = 31.0 / 5.0):
    """BRIEF-style Gaussian point-pair pattern clipped to radius 13."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.float32)
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1.0
    return pts  # (256, 2, 2) — (pair, endpoint, xy)


_PATTERN = _brief_pattern()
_BIT_WEIGHTS = (2 ** np.arange(8)).astype(np.uint8)

_ATLAS_GAP = 8  # >= blur reach (3) + FAST ring (3) + NMS (1)
_PATCH = 46  # raw patch: BRIEF reach (19) + blur reach (3) = 22 each side
_PCTR = 22  # patch center index
_BLUR_CTR = _PCTR - 3  # center index inside the blurred patch


def level_budgets(params: OrbParams) -> Sequence[int]:
    """Geometric per-level feature budgets summing to n_features."""
    f = 1.0 / params.scale_factor
    n0 = params.n_features * (1 - f) / (1 - f**params.n_levels)
    budgets = [int(round(n0 * f**l)) for l in range(params.n_levels)]
    budgets[-1] = max(params.n_features - sum(budgets[:-1]), 8)
    return budgets


def _atlas_layout(H: int, W: int, params: OrbParams):
    """Static (offsets, sizes, atlas_H, atlas_W) of the stacked pyramid."""
    offs, sizes = [], []
    off = 0
    for lvl in range(params.n_levels):
        scale = params.scale_factor**lvl
        h = H if lvl == 0 else int(round(H / scale))
        w = W if lvl == 0 else int(round(W / scale))
        offs.append(off)
        sizes.append((h, w))
        off = ((off + h + _ATLAS_GAP) + CELL - 1) // CELL * CELL
    atlas_h = ((offs[-1] + sizes[-1][0]) + CELL - 1) // CELL * CELL
    atlas_w = (W + CELL - 1) // CELL * CELL
    return offs, sizes, atlas_h, atlas_w


def _ic_weights(psize: int, center: int):
    """Static (psize, psize) x/y moment masks of the radius-15 IC patch."""
    wx = np.zeros((psize, psize), np.float32)
    wy = np.zeros((psize, psize), np.float32)
    r = PATCH_RADIUS
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    mask = xs * xs + ys * ys <= r * r
    wx[center - r : center + r + 1, center - r : center + r + 1] = xs * mask
    wy[center - r : center + r + 1, center - r : center + r + 1] = ys * mask
    return wx, wy


def _blur_taps(sigma: float = 2.0) -> np.ndarray:
    xs = np.arange(-3, 4)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of `jax.image.resize(...,
    method="bilinear")` along one axis: the antialiased triangle kernel of
    `jax._src.image.scale.compute_weight_mat`, evaluated in float32 with the
    scale taken as a Python float, as JAX takes it."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class _Tables(NamedTuple):
    """Per-(image size, params, device) constants of `extract`."""

    resize: list  # per level > 0: (Wy (H,h), Wx (W,w)) float32
    inside: torch.Tensor  # (HA, WA) bool — FAST ring + descriptor reach
    slot_off: torch.Tensor  # (N,) float32 atlas row offset per slot
    slot_scale: torch.Tensor  # (N,) float32 level scale per slot
    octave: torch.Tensor  # (N,) int32
    wx: torch.Tensor  # (P, P) IC moment masks
    wy: torch.Tensor
    pattern_x: torch.Tensor  # (512,) BRIEF endpoints
    pattern_y: torch.Tensor
    bit_weights: torch.Tensor  # (8,) uint8 descriptor bit packing


@functools.lru_cache(maxsize=16)
def _tables(H: int, W: int, params: OrbParams, device: torch.device) -> _Tables:
    offs, sizes, HA, WA = _atlas_layout(H, W, params)
    budgets = level_budgets(params)
    resize = [None]
    for h, w in sizes[1:]:
        resize.append((
            torch.from_numpy(_resize_weights(H, h)).to(device),
            torch.from_numpy(_resize_weights(W, w)).to(device),
        ))
    b = EDGE_THRESHOLD
    inside = np.zeros((HA, WA), bool)
    for (h, w), o in zip(sizes, offs):
        inside[o + b : o + h - b, b : w - b] = True
    slot_lvl = np.concatenate([np.full(n, l) for l, n in enumerate(budgets)])
    wx, wy = _ic_weights(_PATCH, _PCTR)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return _Tables(
        resize=resize,
        inside=dev(inside),
        slot_off=dev(np.asarray(offs, np.float32)[slot_lvl]),
        slot_scale=dev(np.asarray(
            [np.float32(params.scale_factor**l) for l in range(params.n_levels)],
            np.float32)[slot_lvl]),
        octave=dev(slot_lvl.astype(np.int32)),
        wx=dev(wx), wy=dev(wy),
        pattern_x=dev(_PATTERN[:, :, 0].reshape(-1)),
        pattern_y=dev(_PATTERN[:, :, 1].reshape(-1)),
        bit_weights=dev(_BIT_WEIGHTS),
    )


# ---------------------------------------------------------------------------
# FAST + NMS: the plain version of kernel B2
# ---------------------------------------------------------------------------


def _arc9(bits: torch.Tensor) -> torch.Tensor:
    """Contiguous run >= 9 over the 16-cycle (int64 masks: CPU torch has no
    shifts on uint32)."""
    w = bits | (bits << 16)
    acc = w
    for j in range(1, 9):
        acc = acc & (w >> j)
    return (acc & 0xFFFF) != 0


def fast_score_nms_plain(img: torch.Tensor, min_th: float, ini_th: float):
    """Plain PyTorch version of kernel B2: the reference's
    `fast_score` + `_nms3` with zero padding at the border (the reference
    wraps with `jnp.roll` there; the extractor masks a 19 px border).
    Returns (score after NMS (H, W) f32, pass_ini (H, W) bool)."""
    H, W = img.shape
    pad = F.pad(img, (3, 3, 3, 3))
    ring = [pad[3 + int(dy) : 3 + int(dy) + H, 3 + int(dx) : 3 + int(dx) + W]
            for dx, dy in _FAST_OFFSETS]

    def is_corner(th):
        hi, lo = img + th, img - th
        bright = torch.zeros((H, W), dtype=torch.int64, device=img.device)
        dark = torch.zeros_like(bright)
        for i, r in enumerate(ring):
            bright |= (r > hi).to(torch.int64) << i
            dark |= (r < lo).to(torch.int64) << i
        return _arc9(bright) | _arc9(dark)

    sb = torch.zeros_like(img)
    sd = torch.zeros_like(img)
    for r in ring:
        sb = sb + torch.clamp(r - img - min_th, min=0.0)
        sd = sd + torch.clamp(img - r - min_th, min=0.0)
    is_min = is_corner(min_th)
    is_ini = is_corner(ini_th)
    score = torch.where(is_min, torch.maximum(sb, sd), torch.zeros_like(img))
    neigh = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= neigh, score, torch.zeros_like(score))
    return score, is_ini & is_min


# ---------------------------------------------------------------------------
# Selection, patches, angle, descriptor
# ---------------------------------------------------------------------------


def _select_level(score: torch.Tensor, pass_ini: torch.Tensor, budget: int, k_cell: int = 12):
    """Spatially balanced top-`budget` selection: per CELLxCELL cell the
    k_cell best, then all candidates ordered by (in-cell rank, -score)."""
    H, W = score.shape
    s = torch.where(score > 0, score + torch.where(pass_ini, 1e6, 0.0), 0.0)
    s = F.pad(s, (0, (-W) % CELL, 0, (-H) % CELL))
    Hc, Wc = s.shape
    ncy, ncx = Hc // CELL, Wc // CELL
    cells = s.reshape(ncy, CELL, ncx, CELL).permute(0, 2, 1, 3).reshape(-1, CELL * CELL)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_cell], idx[:, :k_cell]
    C = cells.shape[0]
    cell = torch.arange(C, device=s.device)
    y = (cell // ncx)[:, None] * CELL + idx // CELL
    x = (cell % ncx)[:, None] * CELL + idx % CELL
    rank = torch.arange(k_cell, dtype=torch.float32, device=s.device)[None].expand_as(vals)
    key = torch.where(vals > 0, rank * 1e8 - torch.clamp(vals, max=1e7), float("inf"))
    flat_key = key.reshape(-1)
    order = torch.sort(flat_key, stable=True).indices[:budget]
    sel_v = vals.reshape(-1)[order]
    resp = torch.where(sel_v > 5e5, sel_v - 1e6, sel_v)
    return (x.reshape(-1)[order].to(torch.float32), y.reshape(-1)[order].to(torch.float32),
            resp, torch.isfinite(flat_key[order]))


def _extract_patches(atlas: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor,
                     psize: int, center: int) -> torch.Tensor:
    """(N, psize, psize) patches, patch[n, p, q] = atlas[yi+p-c, xi+q-c];
    out-of-range rows and columns read as 0."""
    HA, WA = atlas.shape
    off = torch.arange(psize, device=atlas.device) - center
    ri = yi.to(torch.int64)[:, None] + off[None]
    ci = xi.to(torch.int64)[:, None] + off[None]
    ok = ((ri >= 0) & (ri < HA))[:, :, None] & ((ci >= 0) & (ci < WA))[:, None, :]
    vals = atlas[ri.clamp(0, HA - 1)[:, :, None], ci.clamp(0, WA - 1)[:, None, :]]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _blur_patches(patch: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian over the patch interior, (N, P, P) ->
    (N, P-6, P-6), taps summed in the reference's order."""
    k = _blur_taps()
    P = patch.shape[-1]
    n = P - 6
    t = float(k[0]) * patch[:, :, 0:n]
    for i in range(1, 7):
        t = t + float(k[i]) * patch[:, :, i : i + n]
    out = float(k[0]) * t[:, 0:n, :]
    for i in range(1, 7):
        out = out + float(k[i]) * t[:, i : i + n, :]
    return out


def _brief_from_patches(pblur: torch.Tensor, angle: torch.Tensor, tab: _Tables) -> torch.Tensor:
    """Steered BRIEF on blurred patches: rotated, rounded pattern offsets,
    each sample the blurred value rounded to bfloat16 (as the reference's
    bf16 one-hot contraction reads it). -> (N, 32) uint8."""
    N = pblur.shape[0]
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = tab.pattern_x[None], tab.pattern_y[None]
    rx = ca[:, None] * px - sa[:, None] * py  # (N, 512)
    ry = sa[:, None] * px + ca[:, None] * py
    xi = torch.round(rx).to(torch.int64) + _BLUR_CTR
    yi = torch.round(ry).to(torch.int64) + _BLUR_CTR
    pb = pblur.to(torch.bfloat16).to(torch.float32)
    n = torch.arange(N, device=pblur.device)[:, None]
    vals = pb[n, yi, xi].reshape(N, 256, 2)
    bits = (vals[:, :, 0] < vals[:, :, 1]).to(torch.uint8).reshape(N, 32, 8)
    return (bits * tab.bit_weights).sum(-1).to(torch.uint8)


def build_atlas(image: torch.Tensor, params: OrbParams) -> torch.Tensor:
    """(HA, WA) float32 atlas of the integer-rounded pyramid levels."""
    H, W = image.shape
    offs, sizes, HA, WA = _atlas_layout(H, W, params)
    tab = _tables(H, W, params, image.device)
    atlas = torch.zeros((HA, WA), dtype=torch.float32, device=image.device)
    for lvl, ((h, w), o) in enumerate(zip(sizes, offs)):
        if lvl == 0:
            lvl_img = image
        else:
            # This association order rounds closest to JAX's einsum (ROADMAP C1).
            Wy, Wx = tab.resize[lvl]
            lvl_img = (Wy.T @ image) @ Wx
        atlas[o : o + h, :w] = torch.round(lvl_img)  # the reference's pyramid is uint8
    return atlas


def extract_from_atlas(atlas: torch.Tensor, H: int, W: int, params: OrbParams) -> Features:
    """Everything of `extract` after the atlas is built: FAST + NMS (kernel
    B2 on CUDA), balanced selection, patches, angle, blur, BRIEF."""
    from orbslam3_tpu_torch.ops import cuda_fast  # lazy: cuda_fast imports this module

    budgets = level_budgets(params)
    offs, sizes, HA, WA = _atlas_layout(H, W, params)
    tab = _tables(H, W, params, atlas.device)

    with spans.span("extract/fast_nms"):
        score, pass_ini = cuda_fast.fast_score_nms(atlas, params.min_th, params.ini_th)
        score = torch.where(tab.inside, score, torch.zeros_like(score))

    with spans.span("extract/select"):
        xs, ys, resps, valids = [], [], [], []
        for lvl, ((h, w), o) in enumerate(zip(sizes, offs)):
            hs = (h + CELL - 1) // CELL * CELL  # gap rows are zero-score
            x, y, resp, valid = _select_level(score[o : o + hs], pass_ini[o : o + hs],
                                              budgets[lvl])
            xs.append(x)
            ys.append(y + float(o))  # atlas coords
            resps.append(resp)
            valids.append(valid)
        xa, ya = torch.cat(xs), torch.cat(ys)

    with spans.span("extract/describe"):
        patch = _extract_patches(atlas, xa.to(torch.int64), ya.to(torch.int64), _PATCH, _PCTR)
        m10 = torch.einsum("npq,pq->n", patch, tab.wx)
        m01 = torch.einsum("npq,pq->n", patch, tab.wy)
        ang = torch.atan2(m01, m10)
        desc = _brief_from_patches(_blur_patches(patch), ang, tab)

        uv0 = torch.stack([xa, ya - tab.slot_off], dim=-1) * tab.slot_scale[:, None]
        return Features(uv=uv0, response=torch.cat(resps), octave=tab.octave,
                        angle=ang, desc=desc, valid=torch.cat(valids))


def extract(image: torch.Tensor, params: OrbParams = OrbParams()) -> Features:
    """ORB features of a grayscale float32 image (H, W), values 0..255, on
    the image's device."""
    H, W = image.shape
    with spans.span("extract/atlas"):
        atlas = build_atlas(image, params)
    return extract_from_atlas(atlas, H, W, params)


def scale_factors(params: OrbParams) -> np.ndarray:
    return params.scale_factor ** np.arange(params.n_levels, dtype=np.float32)


def sigma2(params: OrbParams) -> np.ndarray:
    """Per-octave measurement variance."""
    return scale_factors(params) ** 2
