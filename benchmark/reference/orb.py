"""Plain ORB extraction: a frozen copy of the arithmetic of the port's plain
path (`ops/features.py`: the pyramid atlas, FAST-9/16 + score + 3x3 NMS,
the per-cell balanced selection, the 46x46 patches, the IC angle, the 7-tap
blur and steered BRIEF on bfloat16-rounded samples).

Float32 matmuls run with TF32 off, as the configuration states: `extract`
switches it off for its own call and restores the caller's setting (the
precision control runs the program with TF32 on). Plain PyTorch only.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

EDGE_THRESHOLD = 19
PATCH_RADIUS = 15
CELL = 32
_ATLAS_GAP = 8
_PATCH = 46
_PCTR = 22
_BLUR_CTR = _PCTR - 3

_FAST_OFFSETS = np.array(
    [(0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
     (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3)],
    dtype=np.int32)


class Orb(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0


class Keypoints(NamedTuple):
    uv: torch.Tensor  # (N, 2) float32, level-0 pixels
    response: torch.Tensor  # (N,)
    octave: torch.Tensor  # (N,) int32
    angle: torch.Tensor  # (N,) radians
    desc: torch.Tensor  # (N, 32) uint8
    valid: torch.Tensor  # (N,) bool


def _brief_pattern(seed: int = 42, n_pairs: int = 256, sigma: float = 31.0 / 5.0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, sigma, size=(n_pairs, 2, 2))
    pts = np.clip(np.round(pts), -13, 13).astype(np.float32)
    same = np.all(pts[:, 0] == pts[:, 1], axis=-1)
    pts[same, 1, 0] += 1.0
    return pts


_PATTERN = _brief_pattern()
_BIT_WEIGHTS = (2 ** np.arange(8)).astype(np.uint8)


def level_budgets(p: Orb):
    f = 1.0 / p.scale_factor
    n0 = p.n_features * (1 - f) / (1 - f**p.n_levels)
    budgets = [int(round(n0 * f**lvl)) for lvl in range(p.n_levels)]
    budgets[-1] = max(p.n_features - sum(budgets[:-1]), 8)
    return budgets


def _layout(H: int, W: int, p: Orb):
    offs, sizes, off = [], [], 0
    for lvl in range(p.n_levels):
        scale = p.scale_factor**lvl
        h = H if lvl == 0 else int(round(H / scale))
        w = W if lvl == 0 else int(round(W / scale))
        offs.append(off)
        sizes.append((h, w))
        off = ((off + h + _ATLAS_GAP) + CELL - 1) // CELL * CELL
    return offs, sizes, ((offs[-1] + sizes[-1][0]) + CELL - 1) // CELL * CELL


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """Antialiased triangle weights of a bilinear resize along one axis,
    evaluated in float32 with the scale taken as a Python float."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=4)
def _tables(H: int, W: int, p: Orb, device: torch.device):
    offs, sizes, HA = _layout(H, W, p)
    budgets = level_budgets(p)
    resize = [None] + [(torch.from_numpy(_resize_weights(H, h)).to(device),
                        torch.from_numpy(_resize_weights(W, w)).to(device)) for h, w in sizes[1:]]
    WA = (W + CELL - 1) // CELL * CELL
    b = EDGE_THRESHOLD
    inside = np.zeros((HA, WA), bool)
    for (h, w), o in zip(sizes, offs):
        inside[o + b: o + h - b, b: w - b] = True
    slot_lvl = np.concatenate([np.full(n, lvl) for lvl, n in enumerate(budgets)])
    r = PATCH_RADIUS
    wx = np.zeros((_PATCH, _PATCH), np.float32)
    wy = np.zeros((_PATCH, _PATCH), np.float32)
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = xs * xs + ys * ys <= r * r
    wx[_PCTR - r: _PCTR + r + 1, _PCTR - r: _PCTR + r + 1] = xs * mask
    wy[_PCTR - r: _PCTR + r + 1, _PCTR - r: _PCTR + r + 1] = ys * mask

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(
        resize=resize, inside=dev(inside), HA=HA, WA=WA,
        slot_off=dev(np.asarray(offs, np.float32)[slot_lvl]),
        slot_scale=dev(np.asarray([np.float32(p.scale_factor**lvl)
                                   for lvl in range(p.n_levels)], np.float32)[slot_lvl]),
        octave=dev(slot_lvl.astype(np.int32)), wx=dev(wx), wy=dev(wy),
        px=dev(_PATTERN[:, :, 0].reshape(-1)), py=dev(_PATTERN[:, :, 1].reshape(-1)),
        bits=dev(_BIT_WEIGHTS))


def _arc9(bits: torch.Tensor) -> torch.Tensor:
    w = bits | (bits << 16)
    acc = w
    for j in range(1, 9):
        acc = acc & (w >> j)
    return (acc & 0xFFFF) != 0


def fast_score_nms(img: torch.Tensor, min_th: float, ini_th: float):
    """FAST-9/16 with its score and a 3x3 non-maximum suppression, zero
    padding at the border: (score (H, W) f32, pass_ini (H, W) bool)."""
    H, W = img.shape
    pad = F.pad(img, (3, 3, 3, 3))
    ring = [pad[3 + int(dy): 3 + int(dy) + H, 3 + int(dx): 3 + int(dx) + W]
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


def _select(score, pass_ini, budget: int, k_cell: int = 12):
    H, W = score.shape
    s = torch.where(score > 0, score + torch.where(pass_ini, 1e6, 0.0), 0.0)
    s = F.pad(s, (0, (-W) % CELL, 0, (-H) % CELL))
    Hc, Wc = s.shape
    ncy, ncx = Hc // CELL, Wc // CELL
    cells = s.reshape(ncy, CELL, ncx, CELL).permute(0, 2, 1, 3).reshape(-1, CELL * CELL)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k_cell], idx[:, :k_cell]
    cell = torch.arange(cells.shape[0], device=s.device)
    y = (cell // ncx)[:, None] * CELL + idx // CELL
    x = (cell % ncx)[:, None] * CELL + idx % CELL
    rank = torch.arange(k_cell, dtype=torch.float32, device=s.device)[None].expand_as(vals)
    key = torch.where(vals > 0, rank * 1e8 - torch.clamp(vals, max=1e7), float("inf"))
    flat = key.reshape(-1)
    order = torch.sort(flat, stable=True).indices[:budget]
    sel = vals.reshape(-1)[order]
    resp = torch.where(sel > 5e5, sel - 1e6, sel)
    return (x.reshape(-1)[order].to(torch.float32), y.reshape(-1)[order].to(torch.float32),
            resp, torch.isfinite(flat[order]))


def _patches(atlas, xi, yi):
    HA, WA = atlas.shape
    off = torch.arange(_PATCH, device=atlas.device) - _PCTR
    ri = yi.to(torch.int64)[:, None] + off[None]
    ci = xi.to(torch.int64)[:, None] + off[None]
    ok = ((ri >= 0) & (ri < HA))[:, :, None] & ((ci >= 0) & (ci < WA))[:, None, :]
    vals = atlas[ri.clamp(0, HA - 1)[:, :, None], ci.clamp(0, WA - 1)[:, None, :]]
    return torch.where(ok, vals, torch.zeros_like(vals))


def _blur(patch):
    xs = np.arange(-3, 4)
    k = np.exp(-(xs**2) / (2 * 2.0**2))
    k = (k / k.sum()).astype(np.float32)
    n = patch.shape[-1] - 6
    t = float(k[0]) * patch[:, :, 0:n]
    for i in range(1, 7):
        t = t + float(k[i]) * patch[:, :, i: i + n]
    out = float(k[0]) * t[:, 0:n, :]
    for i in range(1, 7):
        out = out + float(k[i]) * t[:, i: i + n, :]
    return out


def _brief(pblur, angle, tab):
    N = pblur.shape[0]
    ca, sa = torch.cos(angle), torch.sin(angle)
    px, py = tab["px"][None], tab["py"][None]
    rx = ca[:, None] * px - sa[:, None] * py
    ry = sa[:, None] * px + ca[:, None] * py
    xi = torch.round(rx).to(torch.int64) + _BLUR_CTR
    yi = torch.round(ry).to(torch.int64) + _BLUR_CTR
    pb = pblur.to(torch.bfloat16).to(torch.float32)
    n = torch.arange(N, device=pblur.device)[:, None]
    vals = pb[n, yi, xi].reshape(N, 256, 2)
    bits = (vals[:, :, 0] < vals[:, :, 1]).to(torch.uint8).reshape(N, 32, 8)
    return (bits * tab["bits"]).sum(-1).to(torch.uint8)


def extract(image: torch.Tensor, p: Orb = Orb()) -> Keypoints:
    """ORB keypoints of a grey float32 image (H, W), values 0..255."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _extract(image, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _extract(image, p):
    H, W = image.shape
    offs, sizes, HA = _layout(H, W, p)
    tab = _tables(H, W, p, image.device)
    atlas = torch.zeros((HA, tab["WA"]), dtype=torch.float32, device=image.device)
    for lvl, ((h, w), o) in enumerate(zip(sizes, offs)):
        if lvl == 0:
            lvl_img = image
        else:
            Wy, Wx = tab["resize"][lvl]
            lvl_img = (Wy.T @ image) @ Wx
        atlas[o: o + h, :w] = torch.round(lvl_img)
    score, pass_ini = fast_score_nms(atlas, p.min_th, p.ini_th)
    score = torch.where(tab["inside"], score, torch.zeros_like(score))
    xs, ys, resps, valids = [], [], [], []
    for lvl, ((h, w), o) in enumerate(zip(sizes, offs)):
        hs = (h + CELL - 1) // CELL * CELL
        x, y, resp, valid = _select(score[o: o + hs], pass_ini[o: o + hs],
                                    level_budgets(p)[lvl])
        xs.append(x)
        ys.append(y + float(o))
        resps.append(resp)
        valids.append(valid)
    xa, ya = torch.cat(xs), torch.cat(ys)
    patch = _patches(atlas, xa.to(torch.int64), ya.to(torch.int64))
    m10 = torch.einsum("npq,pq->n", patch, tab["wx"])
    m01 = torch.einsum("npq,pq->n", patch, tab["wy"])
    ang = torch.atan2(m01, m10)
    desc = _brief(_blur(patch), ang, tab)
    uv0 = torch.stack([xa, ya - tab["slot_off"]], dim=-1) * tab["slot_scale"][:, None]
    return Keypoints(uv=uv0, response=torch.cat(resps), octave=tab["octave"], angle=ang,
                     desc=desc, valid=torch.cat(valids))
