"""Stereo rectification: raw (unrectified) pinhole stereo on the device —
the port of `orbslam3_tpu/ops/rectify.py` (the reference's LEFT./RIGHT.
K/D/R/P blocks, `cv::initUndistortRectifyMap` and the per-frame
`cv::remap`).

`build_rectify_map` runs once, on the host, in numpy: the port keeps its
own copy of the reference's function (it imports nothing of the JAX
package), held bit-equal to it by `tests/test_torch_rectify.py`.
`remap_bilinear` is one gather pass on the device per image.
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import convert


def build_rectify_map(K, D, R, P, wh):
    """Remap grid with `cv::initUndistortRectifyMap` semantics: for each
    rectified pixel, back-project through P's left 3x3 block, rotate into
    the original camera with R^-1, apply the radial-tangential distortion
    D = (k1, k2, p1, p2[, k3]) and project through K. Returns (map_x, map_y)
    float32 (H, W): the source pixel of each output pixel."""
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    D = np.asarray(D, np.float64).reshape(-1)
    W, H = int(wh[0]), int(wh[1])
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    X = np.stack([x, y, np.ones_like(x)], axis=-1) @ R  # rows = R^T @ ray
    xp = X[..., 0] / X[..., 2]
    yp = X[..., 1] / X[..., 2]
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if D.shape[0] > 4 else 0.0
    r2 = xp * xp + yp * yp
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = xp * rad + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    yd = yp * rad + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """`cv::remap(..., INTER_LINEAR, BORDER_CONSTANT 0)`: out[v, u] is the
    bilinear sample of `img` at (map_x[v, u], map_y[v, u]), 0 where the
    sample lies outside the image; float32 (H, W) on `img`'s device."""
    img = img.to(torch.float32)
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    wx = map_x - x0
    wy = map_y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    out = ((img[y0i, x0i] * (1 - wx) + img[y0i, x1i] * wx) * (1 - wy)
           + (img[y1i, x0i] * (1 - wx) + img[y1i, x1i] * wx) * wy)
    inside = (map_x >= 0) & (map_x <= W - 1) & (map_y >= 0) & (map_y <= H - 1)
    return torch.where(inside, out, torch.zeros_like(out))


class StereoRectifier:
    """The two sides' grids on `device`; calling it remaps a raw left/right
    pair there."""

    def __init__(self, rect_left, rect_right, device):
        """Each side: any object with K (3,3), D (4 or 5,), R (3,3), P (3,3
        or 3,4), width and height (the reference's LEFT./RIGHT. block)."""
        self.maps = []
        for side in (rect_left, rect_right):
            mx, my = build_rectify_map(side.K, side.D, side.R, side.P, (side.width, side.height))
            self.maps.append((convert.tensor(mx, device), convert.tensor(my, device)))
        self.device = torch.device(device)

    def __call__(self, img_left, img_right):
        """(left, right) float32 tensors on the device; numpy images are
        uploaded as float32 first."""
        out = []
        for img, (mx, my) in zip((img_left, img_right), self.maps):
            if not isinstance(img, torch.Tensor):
                img = convert.tensor(img, self.device, torch.float32)
            out.append(remap_bilinear(img, mx, my))
        return tuple(out)
