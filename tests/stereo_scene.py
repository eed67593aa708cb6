"""The small stereo scene of `scripts/drive_slam_stereo.py`, in numpy, for the
port's stereo and RGB-D parity tests: 130 squares with four random
quadrant shades at 3-6 m in front of a flat grey background, rendered 3x
supersampled at 320x240 (focal 260 px, baseline 0.12 m), along the
script's 16-frame path (1.6 m sideways, 0.5 m forward, a 0.05 rad yaw).
Images are rounded to whole grey levels, as a camera's 8-bit output.
`depth` is the z-depth of the square under each pixel's centre sample and
0 on the background (no measurement)."""

from __future__ import annotations

import numpy as np

H, W = 240, 320
FOCAL = 260.0
BASELINE = 0.12
BF = FOCAL * BASELINE
SS = 3
N_FRAMES = 16
PARAMS = np.array([FOCAL, FOCAL, W / 2, H / 2, 0.0, 0.0, 0.0, 0.0], np.float32)


def make_world(seed: int = 5):
    rng = np.random.default_rng(seed)
    n = 130
    pts = np.stack([rng.uniform(-3.0, 3.0, n), rng.uniform(-2.2, 2.2, n),
                    rng.uniform(3.0, 6.0, n)], axis=-1).astype(np.float32)
    shades = rng.uniform(50, 250, (n, 2, 2)).astype(np.float32)
    return pts, shades


def camera_path(n_frames: int = N_FRAMES):
    """(Rcw, tcw) per frame."""
    poses = []
    for k in range(n_frames):
        s = k / (n_frames - 1)
        c, sn = np.cos(-0.05 * s), np.sin(-0.05 * s)
        Rcw = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]], np.float32)
        centre = np.array([1.6 * s, 0.15 * np.sin(4 * s), 0.5 * s], np.float32)
        poses.append((Rcw, (-Rcw @ centre).astype(np.float32)))
    return poses


def render(Rcw, tcw, pts, shades, with_depth: bool = False):
    """(H, W) float32 image, and with `with_depth` its depth map."""
    img = np.full((H * SS, W * SS), 35.0, np.float32)
    dep = np.zeros((H * SS, W * SS), np.float32)
    Xc = pts @ Rcw.T + tcw
    f = FOCAL * SS
    uv = Xc[:, :2] / Xc[:, 2:3] * f + np.array([W * SS / 2, H * SS / 2], np.float32)
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.5:
            continue
        u, v = uv[i]
        half = max(3 * SS, int(round(12.0 / Xc[i, 2] * 2 * SS)))
        ui, vi = int(round(u)), int(round(v))
        if not (1 <= ui < W * SS - 1 and 1 <= vi < H * SS - 1):
            continue
        for qy in (0, 1):
            for qx in (0, 1):
                y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                ys = slice(max(y0, 0), min(y1, H * SS))
                xs = slice(max(x0, 0), min(x1, W * SS))
                img[ys, xs] = shades[i, qy, qx]
                dep[ys, xs] = Xc[i, 2]
    img = np.round(img.reshape(H, SS, W, SS).mean(axis=(1, 3)))
    return (img, dep[SS // 2::SS, SS // 2::SS].copy()) if with_depth else img


def stereo_frames(n_frames: int = N_FRAMES):
    """(left images, right images, depth maps, camera centres), one per frame."""
    pts, shades = make_world()
    left, right, depth, centres = [], [], [], []
    for R, t in camera_path(n_frames):
        img, dep = render(R, t, pts, shades, with_depth=True)
        left.append(img)
        depth.append(dep)
        right.append(render(R, t - np.array([BASELINE, 0, 0], np.float32), pts, shades))
        centres.append(-R.T @ t)
    return left, right, depth, np.stack(centres)
