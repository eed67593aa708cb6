"""The monocular-inertial scene of `scripts/drive_slam_vi.py`, in numpy, for
the port's inertial `System` parity test: 130 shaded squares at 3-6 m
before a dark background, rendered at 320x240 (focal 260 px) from a body
(= camera) flying the script's smooth path, frames at 10 Hz, and the
script's IMU synthesis: 200 Hz samples from finite differences of the
analytic path on a 2 kHz grid, gravity -z, no noise and no bias."""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.entry import imu_batches

H, W = 240, 320
FOCAL = 260.0
PARAMS = np.array([FOCAL, FOCAL, W / 2, H / 2, 0.0, 0.0, 0.0, 0.0], np.float32)
IMU_HZ = 200.0
CAM_HZ = 10.0
GRAVITY = np.array([0.0, 0.0, -9.81])
NOISE = dict(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, freq=IMU_HZ)


def _exp_so3(w):
    th = np.linalg.norm(w)
    W_ = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-8:
        return np.eye(3) + W_
    return np.eye(3) + np.sin(th) / th * W_ + (1 - np.cos(th)) / th**2 * W_ @ W_


def _log_so3(R):
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * v if th < 1e-8 else th / (2 * np.sin(th)) * v


def make_world(seed: int = 11):
    rng = np.random.default_rng(seed)
    n = 130
    pts = np.stack([rng.uniform(-3.0, 3.0, n), rng.uniform(-2.2, 2.2, n),
                    rng.uniform(3.0, 6.0, n)], axis=-1).astype(np.float32)
    return pts, rng.uniform(120, 250, n).astype(np.float32)


def body_pose(t):
    """(R_wb, p_wb) of the script's path."""
    p = np.array([0.9 * np.sin(1.6 * t), 0.3 * np.sin(2.6 * t), 0.4 * (1 - np.cos(1.9 * t))])
    w = np.array([0.0, 0.10 * np.sin(0.8 * t), 0.05 * np.sin(0.5 * t)])
    return _exp_so3(w), p


def render(world, Rcw, tcw):
    pts, shades = world
    img = np.full((H, W), 35.0, np.float32)
    Xc = pts @ Rcw.T + tcw
    u = FOCAL * Xc[:, 0] / Xc[:, 2] + W / 2
    v = FOCAL * Xc[:, 1] / Xc[:, 2] + H / 2
    for i in np.argsort(-Xc[:, 2]):
        if Xc[i, 2] < 0.5:
            continue
        half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
        ui, vi = int(round(u[i])), int(round(v[i]))
        if 1 <= ui < W - 1 and 1 <= vi < H - 1:
            img[max(vi - half, 0) : vi + half, max(ui - half, 0) : ui + half] = shades[i]
    return img


def imu_stream(t_total: float):
    """(t (m,), acc (m, 3), gyro (m, 3)): the script's synthesis."""
    fine_dt = 1.0 / 2000.0
    ts = np.arange(0.0, t_total + 2 * fine_dt, fine_dt)
    poses = [body_pose(t) for t in ts]
    Rs = np.stack([R for R, _ in poses])
    ps = np.stack([p for _, p in poses])
    acc_w = (ps[2:] - 2 * ps[1:-1] + ps[:-2]) / fine_dt**2
    gyro_b = np.stack([_log_so3(Rs[i].T @ Rs[i + 1]) / fine_dt for i in range(len(ts) - 1)])
    idx = np.arange(1, len(ts) - 1, int(round(2000 / IMU_HZ)))
    acc = np.stack([Rs[i].T @ (acc_w[i - 1] - GRAVITY) for i in idx])
    return ts[idx], acc, gyro_b[idx]


def frames(n_frames: int, t0: float = 0.0):
    """(timestamps, images, camera centres, per-frame IMU batches) of
    `n_frames` frames from time `t0`; the first frame's batch holds every
    sample from time 0."""
    world = make_world()
    t_frames = t0 + np.arange(n_frames) / CAM_HZ
    imu = imu_stream(t_frames[-1] + 0.01)
    imgs, centres = [], []
    for t in t_frames:
        R_wb, p_wb = body_pose(t)
        imgs.append(render(world, R_wb.T.astype(np.float32),
                           (-R_wb.T @ p_wb).astype(np.float32)))
        centres.append(p_wb)
    return t_frames, np.stack(imgs), np.stack(centres), imu_batches(t_frames, imu)
