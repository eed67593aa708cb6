"""A short, narrow stereo-inertial sequence for the port's stereo-inertial
`System` parity tests: config 4's room and path of `scripts/make_synth_euroc.py
--fisheye` (its textured 7 x 7 x 3 m box, the 1.4 m circle at 1.3 m height
with a 40 s lap), seen by a 256x256 Kannala-Brandt 8 pair (config 4's
cameras at half resolution, 0.15 m apart) or a 320x240 rectified pinhole
pair (focal 200 px, 0.11 m apart), frames at 10 Hz, and the script's ideal
200 Hz IMU samples (`imu_sample`: no noise, no bias), numpy only."""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch import entry as E

CAM_HZ = 10.0
IMU_HZ = 200.0
NOISE = dict(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, freq=IMU_HZ)
FE_WH = (256, 256)
FE_BASELINE = 0.15
PIN_WH = (320, 240)
PIN_FOCAL = 200.0
PIN_BASELINE = 0.11
PIN_PARAMS = np.array([PIN_FOCAL, PIN_FOCAL, 160.0, 120.0, 0, 0, 0, 0], np.float32)
PIN_BF = PIN_FOCAL * PIN_BASELINE


def _half(intr):
    """Config 4's intrinsics for the half-resolution image."""
    fx, fy, cx, cy = intr[:4]
    return np.array([fx / 2, fy / 2, (cx + 0.5) / 2 - 0.5, (cy + 0.5) / 2 - 0.5, *intr[4:]],
                    np.float32)


def fisheye_rig():
    """(left params, (right params, Tlr, lap1, lap2)) of the half-size pair."""
    cfg = E.EUROC_STEREO_VI_FISHEYE
    params2, Tlr, _, _ = cfg["camera2"]
    return _half(cfg["camera"]), (_half(params2), Tlr, (0.0, 255.0), (0.0, 255.0))


def frames(n_frames: int, fisheye: bool = True, seed: int = 0):
    """(timestamps (n,), left (n, H, W) float32, right (n, H, W) float32,
    camera centres (n, 3), per-frame IMU batches), rendered through the
    loaded script with the --fisheye room."""
    M = E.synth_euroc()
    M.BOX_LO = np.array([-3.5, -3.5, 0.0])
    M.BOX_HI = np.array([3.5, 3.5, 3.0])
    M.TRAJ_R, M.TRAJ_Z, M.T_LOOP = 1.4, 1.3, 40.0
    tex = M.make_textures(np.random.default_rng(seed))
    if fisheye:
        pl, (pr, Tlr, _, _) = fisheye_rig()
        dl, dr = (M.kb8_dir_grid(FE_WH, tuple(p)) for p in (pl, pr))
        base = FE_BASELINE
    else:
        u, v = np.meshgrid(np.arange(PIN_WH[0], dtype=np.float32),
                           np.arange(PIN_WH[1], dtype=np.float32))
        f, cx, cy = PIN_FOCAL, PIN_PARAMS[2], PIN_PARAMS[3]
        dl = dr = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], axis=-1)
        base = PIN_BASELINE
    ts, left, right, centres = [], [], [], []
    for k in range(n_frames):
        t = k / CAM_HZ
        R_wc, p = M.pose_at(t)
        left.append(np.round(M.render(tex, R_wc, p, dirs=dl)))
        right.append(np.round(M.render(tex, R_wc, p + R_wc @ np.array([base, 0.0, 0.0]),
                                       dirs=dr)))
        ts.append(t)
        centres.append(p)
    n_imu = int(round((n_frames - 1) / CAM_HZ * IMU_HZ)) + 1
    t_imu = np.arange(n_imu) / IMU_HZ
    samples = [M.imu_sample(t) for t in t_imu]
    gyro = np.stack([g for g, _ in samples])
    acc = np.stack([a for _, a in samples])
    ts = np.asarray(ts)
    return (ts, np.stack(left).astype(np.float32), np.stack(right).astype(np.float32),
            np.asarray(centres), E.imu_batches(ts, (t_imu, acc, gyro)))
