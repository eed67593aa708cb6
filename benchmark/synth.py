"""Frozen copy of the synthetic EuRoC generator (`scripts/make_synth_euroc.py`
and the frame and noise order of `orbslam3_tpu_torch.entry.euroc_frames`).

A closed textured room, 12 x 12 x 4 m, ray-cast by an ideal 752x480
pinhole at 20 Hz along a circle of radius 2.5 m (one lap every `t_loop`
seconds, 60 by default) with bobbing, radial pumping and a small attitude
wobble; a 200 Hz IMU derived from the same analytic trajectory with
EuRoC-grade white noise and constant biases.

Every recording shows the room that the generator draws for seed 0
(`ROOM_SEED`), as one scene is recorded again and again; the seed draws the
sensor and IMU noise. The order of draws from
`numpy.random.default_rng(seed)` is the generator's: the six face textures
(which only advance the stream), then per frame the image noise (N(0, 1.5)
grey levels; a pair's left image, then its right) in frame order, then,
after the last frame, per IMU sample its gyro noise and then its acc noise.
A traffic mix may add the generator's events: a kidnap (later frames show
an earlier stretch of the lap) and a blind interval (a covered lens).
`benchmark/tests/test_frozen.py` holds this copy equal to
`euroc_frames(..., seed=0)` on both laps, for a rectified pair, a kidnap
and a blind interval.

Only numpy. Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np

W, H = 752, 480
FX = FY = 458.0
CX, CY = 376.0, 240.0
CAM_HZ = 20.0
IMU_HZ = 200.0
G = 9.81

BOX_LO = np.array([-6.0, -6.0, 0.0])
BOX_HI = np.array([6.0, 6.0, 4.0])
TEX_N = 2048  # texels per face
RENDER_THREADS = 8  # threads that ray-cast a recording's views

T_LOOP = 60.0
TRAJ_R = 2.5
TRAJ_Z = 1.5

# The IMU's constant biases (body frame = camera frame, Tbc = I) and white
# noise densities.
BIAS_G = np.array([0.002, -0.0015, 0.001])
BIAS_A = np.array([0.02, 0.015, -0.01])
NOISE_GYRO = 1.7e-4
NOISE_ACC = 2.0e-3

# Face parametrization: (axis, sign); axis = fixed coordinate.
FACES = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]

SETTINGS_YAML = f"""%YAML:1.0
# Synthetic EuRoC-format sequence (generated by make_synth_euroc.py)
Camera.type: "PinHole"
Camera.fx: {FX}
Camera.fy: {FY}
Camera.cx: {CX}
Camera.cy: {CY}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {W}
Camera.height: {H}
Camera.fps: {CAM_HZ}
Camera.RGB: 1
Tbc: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0,
          0.0, 1.0, 0.0, 0.0,
          0.0, 0.0, 1.0, 0.0,
          0.0, 0.0, 0.0, 1.0]
IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


BLOCKS = ((160, 60), (80, 240), (40, 700), (18, 1600))  # (size, count) of a face's blocks
ROOM_SEED = 0  # every recording is of the room the generator draws for seed 0


def texture_draws(rng, density: float = 1.0) -> list:
    """The draws of `make_textures` from `rng`, in its order: per face the
    8x8 illumination, then per block scale the rows, columns and values."""
    faces = []
    for _ in range(6):
        g = rng.uniform(-25, 25, (8, 8)).astype(np.float32)
        blocks = []
        for size, count in BLOCKS:
            count = max(1, int(round(count * density)))
            ys = rng.integers(0, TEX_N - size, count)
            xs = rng.integers(0, TEX_N - size, count)
            blocks.append((size, ys, xs, rng.uniform(30, 235, count).astype(np.float32)))
        faces.append((g, blocks))
    return faces


def make_textures(rng, density: float = 1.0):
    """Six face textures: mid-grey base, low-frequency illumination and
    random high-contrast blocks at four scales; `density` scales the block
    counts."""
    tex = []
    gi = np.clip((np.arange(TEX_N) * 8 // TEX_N), 0, 7)
    for g, blocks in texture_draws(rng, density):
        t = np.full((TEX_N, TEX_N), 128.0, np.float32)
        t += g[np.ix_(gi, gi)]
        for size, ys, xs, vals in blocks:
            for y, x, v in zip(ys, xs, vals):
                t[y: y + size, x: x + size] = v
        tex.append(np.clip(t, 0, 255))
    return np.stack(tex)  # (6, TEX_N, TEX_N)


def render(tex, R_wc, p_wc, wh=(W, H), intr=(FX, FY, CX, CY)):
    """Ray-cast the box: grey (H, W) float32 image, bilinear texture
    sampling, perspective-correct."""
    W_, H_ = wh
    fx, fy, cx, cy = intr
    u, v = np.meshgrid(np.arange(W_, dtype=np.float32), np.arange(H_, dtype=np.float32))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    d_w = d_cam @ R_wc.T  # (H, W, 3)
    o = p_wc.astype(np.float32)

    best_t = np.full((H_, W_), np.inf, np.float32)
    best_face = np.full((H_, W_), -1, np.int8)
    for f, (ax, hi) in enumerate(FACES):
        bound = (BOX_HI if hi else BOX_LO)[ax]
        denom = d_w[..., ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (bound - o[ax]) / denom
        ok = (t > 1e-3) & np.isfinite(t) & (t < best_t)
        best_t = np.where(ok, t, best_t)
        best_face = np.where(ok, np.int8(f), best_face)

    img = np.zeros((H_, W_), np.float32)
    hit_pts = o[None, None] + best_t[..., None] * d_w
    for f, (ax, hi) in enumerate(FACES):
        m = best_face == f
        if not m.any():
            continue
        axes = [a for a in range(3) if a != ax]
        pu = hit_pts[..., axes[0]][m]
        pv = hit_pts[..., axes[1]][m]
        su = (pu - BOX_LO[axes[0]]) / (BOX_HI[axes[0]] - BOX_LO[axes[0]])
        sv = (pv - BOX_LO[axes[1]]) / (BOX_HI[axes[1]] - BOX_LO[axes[1]])
        x = np.clip(su * (TEX_N - 1), 0, TEX_N - 1.001)
        y = np.clip(sv * (TEX_N - 1), 0, TEX_N - 1.001)
        x0, y0 = x.astype(np.int32), y.astype(np.int32)
        fx_, fy_ = x - x0, y - y0
        T = tex[f]
        val = (T[y0, x0] * (1 - fx_) * (1 - fy_) + T[y0, x0 + 1] * fx_ * (1 - fy_)
               + T[y0 + 1, x0] * (1 - fx_) * fy_ + T[y0 + 1, x0 + 1] * fx_ * fy_)
        img[m] = val
    return img


def pose_at(t, t_loop: float = T_LOOP):
    """The analytic trajectory at time t: (R_wc, p_w). Camera z forward, x
    right, y down; Tbc = identity."""
    th = 2 * np.pi * t / t_loop
    r = TRAJ_R + 0.15 * np.sin(2 * np.pi * t / 4.1)
    z = TRAJ_Z + 0.12 * np.sin(2 * np.pi * t / 2.5)
    p = np.array([r * np.cos(th), r * np.sin(th), z])
    d = np.array([-np.sin(th), np.cos(th), 0.0])  # tangent, ccw
    yaw = 0.03 * np.sin(2 * np.pi * t / 3.3)
    pitch = 0.03 * np.sin(2 * np.pi * t / 2.1)
    cz, sz = np.cos(yaw), np.sin(yaw)
    d = np.array([d[0] * cz - d[1] * sz, d[0] * sz + d[1] * cz, 0.0])
    z_cam = np.array([d[0] * np.cos(pitch), d[1] * np.cos(pitch), np.sin(pitch)])
    z_cam /= np.linalg.norm(z_cam)
    y_cam = np.array([0.0, 0.0, -1.0])
    x_cam = np.cross(y_cam, z_cam)
    x_cam /= np.linalg.norm(x_cam)
    y_cam = np.cross(z_cam, x_cam)
    R_wc = np.stack([x_cam, y_cam, z_cam], axis=1)
    return R_wc, p


def so3_log(R):
    c = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(c)
    if th < 1e-8:
        return np.zeros(3)
    return th / (2 * np.sin(th)) * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                             R[1, 0] - R[0, 1]])


def imu_sample(t, t_loop: float = T_LOOP, h=1e-4):
    """Ideal body-frame (gyro, acc) at time t by central differences."""
    R0, p0 = pose_at(t, t_loop)
    Rm, pm = pose_at(t - h, t_loop)
    Rp, pp = pose_at(t + h, t_loop)
    gyro = so3_log(R0.T @ Rp) / h * 0.5 + so3_log(Rm.T @ R0) / h * 0.5
    a_w = (pp - 2 * p0 + pm) / h**2
    g_w = np.array([0.0, 0.0, -G])
    acc = R0.T @ (a_w - g_w)
    return gyro, acc


def velocity_at(t, t_loop: float = T_LOOP, h=1e-4) -> np.ndarray:
    """The world-frame velocity of the camera centre at time t (central
    difference of `pose_at`)."""
    return (pose_at(t + h, t_loop)[1] - pose_at(t - h, t_loop)[1]) / (2 * h)


class Recording(NamedTuple):
    """One session's camera (and IMU) stream."""

    ts: np.ndarray  # (n,) seconds, k / 20
    imgs: np.ndarray  # (n, H, W) uint8, or (n, 2, H, W) left and right for a pair
    centres: np.ndarray  # (n, 3) ground-truth camera centres (of the left camera)
    imu: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]  # (t (m,), acc (m, 3), gyro (m, 3))


def source_frame(k: int, kidnap: Optional[Sequence[int]]) -> int:
    """The frame of the lap whose scene frame k shows: with `kidnap` = (at,
    src), frame k >= at shows frame src + k - at (a camera carried back along
    its path, its timestamps still increasing)."""
    return k if kidnap is None or k < kidnap[0] else int(kidnap[1]) + k - int(kidnap[0])


def covered(k: int, blind: Optional[Sequence[int]]) -> bool:
    """Whether frame k lies in the blind interval `blind` = (at, n): a covered
    lens, a uniform grey 35 image, while the camera moves on along its path."""
    return blind is not None and blind[0] <= k < blind[0] + blind[1]


def views(n_frames: int, t_loop: float = T_LOOP, density: float = 1.0, wh=(W, H),
          intr=(FX, FY, CX, CY), baseline: Optional[float] = None,
          kidnap: Optional[Sequence[int]] = None, blind: Optional[Sequence[int]] = None,
          cache_dir: Optional[Path] = None) -> np.ndarray:
    """The noise-free views of the room (`ROOM_SEED`) the first `n_frames`
    frames show: (n, V, H, W) float32, V = 2 with a `baseline` (the right
    camera's centre at the left's plus R_wc (baseline, 0, 0) m), zeros for a
    covered lens. They do not depend on the seed, so with `cache_dir` they
    are ray-cast once, kept there under a name made from the arguments, and
    read back (memory-mapped) by later calls."""
    args = dict(n=n_frames, t_loop=float(t_loop), density=float(density), wh=list(wh),
                intr=[float(x) for x in intr], baseline=baseline,
                kidnap=None if kidnap is None else [int(x) for x in kidnap],
                blind=None if blind is None else [int(x) for x in blind])
    path = None
    if cache_dir is not None:
        key = hashlib.sha1(json.dumps(args, sort_keys=True).encode()).hexdigest()[:16]
        path = Path(cache_dir) / f"views-{key}.npy"
        if path.exists():
            return np.load(path, mmap_mode="r")
    tex = make_textures(np.random.default_rng(ROOM_SEED), density)
    eyes = [0.0] if baseline is None else [0.0, float(baseline)]
    out = np.zeros((n_frames, len(eyes), wh[1], wh[0]), np.float32)

    def view(k):
        if covered(k, blind):
            return
        R_wc, p = pose_at(source_frame(k, kidnap) / CAM_HZ, t_loop)
        for e, b in enumerate(eyes):
            out[k, e] = render(tex, R_wc, p + R_wc @ np.array([b, 0.0, 0.0]), wh, intr)

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        list(pool.map(view, range(n_frames)))
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_suffix(f".{os.getpid()}.part")
        with open(part, "wb") as f:
            np.save(f, out)
        os.replace(part, path)
    return out


def record(seed: int, n_frames: int, t_loop: float = T_LOOP, imu: bool = False,
           density: float = 1.0, wh=(W, H), intr=(FX, FY, CX, CY),
           baseline: Optional[float] = None, kidnap: Optional[Sequence[int]] = None,
           blind: Optional[Sequence[int]] = None, cache_dir: Optional[Path] = None) -> Recording:
    """The generator's first `n_frames` frames (and their IMU stream) for
    `seed`, of the room the generator draws for `ROOM_SEED`: `seed`'s own
    texture draws only advance its stream, which then gives the image noise
    (N(0, 1.5) grey levels, per frame the left image's, then the right's;
    drawn for a covered lens too) and the IMU noise. `baseline`, `kidnap`,
    `blind` and `cache_dir` as in `views`."""
    rng = np.random.default_rng(seed)
    texture_draws(rng, density)
    v = views(n_frames, t_loop, density, wh, intr, baseline, kidnap, blind, cache_dir)
    imgs = np.empty(v.shape, np.uint8)
    for k in range(n_frames):
        for e in range(v.shape[1]):
            noise = rng.normal(0, 1.5, v.shape[2:])
            imgs[k, e] = 35 if covered(k, blind) else \
                np.clip(v[k, e] + noise, 0, 255).astype(np.uint8)
    if baseline is None:
        imgs = imgs[:, 0]
    ts = np.arange(n_frames) / CAM_HZ
    centres = np.stack([pose_at(source_frame(k, kidnap) / CAM_HZ, t_loop)[1]
                        for k in range(n_frames)])
    stream = None
    if imu:
        sg = NOISE_GYRO * np.sqrt(IMU_HZ)
        sa = NOISE_ACC * np.sqrt(IMU_HZ)
        n_imu = int(round((n_frames - 1) / CAM_HZ * IMU_HZ)) + 1
        t_imu = np.arange(n_imu) / IMU_HZ
        gyro = np.empty((n_imu, 3))
        acc = np.empty((n_imu, 3))
        for j, t in enumerate(t_imu):
            g, a = imu_sample(t, t_loop)
            gyro[j] = g + BIAS_G + rng.normal(0, sg, 3)
            acc[j] = a + BIAS_A + rng.normal(0, sa, 3)
        stream = (t_imu, acc, gyro)
    return Recording(ts, imgs, centres, stream)


def imu_batches(ts: np.ndarray, imu) -> list:
    """Per frame, the IMU samples (t, acc, gyro) with t at or before the
    frame's time and after the previous frame's batch."""
    t_imu, acc, gyro = imu
    out, j = [], 0
    for t in ts:
        batch = []
        while j < len(t_imu) and t_imu[j] <= t:
            batch.append((float(t_imu[j]), acc[j], gyro[j]))
            j += 1
        out.append(batch)
    return out
