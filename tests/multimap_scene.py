"""The multi-map scene of `scripts/multimap_replay.py` (config 5's Atlas
core), in numpy, for the port's multi-map parity tests: two adjacent wall
sections of 110 squares each with four random quadrant shades; sweep A
maps section 1, 28 blank frames lose the track (the map is stored and a
new one starts), sweep B initializes on section 2 and pans back into
section 1, where place recognition merges the maps. `Scene` renders every
frame of `schedule` equal to the original's (`pose_at` is the reference's
float32 Rodrigues formula, the projection its float32 pinhole).
`make_system` builds the port's `System` as the script's `make_system`
builds the JAX one; the vocabulary comes from the caller (the tests build
it with the JAX scene and carry it over)."""

from __future__ import annotations

import numpy as np

H, W = 240, 320
FOCAL = 260.0
PARAMS = np.array([FOCAL, FOCAL, W / 2, H / 2, 0.0, 0.0, 0.0, 0.0], np.float32)


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues in float32, as `orbslam3_tpu/ops/lie.py::exp_so3`."""
    w = np.asarray(w, np.float32)
    theta2 = np.float32(np.sum(w * w))
    small = theta2 < 1e-8
    theta = np.sqrt(np.float32(1.0) if small else theta2)
    Wm = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], np.float32)
    if small:
        a = np.float32(1.0) - theta2 / np.float32(6.0)
        b = np.float32(0.5) - theta2 / np.float32(24.0)
    else:
        a = np.sin(theta) / theta
        b = (np.float32(1.0) - np.cos(theta)) / theta2
    return np.eye(3, dtype=np.float32) + a * Wm + b * (Wm @ Wm)


class Scene:
    def __init__(self, seed: int = 3):
        rng = np.random.default_rng(seed)
        self.params = PARAMS
        n1, n2 = 110, 110
        pts1 = np.stack([rng.uniform(-3.5, 3.5, n1), rng.uniform(-2.2, 2.2, n1),
                         rng.uniform(3.0, 6.0, n1)], axis=-1)
        pts2 = np.stack([rng.uniform(3.5, 10.5, n2), rng.uniform(-2.2, 2.2, n2),
                         rng.uniform(3.0, 6.0, n2)], axis=-1)
        self.pts = np.concatenate([pts1, pts2]).astype(np.float32)
        self.quad_shades = rng.uniform(50, 250, (n1 + n2, 2, 2)).astype(np.float32)
        self.blank = np.full((H, W), 35.0, np.float32)
        # Sweep A on wall 1 (x 0 -> 1.4), 28 blank frames, sweep B from
        # wall 2 (x 6.5) back to wall 1 (x -> 0.5).
        self.schedule = []
        n_a = 14
        for k in range(n_a):
            s_ = k / (n_a - 1)
            self.schedule.append(("A", self.pose_at(1.4 * s_, s_)))
        for _ in range(28):
            self.schedule.append(("blank", None))
        n_b = 26
        for k in range(n_b):
            s_ = k / (n_b - 1)
            self.schedule.append(("B", self.pose_at(6.5 - 6.0 * s_, s_)))

    def pose_at(self, x, s):
        Rcw = exp_so3(np.asarray([0.0, -0.03 * s, 0.0], np.float32))
        center = np.array([x, 0.1 * np.sin(4 * s), 0.3 * s], np.float32)
        return Rcw, (-Rcw @ center).astype(np.float32)

    def render(self, Rcw, tcw):
        img = np.full((H, W), 35.0, np.float32)
        Xc = (Rcw @ self.pts.T).T + tcw
        inv_z = np.float32(1.0) / np.where(np.abs(Xc[:, 2]) < 1e-9, np.float32(1e-9), Xc[:, 2])
        uv = np.stack([np.float32(FOCAL) * (Xc[:, 0] * inv_z) + np.float32(W / 2),
                       np.float32(FOCAL) * (Xc[:, 1] * inv_z) + np.float32(H / 2)], -1)
        for i in np.argsort(-Xc[:, 2]):
            if Xc[i, 2] < 0.5:
                continue
            u, v = uv[i]
            half = max(3, int(round(12.0 / Xc[i, 2] * 2)))
            ui, vi = int(round(u)), int(round(v))
            if 1 <= ui < W - 1 and 1 <= vi < H - 1:
                for qy in (0, 1):
                    for qx in (0, 1):
                        y0, y1 = (vi - half, vi) if qy == 0 else (vi, vi + half)
                        x0, x1 = (ui - half, ui) if qx == 0 else (ui, ui + half)
                        img[max(y0, 0):min(y1, H),
                            max(x0, 0):min(x1, W)] = self.quad_shades[i, qy, qx]
        return img

    def frames(self):
        """(tag, image, timestamp, camera centre or None) per scheduled frame,
        at 10 Hz as the script's `replay`."""
        out = []
        for i, (tag, pose) in enumerate(self.schedule):
            if tag == "blank":
                out.append((tag, self.blank, i * 0.1, None))
            else:
                R, t = pose
                out.append((tag, self.render(R, t), i * 0.1, -R.T @ t))
        return out


def make_system(vocabulary, device="cpu", post_merge_gba: bool = True,
                place_recognition: bool = False):
    """The port's `System` of the script's `make_system`: monocular, 400
    features on 3 levels, Kmax 64, Pmax 8192, the Atlas with its thresholds
    (maps of more than 5 keyframes are stored); `place_recognition` enables
    it first (relocalization, loop closing, the background GBA)."""
    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.system import Sensor, System

    slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, PARAMS, (W, H),
                  feat.OrbParams(n_features=400, n_levels=3), device=device, Kmax=64, Pmax=8192)
    if place_recognition:
        slam.enable_place_recognition(vocabulary)
    slam.enable_multimap(vocabulary, min_kfs_to_store=5, min_merge_matches=15,
                         min_sim3_inliers=12, post_merge_gba=post_merge_gba)
    return slam
