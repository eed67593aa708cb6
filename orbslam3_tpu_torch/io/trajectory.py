"""Trajectory writers/readers in TUM / EuRoC / KITTI formats — a numpy copy
of `orbslam3_tpu/io/trajectory.py` (the port imports nothing of the JAX
package; `tests/test_torch_atlas.py` holds the two to the same bytes).

Mirrors `System::SaveTrajectory{TUM,EuRoC,KITTI}` and
`SaveKeyFrameTrajectory*` (`System.cc:524-1010`):
TUM/EuRoC rows are `t tx ty tz qx qy qz qw`, KITTI rows are flattened
3x4 Twc matrices. Poses are given as Twc (camera->world), like the files
the reference writes.
"""

from __future__ import annotations

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """(qx, qy, qz, qw) from rotation matrix (TUM order)."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # fall back through largest diagonal
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = s / 4
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q[0], q[1], q[2]
    return np.array([x, y, z, w])


def save_tum(path: str, timestamps, Rwc_list, twc_list, scale_ts: float = 1.0):
    """One row per pose: `timestamp tx ty tz qx qy qz qw` (TUM RGB-D /
    EuRoC formats differ only in the timestamp unit; the reference writes
    seconds with 9 decimals for EuRoC, `System.cc:SaveTrajectoryEuRoC`)."""
    with open(path, "w") as f:
        for ts, R, t in zip(timestamps, Rwc_list, twc_list):
            q = _quat_from_R(np.asarray(R))
            f.write(
                f"{ts * scale_ts:.9f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n"
            )


def save_euroc(path: str, timestamps, Rwc_list, twc_list):
    """EuRoC-format rows (`System::SaveTrajectoryEuRoC`,
    `System.cc:699-712`): `t tx ty tz qx qy qz qw`
    with the timestamp at fixed 6 decimals and values at 9 decimals
    (the reference's `setprecision(6)` / `setprecision(9)` under
    `std::fixed`). Pose semantics (largest-map selection, first-KF
    re-rooting, body vs camera frame) are the caller's job —
    `System.save_trajectory_euroc`."""
    with open(path, "w") as f:
        for ts, R, t in zip(timestamps, Rwc_list, twc_list):
            q = _quat_from_R(np.asarray(R))
            f.write(
                f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n"
            )


def save_kitti(path: str, Rwc_list, twc_list):
    """Flattened 3x4 Twc per row (`System::SaveTrajectoryKITTI`)."""
    with open(path, "w") as f:
        for R, t in zip(Rwc_list, twc_list):
            M = np.concatenate([np.asarray(R), np.asarray(t)[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_tum(path: str):
    """Returns (timestamps (N,), positions (N,3), quaternions (N,4))."""
    data = np.loadtxt(path, comments="#")
    if data.ndim == 1:
        data = data[None]
    return data[:, 0], data[:, 1:4], data[:, 4:8]
