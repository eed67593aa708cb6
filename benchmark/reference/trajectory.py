"""The ground truth's side of the judge, in numpy: Umeyama's alignment (a
frozen copy of the arithmetic of `orbslam3_tpu_torch/ate.py`), the
trajectory's error after it, the distance of a map point to the room's
walls, and the IMU state's errors against the generator's trajectory."""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) with dst ~= s * R @ src + t, least squares (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src)) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """(RMSE after the alignment, (s, R, t)) of matched positions (n, 3);
    (inf, None) under 3 finite pairs."""
    ok = np.isfinite(est).all(1) & np.isfinite(gt).all(1)
    if ok.sum() < 3:
        return float("inf"), None
    fit = umeyama(est[ok], gt[ok], with_scale)
    s, R, t = fit
    err = np.linalg.norm((s * (R @ est[ok].T)).T + t - gt[ok], axis=1)
    return float(np.sqrt((err**2).mean())), fit


def wall_distance(p: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Distance (n,) of points p (n, 3) to the surface of the box [lo, hi]."""
    inside = np.all((p >= lo) & (p <= hi), axis=1)
    d_in = np.minimum(p - lo, hi - p).min(axis=1)
    d_out = np.linalg.norm(np.maximum(np.maximum(lo - p, 0.0), p - hi), axis=1)
    return np.where(inside, d_in, d_out)


def tilt_deg(R: np.ndarray) -> float:
    """The angle in degrees by which R turns the z axis (gravity's)."""
    return float(np.degrees(np.arccos(np.clip(R[2, 2], -1.0, 1.0))))
