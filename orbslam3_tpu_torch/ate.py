"""Trajectory score of the port's replays: Umeyama/Sim3 alignment and the
ATE RMSE — `orbslam3_tpu/eval/ate.py`'s `umeyama`, `associate` and
`ate_rmse`, in numpy. The port carries its own copy because the card's
checks import nothing of the JAX package; `tests/test_torch_system.py`
holds it equal to the reference's."""

from __future__ import annotations

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """(s, R, t) with dst ~= s * R @ src + t, least squares (Umeyama 1991)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = np.trace(np.diag(D) @ S) / ((xs**2).sum() / len(src)) if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp association of two trajectories: index arrays
    (ia, ib) of the pairs within `max_dt`."""
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = np.searchsorted(ts_b, t)
        cands = [c for c in (j - 1, j) if 0 <= c < len(ts_b)]
        if not cands:
            continue
        best = min(cands, key=lambda c: abs(ts_b[c] - t))
        if abs(ts_b[best] - t) <= max_dt:
            ia.append(i)
            ib.append(best)
    return np.asarray(ia), np.asarray(ib)


def ate_rmse(est_ts, est_pos, gt_ts, gt_pos, with_scale: bool = True,
             max_dt: float = 0.02) -> float:
    """ATE RMSE after Sim3 (`with_scale`, monocular) or SE3 alignment, over
    the associated poses with finite positions; inf below 3 of them."""
    ia, ib = associate(est_ts, gt_ts, max_dt)
    if len(ia) < 3:
        return float("inf")
    est, gt = est_pos[ia], gt_pos[ib]
    finite = np.isfinite(est).all(axis=1) & np.isfinite(gt).all(axis=1)
    if finite.sum() < 3:
        return float("inf")
    est, gt = est[finite], gt[finite]
    s, R, t = umeyama(est, gt, with_scale)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return float(np.sqrt((err**2).mean()))
