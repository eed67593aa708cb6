"""Inertial support of the tracking and mapping pipelines on torch tensors —
the port of `orbslam3_tpu/pipeline/inertial_support.py`:

* the host IMU queue and the per-gap preintegration (`Tracking::GrabImuData`
  `Tracking.cc:621`, `PreintegrateIMU` `:639`);
* the state prediction (`PredictStateIMU` `:787`), on the device;
* camera <-> body pose conversion (numpy on the host, or batched tensors);
* the gravity and scale alignment of a map (`Map::ApplyScaledRotation`
  `Map.cc:121`);
* the IMU initialization driven by local mapping
  (`LocalMapping::InitializeIMU`, `LocalMapping.cc:1448`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.optim import inertial as vi

PREINT_CAP = 64  # max IMU samples per frame gap (200 Hz IMU / 20 Hz camera ~ 10)


@dataclass
class ImuQueue:
    """Host-side measurement buffer (ref mlQueueImuData)."""

    ts: List[float] = field(default_factory=list)
    acc: List[np.ndarray] = field(default_factory=list)
    gyro: List[np.ndarray] = field(default_factory=list)

    def push(self, t: float, acc, gyro):
        self.ts.append(float(t))
        self.acc.append(np.asarray(acc, np.float32))
        self.gyro.append(np.asarray(gyro, np.float32))

    def window(self, t0: float, t1: float):
        """Samples covering [t0, t1] (one sample of margin each side for the
        border interpolation), dropping all older entries."""
        ts = np.asarray(self.ts)
        keep_from = max(0, int(np.searchsorted(ts, t0)) - 1)
        if keep_from > 0:  # trim consumed history (keep the margin)
            self.ts = self.ts[keep_from:]
            self.acc = self.acc[keep_from:]
            self.gyro = self.gyro[keep_from:]
        ts = np.asarray(self.ts)
        hi = int(np.searchsorted(ts, t1)) + 1
        return (np.asarray(self.acc[:hi], np.float32).reshape(-1, 3),
                np.asarray(self.gyro[:hi], np.float32).reshape(-1, 3), ts[:hi])


def preintegrate_window(queue: ImuQueue, t0: float, t1: float, bias_g, bias_a,
                        calib: imu_ops.ImuCalib) -> Optional[imu_ops.Preintegrated]:
    """`Tracking::PreintegrateIMU` for one frame gap: midpoint-interpolated
    samples (at most PREINT_CAP, as the reference's padded window) and the
    host biases go up in one pinned copy (no sync), then `integrate` on the
    calibration's device. None when the gap holds no sample."""
    acc, gyro, ts = queue.window(t0, t1)
    if len(ts) < 2:
        return None
    a, g, dt = imu_ops.midpoint_samples(acc, gyro, ts, t0, t1)
    if len(dt) == 0:
        return None
    n = min(len(dt), PREINT_CAP)
    rows = np.zeros((n + 1, 7), np.float32)
    rows[:n, 0:3], rows[:n, 3:6], rows[:n, 6] = a[:n], g[:n], dt[:n]
    rows[n, 0:3], rows[n, 3:6] = np.asarray(bias_g, np.float32), np.asarray(bias_a, np.float32)
    up = convert.tensor(rows, calib.cov.device)
    return imu_ops.integrate(up[:n, 0:3], up[:n, 3:6], up[:n, 6], up[n, 0:3], up[n, 3:6], calib)


# ---------------------------------------------------------------------------
# Camera <-> body pose conversion. Tbc: body <- camera (YAML `Tbc`). Works on
# numpy arrays and on (batched) tensors.
# ---------------------------------------------------------------------------


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def cam_to_body(Rcw, tcw, Rbc, tbc):
    """Tcw -> (R_wb, p_wb): T_wb = T_wc * T_cb."""
    Rwc = Rcw.swapaxes(-1, -2)
    twc = -_mv(Rwc, tcw)
    RbcT = Rbc.swapaxes(-1, -2)
    return Rwc @ RbcT, twc + _mv(Rwc, -_mv(RbcT, tbc))


def body_to_cam(R_wb, p_wb, Rbc, tbc):
    """(R_wb, p_wb) -> Tcw: T_wc = T_wb * T_bc."""
    Rwc = R_wb @ Rbc
    twc = p_wb + _mv(R_wb, tbc)
    Rcw = Rwc.swapaxes(-1, -2)
    return Rcw, -_mv(Rcw, twc)


def predict_state(R_wb, p_wb, v_w, bias_g, bias_a, pre: imu_ops.Preintegrated):
    """`Tracking::PredictStateIMU` (`Tracking.cc:787`): the last state
    propagated through a preintegrated window, on the device. Returns
    (R1, v1, p1) tensors."""
    dT = pre.dT
    g = imu_ops.gravity(pre.dR.device, pre.dR.dtype)
    dR = imu_ops.delta_rotation(pre, bias_g)
    dV = imu_ops.delta_velocity(pre, bias_g, bias_a)
    dP = imu_ops.delta_position(pre, bias_g, bias_a)
    R1 = R_wb @ dR
    v1 = v_w + g * dT + _mv(R_wb, dV)
    p1 = p_wb + v_w * dT + 0.5 * g * dT * dT + _mv(R_wb, dP)
    return R1, v1, p1


# ---------------------------------------------------------------------------
# Gravity / scale alignment of a whole map
# ---------------------------------------------------------------------------


def apply_scaled_rotation(state: st.MapState, Rwg: torch.Tensor, scale: float) -> st.MapState:
    """`Map::ApplyScaledRotation`: re-express the map so gravity is -z and
    the scale is metric. World x' = s Rwg^T x; poses Rcw' = Rcw Rwg,
    tcw' = s tcw; velocities v' = s Rwg^T v. Point normals rotate and the
    distance band scales, as the reference's `UpdateNormalAndDepth` after
    the transform."""
    Rgw = Rwg.T
    return state._replace(
        kf_R=state.kf_R @ Rwg[None],
        kf_t=state.kf_t * scale,
        kf_vel=scale * torch.einsum("ij,kj->ki", Rgw, state.kf_vel),
        mp_pos=scale * torch.einsum("ij,pj->pi", Rgw, state.mp_pos),
        mp_normal=torch.einsum("ij,pj->pi", Rgw, state.mp_normal),
        mp_min_dist=state.mp_min_dist * scale,
        mp_max_dist=state.mp_max_dist * scale,
    )


# ---------------------------------------------------------------------------
# IMU initialization staging (LocalMapping::InitializeIMU)
# ---------------------------------------------------------------------------


class ImuInitializer:
    """The reference's staged inertial initialization: the first call
    (2 s and 10 keyframes in) runs the inertial-only MAP, then aligns the
    map to gravity and metric scale (`LocalMapping.cc:1448-1590`); VIBA1 at
    5 s and VIBA2 at 15 s are the mapper's (`_viba_staging`)."""

    def __init__(self, calib: imu_ops.ImuCalib, mono: bool = True):
        self.calib = calib
        self.mono = mono
        self.initialized = False
        self.viba1_done = False
        self.viba2_done = False
        # (Rwg, scale) of the last apply_scaled_rotation, for the caller to
        # hand to Tracker.apply_map_transform.
        self.applied_transform: Optional[Tuple[np.ndarray, float]] = None

    def kf_chain_edges(self, store: st.MapStore, preints: dict) -> Optional[vi.ImuEdge]:
        """Edges of consecutive keyframes from their preintegrations
        (`preints`: keyframe slot -> window from its previous keyframe)."""
        prev = store.state.kf_prev.cpu().numpy()[: store.n_kf]
        pairs = [(int(prev[k]), k) for k in range(store.n_kf) if prev[k] >= 0 and k in preints]
        if not pairs:
            return None
        ij = store.tensor(np.asarray(pairs, np.int32).T.copy())
        return vi.make_imu_edges(ij[0], ij[1], imu_ops.stack([preints[j] for _, j in pairs]),
                                 torch.ones(len(pairs), dtype=torch.bool, device=store.device))

    def try_initialize(self, store: st.MapStore, preints: dict, Rbc: np.ndarray, tbc: np.ndarray,
                       min_kfs: int = 10, min_time: float = 2.0) -> bool:
        """Inertial-only initialization and map alignment; True on success.
        Gates as the reference: `min_kfs` keyframes and `min_time` seconds
        between the first and the newest (`LocalMapping.cc:1459-1470`).
        The velocities and biases are written to the first n_kf keyframe
        rows (the reference's slice write, no duplicate index)."""
        if store.n_kf < min_kfs:
            return False
        if store.kf_ts[store.n_kf - 1] - store.kf_ts[0] < min_time:
            return False
        edges = self.kf_chain_edges(store, preints)
        if edges is None or edges.i.shape[0] < min_kfs - 1:
            return False
        s = store.state
        K = store.n_kf
        R_wb, p_wb = cam_to_body(s.kf_R.cpu().numpy()[:K], s.kf_t.cpu().numpy()[:K], Rbc, tbc)
        Rp = np.tile(np.eye(3, dtype=np.float32), (s.Kmax, 1, 1))
        pp = np.zeros((s.Kmax, 3), np.float32)
        Rp[:K], pp[:K] = R_wb, p_wb
        valid = np.zeros(s.Kmax, bool)
        valid[:K] = s.kf_valid.cpu().numpy()[:K]
        T = store.tensor
        res = vi.inertial_only_optimization(T(Rp), T(pp), T(valid), edges,
                                            fix_scale=not self.mono, iters=30)
        scale = float(res.scale)
        if scale < 0.1 or not np.isfinite(scale):  # sanity (`LocalMapping.cc:1549`)
            return False
        Rwg = res.Rwg.cpu().numpy()
        store.state = apply_scaled_rotation(store.state, res.Rwg, scale)
        self.applied_transform = (Rwg, scale)  # for Tracker.apply_map_transform
        vel = scale * (Rwg.T @ res.vel.cpu().numpy()[:K].T).T
        bg, ba = res.bg.cpu().numpy(), res.ba.cpu().numpy()
        ss = store.state
        store.state = ss._replace(
            kf_vel=torch.cat([T(vel.astype(np.float32)), ss.kf_vel[K:]]),
            kf_bias_g=torch.cat([T(np.tile(bg, (K, 1))), ss.kf_bias_g[K:]]),
            kf_bias_a=torch.cat([T(np.tile(ba, (K, 1))), ss.kf_bias_a[K:]]),
        )
        store.bump()
        self.initialized = True
        return True

    def refine_scale(self, store: st.MapStore, preints: dict, Rbc: np.ndarray, tbc: np.ndarray,
                     tol: float = 0.01) -> bool:
        """`LocalMapping::ScaleRefinement` (`LocalMapping.cc:1631`): the
        inertial-only MAP again on the (metric) map, without the gates."""
        if not self.initialized:
            return False
        self.initialized = False  # reuse the init path without its gates
        ok = self.try_initialize(store, preints, Rbc, tbc, min_kfs=3, min_time=0.0)
        self.initialized = True
        return ok
