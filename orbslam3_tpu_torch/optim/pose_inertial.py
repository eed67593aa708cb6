"""Pose-inertial motion-only optimization (tracking after IMU
initialization) on torch tensors — the port of
`orbslam3_tpu/optim/pose_inertial.py`:

* `optimize_pose_inertial` (`PoseInertialOptimizationLastKeyFrame`,
  `Optimizer.cc:3752`): the frame's 15-dof body state against its map-point
  reprojections (mono and stereo-`ur` rows, robust), the preintegration
  edge to the last keyframe (held fixed) and the bias random walk;
* `optimize_pose_inertial_last_frame` (`PoseInertialOptimizationLastFrame`,
  `Optimizer.cc:8068`): the last frame and the current one jointly (30
  dof), the last frame under its marginalization prior
  (`EdgePriorPoseImu`, `G2oTypes.h:751`); the returned `H` marginalizes
  the last frame out (`Optimizer::Marginalize`, `Optimizer.cc:5366`).

Both run 4 rounds of 5 Gauss-Newton iterations with the chi2 re-gating of
the visual rows after each round, accept and reject by `torch.where`, and
the `_ex` solves: no host read inside. Every Jacobian is written by hand:
the reprojection rows' (the pinhole Jacobian through the body -> camera
chain), the preintegration rows' (`inertial.imu_residual_jac`), the random
walk's and the prior's (`Jr^-1` of its rotation residual); the reference
takes them from `jax.jacfwd` (`optim/inertial.py` says why the port does
not). `psd_clamp` runs on the host: its `eigh` has
no `_ex` form and would check its result with a host sync on CUDA, and the
prior it clamps is the previous frame's, already fetched.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops import lie
from orbslam3_tpu_torch.optim import lm
from orbslam3_tpu_torch.optim.inertial import imu_residual, imu_residual_jac
from orbslam3_tpu_torch.optim.pose_only import PoseObs


class PoseInertialResult(NamedTuple):
    R_wb: torch.Tensor
    p_wb: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    Rcw: torch.Tensor
    tcw: torch.Tensor
    inlier: torch.Tensor  # (N,) visual inliers
    n_inliers: torch.Tensor
    H: torch.Tensor  # (15,15) information of the frame state at the solution, in
    # the local chart of `_retract`: the next frame's marginalization prior


def psd_clamp(H) -> np.ndarray:
    """Project an information matrix onto the PSD cone on the host (the
    reference's `ConstraintPoseImu` zeroes negative eigenvalues,
    `G2oTypes.h:713-723`), float32 as the reference."""
    H = np.asarray(H, np.float32)
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    w = np.maximum(w, 0.0)
    return ((V * w[None, :]) @ V.T).astype(np.float32)


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def _body_to_cam(R_wb, p_wb, Rbc, tbc):
    Rcw = (R_wb @ Rbc).T
    return Rcw, -_mv(Rcw, p_wb + _mv(R_wb, tbc))


def _retract(R, p, v, bg, ba, dx):
    """Single-state retraction by `dx` (15,) (no re-normalization here)."""
    Rn = R @ lie.exp_so3(dx[None, 0:3])[0]
    return Rn, p + _mv(R, dx[3:6]), v + dx[6:9], bg + dx[9:12], ba + dx[12:15]


def _vis_rows(model, params, bf, R, p, Rbc, tbc, obs: PoseObs, jac: bool = True):
    """Visual residual rows e (N,3) (stereo column zero for mono rows), ok,
    is_stereo, and with `jac` de/d[dtheta, dp] (N,3,6) of the body state."""
    Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
    Xc = lie.se3_apply(Rcw, tcw, obs.Xw)
    uv_hat = cam.project(model, params, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    is_stereo = obs.ur >= 0.0
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = torch.cat([uv_hat - obs.uv, torch.where(is_stereo, ur_hat - obs.ur, 0.0)[..., None]], -1)
    ok = obs.valid & (z > 1e-3)
    if not jac:
        return e, ok, is_stereo, None
    Jproj = cam.project_jac(model, params, Xc)  # (N,2,3)
    dz = torch.zeros_like(Jproj[:, 0, :])
    dz[:, 2] = 1.0
    Jur = torch.where(is_stereo[:, None], Jproj[:, 0, :] + (bf * inv_z * inv_z)[:, None] * dz, 0.0)
    Jc = torch.cat([Jproj, Jur[:, None, :]], dim=1) @ Rbc.T  # (N,3,3): by the body point
    Xb = _mv(R.T, obs.Xw - p)
    J = torch.cat([Jc @ lie.hat(Xb), -Jc], dim=-1)
    return e, ok, is_stereo, J


def _chi2(model, params, bf, R, p, Rbc, tbc, obs):
    e, ok, is_stereo, _ = _vis_rows(model, params, bf, R, p, Rbc, tbc, obs, jac=False)
    return torch.sum(e * e, -1) / obs.sigma2, ok, is_stereo


def _imu_rows(R1, p1, v1, bg1, ba1, R2, p2, v2, pre: imu_ops.Preintegrated, g, jac: bool):
    """The preintegration residual between two single states (leading axis
    1), and with `jac` its Jacobians (9,15) by state 1 and (9,9) by state
    2's [theta, p, v]."""
    args = (R1[None], p1[None], v1[None], bg1[None], ba1[None], R2[None], p2[None], v2[None],
            pre.dR[None], pre.dV[None], pre.dP[None], pre.JRg[None], pre.JVg[None],
            pre.JVa[None], pre.JPg[None], pre.JPa[None], pre.bias_gyro[None],
            pre.bias_acc[None], pre.dT[None], g[None])
    if not jac:
        return imu_residual(*args)[0], None, None
    r, Ji, Jj = imu_residual_jac(*args)
    return r[0], Ji[0], Jj[0]


def _whitening(pre: imu_ops.Preintegrated):
    """Cholesky factors L of the 9x9 preintegration information and of the
    6x6 random-walk information (whitened rows: L^T r)."""
    C9 = pre.C[:9, :9]
    eye9 = torch.eye(9, dtype=C9.dtype, device=C9.device)
    info9 = torch.linalg.inv_ex(0.5 * (C9 + C9.T) + 1e-10 * eye9).inverse
    L_imu = torch.linalg.cholesky_ex(0.5 * (info9 + info9.T)).L
    info_rw = torch.linalg.inv_ex(pre.C[9:, 9:] + 1e-12 * eye9[:6, :6]).inverse
    L_rw = torch.linalg.cholesky_ex(0.5 * (info_rw + info_rw.T)).L
    return L_imu, L_rw


def _solve(model, params, bf, obs, Rbc, tbc, state, n_state: int, vis_of, small_rows, retract_all,
           rounds: int, iters_per_round: int):
    """The shared Gauss-Newton schedule. `vis_of(state)` -> the current
    frame's (R, p); the visual Jacobian fills columns `n_state - 15` ..
    `n_state - 9`; `small_rows(state, jac)` -> the whitened IMU, random-walk
    (and prior) rows at the state, and with `jac` their Jacobian by the
    n_state-dof perturbation; `retract_all(state, dx)`. The robust weights
    are frozen per iteration (IRLS) from the linearization's own residuals.
    Returns (state, active, J at the solution)."""
    dev, dt = obs.uv.device, obs.uv.dtype
    inv_sig = torch.sqrt(1.0 / obs.sigma2)
    c0 = n_state - 15
    eye = torch.eye(n_state, dtype=dt, device=dev)

    def visual(st, active, w_rob_sqrt=None):
        """Weighted visual rows (and, when no weights are given, the robust
        weights from these rows and the weighted Jacobian)."""
        e, ok, is_stereo, J6 = _vis_rows(model, params, bf, *vis_of(st), Rbc, tbc, obs,
                                         jac=w_rob_sqrt is None)
        if w_rob_sqrt is None:
            c2 = torch.sum(e * e, -1) / obs.sigma2
            delta2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
            w_rob_sqrt = torch.sqrt(lm.huber_weight(c2, delta2))
        use = ok & active
        w = torch.where(use, inv_sig * w_rob_sqrt, 0.0)
        if J6 is not None:  # rows outside the set zeroed, not only weighted (fault C14)
            J6 = torch.where(use[:, None, None], J6 * w[:, None, None], 0.0)
        return e * w[:, None], J6, w_rob_sqrt

    def linearize(st, active):
        e_w, J6, w_rob_sqrt = visual(st, active)
        N = e_w.shape[0]
        Jv = torch.zeros((N * 3, n_state), dtype=dt, device=dev)
        Jv[:, c0 : c0 + 6] = J6.reshape(N * 3, 6)
        r_s, J_s = small_rows(st, True)
        return torch.cat([e_w.reshape(-1), r_s]), torch.cat([Jv, J_s], 0), w_rob_sqrt

    active = obs.valid
    for _ in range(rounds):
        lamb = torch.full((), 1e-3, dtype=dt, device=dev)
        for _ in range(iters_per_round):
            r0, J, w_rob_sqrt = linearize(state, active)
            H = J.T @ J
            b = J.T @ r0
            Hd = H + lamb * torch.diag(torch.diag(H)) + 1e-9 * eye
            dx = -torch.linalg.solve_ex(Hd, b).result
            new = retract_all(state, dx)
            e_n = visual(new, active, w_rob_sqrt)[0]
            r_new = torch.cat([e_n.reshape(-1), small_rows(new, False)[0]])
            better = torch.sum(r_new * r_new) < torch.sum(r0 * r0)
            state = tuple(torch.where(better, b_, a_) for a_, b_ in zip(state, new))
            lamb = torch.clamp(torch.where(better, lamb * 0.5, lamb * 4.0), 1e-8, 1e4)
        c2, ok, is_stereo = _chi2(model, params, bf, *vis_of(state), Rbc, tbc, obs)
        active = obs.valid & ok & (c2 <= torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO))
    _, J, _ = linearize(state, active)
    return state, active, J


def optimize_pose_inertial(model: cam.CameraModel, params: torch.Tensor, obs: PoseObs, Rbc, tbc,
                           R_kf, p_kf, v_kf, bg_kf, ba_kf, pre: imu_ops.Preintegrated, R0_wb,
                           p0_wb, v0, bf: float = 0.0, rounds: int = 4,
                           iters_per_round: int = 5) -> PoseInertialResult:
    """The LastKeyFrame variant: the anchor keyframe's body state (R_kf ..
    ba_kf) is fixed, `pre` integrates keyframe -> frame, (R0_wb, p0_wb, v0)
    is the initial guess (the IMU prediction) and the biases start at the
    keyframe's. `H` is J^T J of the 15-dof block at the solution."""
    L_imu, L_rw = _whitening(pre)
    g = imu_ops.gravity(obs.uv.device, obs.uv.dtype)

    eye6 = torch.eye(6, dtype=g.dtype, device=g.device)
    J_rw = L_rw.T @ torch.cat([torch.zeros((6, 9), dtype=g.dtype, device=g.device), eye6], 1)

    def small_rows(st, jac):
        R, p, v, bg, ba = st
        # The keyframe is edge end i with the frame's biases; the frame is j.
        r_imu, Ji, Jj = _imu_rows(R_kf, p_kf, v_kf, bg, ba, R, p, v, pre, g, jac)
        r = torch.cat([_mv(L_imu.T, r_imu), _mv(L_rw.T, torch.cat([bg - bg_kf, ba - ba_kf]))])
        if not jac:
            return r, None
        return r, torch.cat([L_imu.T @ torch.cat([Jj, Ji[:, 9:]], 1), J_rw], 0)

    def retract_all(st, dx):
        R, p, v, bg, ba = _retract(*st, dx)
        return (lie.normalize_rotation(R), p, v, bg, ba)

    state, active, J = _solve(model, params, bf, obs, Rbc, tbc, (R0_wb, p0_wb, v0, bg_kf, ba_kf),
                              15, lambda st: st[:2], small_rows, retract_all, rounds,
                              iters_per_round)
    R, p, v, bg, ba = state
    Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
    return PoseInertialResult(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, Rcw=Rcw, tcw=tcw, inlier=active,
                              n_inliers=active.to(torch.int32).sum().to(torch.int32), H=J.T @ J)


def optimize_pose_inertial_last_frame(model: cam.CameraModel, params: torch.Tensor, obs: PoseObs,
                                      Rbc, tbc, R_lf, p_lf, v_lf, bg_lf, ba_lf, H_prior,
                                      pre: imu_ops.Preintegrated, R0_wb, p0_wb, v0,
                                      bf: float = 0.0, rounds: int = 4,
                                      iters_per_round: int = 5) -> PoseInertialResult:
    """The LastFrame variant: [last frame, current frame] jointly (30 dof).
    `H_prior` is the last frame's (15,15) prior as a host array (clamped to
    the PSD cone by `psd_clamp` here, then uploaded without a sync); `pre`
    integrates last frame -> frame, whose edge reads the last frame's
    biases. On return `H` is the 15x15 prior of the current frame, the
    Schur complement of the last frame in the 30x30 system."""
    dev, dt = obs.uv.device, obs.uv.dtype
    L_imu, L_rw = _whitening(pre)
    eye15 = torch.eye(15, dtype=dt, device=dev)
    Hp = convert.tensor(psd_clamp(H_prior), dev)
    L_pr = torch.linalg.cholesky_ex(Hp + 1e-6 * eye15).L
    g = imu_ops.gravity(dev, dt)

    eye3 = torch.eye(3, dtype=dt, device=dev)
    z = torch.zeros((6, 6), dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    J_rw = L_rw.T @ torch.cat([z, z[:, :3], -eye6, z, z[:, :3], eye6], 1)  # (6,30)

    def small_rows(st, jac):
        R1, p1, v1, bg1, ba1, R2, p2, v2, bg2, ba2 = st
        rot_pr = lie.log_so3((R_lf.T @ R1)[None])[0]
        r_pr = torch.cat([rot_pr, _mv(R_lf.T, p1 - p_lf), v1 - v_lf, bg1 - bg_lf, ba1 - ba_lf])
        # The edge reads the LAST frame's biases (`Optimizer.cc:8319-8321`);
        # the current frame's are tied to them by the random walk only.
        r_imu, Ji, Jj = _imu_rows(R1, p1, v1, bg1, ba1, R2, p2, v2, pre, g, jac)
        r = torch.cat([_mv(L_imu.T, r_imu), _mv(L_rw.T, torch.cat([bg2 - bg1, ba2 - ba1])),
                       _mv(L_pr.T, r_pr)])
        if not jac:
            return r, None
        J_imu = torch.cat([Ji, Jj, torch.zeros((9, 6), dtype=dt, device=dev)], 1)
        J_pr = torch.block_diag(lie.inv_right_jacobian_so3(rot_pr[None])[0], R_lf.T @ R1, eye3,
                                eye3, eye3)
        J_pr = torch.cat([J_pr, torch.zeros((15, 15), dtype=dt, device=dev)], 1)
        return r, torch.cat([L_imu.T @ J_imu, J_rw, L_pr.T @ J_pr], 0)

    def retract_all(st, dx):
        R1, *f1 = _retract(*st[:5], dx[:15])
        R2, *f2 = _retract(*st[5:], dx[15:])
        return (lie.normalize_rotation(R1), *f1, lie.normalize_rotation(R2), *f2)

    state0 = (R_lf, p_lf, v_lf, bg_lf, ba_lf, R0_wb, p0_wb, v0, bg_lf, ba_lf)
    state, active, J = _solve(model, params, bf, obs, Rbc, tbc, state0, 30, lambda st: st[5:7],
                              small_rows, retract_all, rounds, iters_per_round)
    R, p, v, bg, ba = state[5:]
    Rcw, tcw = _body_to_cam(R, p, Rbc, tbc)
    Hf = J.T @ J
    H11 = Hf[:15, :15] + 1e-8 * eye15
    H12 = Hf[:15, 15:]
    H_marg = Hf[15:, 15:] - H12.T @ torch.linalg.solve_ex(H11, H12).result
    return PoseInertialResult(R_wb=R, p_wb=p, v=v, bg=bg, ba=ba, Rcw=Rcw, tcw=tcw, inlier=active,
                              n_inliers=active.to(torch.int32).sum().to(torch.int32),
                              H=0.5 * (H_marg + H_marg.T))
