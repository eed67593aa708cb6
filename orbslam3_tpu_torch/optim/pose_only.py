"""Pose-only optimization (motion-only BA) on torch tensors — the port of
`orbslam3_tpu/optim/pose_only.py` with mono and stereo-`ur` rows and a
two-camera rig's right-camera rows (`EdgeSE3ProjectXYZOnlyPoseToBody`).

Same schedule: 4 rounds x 10 Levenberg-Marquardt iterations, each step
accepted only if the robust cost drops, a Huber threshold 10x wider in
round 0, inliers re-gated by chi2 after every round. State Tcw = (R, t),
updated on the left: Tcw <- Exp([rho, phi]) * Tcw.

Rows outside the active set have their Jacobian zeroed, not only their
weight (fault C14): the Kannala-Brandt 8 Jacobian of a point at the camera
centre is NaN (0/0 in dtheta/dX), and an unassociated row carries the map
point of slot 0, which is the world origin while that slot is empty; the
reference multiplies such a row by a zero weight, and 0 * NaN poisons H.

`jax.lax.scan` becomes a Python loop with no host synchronisation inside:
accept/reject is a `torch.where`, the 6x6 solve is `torch.linalg.solve_ex`
(`torch.linalg.solve` checks its `info` on the host on CUDA). The robust
cost at the current pose is taken from the residuals that were just
linearised — the same function of the same inputs as the reference's
second evaluation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import lie
from orbslam3_tpu_torch.optim import lm


class PoseObs(NamedTuple):
    """Padded observation set for one frame."""

    Xw: torch.Tensor  # (N,3) map-point world positions
    uv: torch.Tensor  # (N,2) measured pixels
    ur: torch.Tensor  # (N,) right-cam u (stereo); <0 => mono observation
    sigma2: torch.Tensor  # (N,) per-octave variance (scale^2)
    valid: torch.Tensor  # (N,) bool


class PoseResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # int32
    chi2: torch.Tensor  # (N,) final per-obs chi2


def _errors(model, params, bf, R, t, obs: PoseObs):
    """e (N,3) with the stereo column zero for mono rows, plus the camera
    points, 1/z and the stereo mask."""
    Xc = lie.se3_apply(R, t, obs.Xw)
    uv_hat = cam.project(model, params, Xc)
    z = Xc[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    is_stereo = obs.ur >= 0.0
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = torch.cat(
        [uv_hat - obs.uv, torch.where(is_stereo, ur_hat - obs.ur, 0.0)[..., None]], dim=-1
    )
    ok = obs.valid & (z > 1e-3)
    return e, ok, is_stereo, Xc, inv_z


def _residuals(model, params, bf, R, t, obs: PoseObs):
    """e (N,3), J (N,3,6), ok (N,), is_stereo (N,)."""
    e, ok, is_stereo, Xc, inv_z = _errors(model, params, bf, R, t, obs)
    Jproj = cam.project_jac(model, params, Xc)  # (N,2,3)
    dz = torch.zeros_like(Jproj[:, 0, :])
    dz[:, 2] = 1.0
    Jur = Jproj[:, 0, :] + (bf * inv_z * inv_z)[:, None] * dz
    Jur = torch.where(is_stereo[:, None], Jur, 0.0)
    Jc3 = torch.cat([Jproj, Jur[:, None, :]], dim=1)  # (N,3,3)
    J = torch.einsum("nij,njk->nik", Jc3, _dXc(Xc))
    return e, J, ok, is_stereo


def _chi2(e, obs: PoseObs):
    inv_s2 = 1.0 / obs.sigma2
    return torch.sum(e * e, dim=-1) * inv_s2, inv_s2


def _dXc(Xc: torch.Tensor) -> torch.Tensor:
    """dXc/d[rho, phi] = [I | -hat(Xc)]: (N,3,6)."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    return torch.cat([eye, -lie.hat(Xc)], dim=-1)


def _errors_right(model, params_r, R_rl, t_rl, R, t, obs_r: PoseObs):
    """The right camera's errors (M,2), the points in both cameras, and ok:
    each map point through Trl * Tcw into the second camera."""
    Xc_l = lie.se3_apply(R, t, obs_r.Xw)
    Xc_r = Xc_l @ R_rl.T + t_rl
    e = cam.project(model, params_r, Xc_r) - obs_r.uv
    return e, Xc_l, Xc_r, obs_r.valid & (Xc_r[..., 2] > 1e-3)


def _residuals_right(model, params_r, R_rl, t_rl, R, t, obs_r: PoseObs):
    """A two-camera rig's right-camera (ToBody) rows: e (M,3) with a zero
    third column, J (M,3,6) (dXc_r/d[rho, phi] = R_rl [I | -hat(Xc_l)]),
    ok (M,)."""
    e2, Xc_l, Xc_r, ok = _errors_right(model, params_r, R_rl, t_rl, R, t, obs_r)
    J2 = (cam.project_jac(model, params_r, Xc_r) @ R_rl) @ _dXc(Xc_l)  # (M,2,6)
    e = torch.cat([e2, torch.zeros_like(e2[:, :1])], dim=-1)
    J = torch.cat([J2, torch.zeros_like(J2[:, :1])], dim=1)
    return e, J, ok


def _rho(c2, d2):
    """Huber's rho on the squared error."""
    return torch.where(c2 <= d2, c2, 2.0 * torch.sqrt(d2 * torch.clamp(c2, min=1e-12)) - d2)


def _robust_cost(e, ok, is_stereo, active, obs, hub_mult):
    c2, _ = _chi2(e, obs)
    d2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO) * hub_mult
    return torch.sum(torch.where(ok & active, _rho(c2, d2), 0.0))


def optimize_pose(model: cam.CameraModel, params: torch.Tensor, R0: torch.Tensor,
                  t0: torch.Tensor, obs: PoseObs, bf: float = 0.0, rounds: int = 4,
                  iters_per_round: int = 10, obs_r: Optional[PoseObs] = None,
                  params_r: Optional[torch.Tensor] = None, R_rl: Optional[torch.Tensor] = None,
                  t_rl: Optional[torch.Tensor] = None) -> PoseResult:
    """The 4x10 schedule of `Optimizer::PoseOptimization` with chi2 re-gating.

    `obs_r` (with `params_r`, `R_rl`, `t_rl`): a two-camera rig's right-camera
    rows, one per left feature with a right match. They enter H and b beside
    the left rows, gate at the 2-DoF chi2 and are re-gated each round; the
    returned inlier and chi2 arrays stay left-indexed."""
    dev, dt = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    R, t = R0, t0
    active = obs.valid
    two_cam = obs_r is not None
    if two_cam:
        active_r = obs_r.valid
        inv_s2_r = 1.0 / obs_r.sigma2

    def right_cost(e_r, ok_r, hub):
        c2r = torch.sum(e_r * e_r, dim=-1) * inv_s2_r
        return torch.sum(torch.where(ok_r & active_r, _rho(c2r, lm.CHI2_MONO * hub), 0.0))

    for rnd in range(rounds):
        # Round 0 widens the Huber quadratic region 10x (cold-start guard).
        hub = torch.full((), 10.0 if rnd == 0 else 1.0, dtype=dt, device=dev)
        lamb = torch.full((), 1e-4, dtype=dt, device=dev)
        for _ in range(iters_per_round):
            e, J, ok, is_stereo = _residuals(model, params, bf, R, t, obs)
            c2, inv_s2 = _chi2(e, obs)
            delta2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO) * hub
            use = ok & active
            w = torch.where(use, inv_s2 * lm.huber_weight(c2, delta2), 0.0)
            J = torch.where(use[:, None, None], J, 0.0)  # fault C14: 0 * NaN is NaN
            Jw = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            b = torch.einsum("nij,ni->j", Jw, e)
            c_old = _robust_cost(e, ok, is_stereo, active, obs, hub)
            if two_cam:
                e_r, J_r, ok_r = _residuals_right(model, params_r, R_rl, t_rl, R, t, obs_r)
                c2r = torch.sum(e_r * e_r, dim=-1) * inv_s2_r
                use_r = ok_r & active_r
                w_r = torch.where(use_r, inv_s2_r * lm.huber_weight(c2r, lm.CHI2_MONO * hub), 0.0)
                J_r = torch.where(use_r[:, None, None], J_r, 0.0)
                Jw_r = J_r * w_r[:, None, None]
                H = H + torch.einsum("nij,nik->jk", Jw_r, J_r)
                b = b + torch.einsum("nij,ni->j", Jw_r, e_r)
                c_old = c_old + right_cost(e_r, ok_r, hub)
            H_damped = H + lamb * torch.diag(torch.diag(H)) + 1e-9 * eye6
            delta = -torch.linalg.solve_ex(H_damped, b).result
            R_step, t_step = lie.exp_se3(delta)
            R_new, t_new = lie.se3_compose(R_step, t_step, R, t)
            R_new = lie.normalize_rotation(R_new)
            e_n, ok_n, st_n, _, _ = _errors(model, params, bf, R_new, t_new, obs)
            c_new = _robust_cost(e_n, ok_n, st_n, active, obs, hub)
            if two_cam:
                e_rn, _, _, ok_rn = _errors_right(model, params_r, R_rl, t_rl, R_new, t_new, obs_r)
                c_new = c_new + right_cost(e_rn, ok_rn, hub)
            accept = c_new < c_old
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lamb = torch.clamp(torch.where(accept, lamb * 0.5, lamb * 4.0), 1e-9, 1e6)
        # Re-classify against the original valid set (outliers can return).
        e, ok, is_stereo, _, _ = _errors(model, params, bf, R, t, obs)
        c2, _ = _chi2(e, obs)
        active = ok & (c2 <= torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO))
        if two_cam:
            e_r, _, _, ok_r = _errors_right(model, params_r, R_rl, t_rl, R, t, obs_r)
            active_r = ok_r & (torch.sum(e_r * e_r, dim=-1) * inv_s2_r <= lm.CHI2_MONO)

    e, ok, is_stereo, _, _ = _errors(model, params, bf, R, t, obs)
    c2, _ = _chi2(e, obs)
    inlier = ok & (c2 <= torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO))
    return PoseResult(R=R, t=t, inlier=inlier,
                      n_inliers=inlier.to(torch.int32).sum().to(torch.int32), chi2=c2)
