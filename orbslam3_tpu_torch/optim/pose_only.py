"""Pose-only optimization (motion-only BA) on torch tensors — the port of
`orbslam3_tpu/optim/pose_only.py` with mono and stereo-`ur` rows (the
two-camera rig rows wait for the fisheye slice).

Same schedule: 4 rounds x 10 Levenberg-Marquardt iterations, each step
accepted only if the robust cost drops, a Huber threshold 10x wider in
round 0, inliers re-gated by chi2 after every round. State Tcw = (R, t),
updated on the left: Tcw <- Exp([rho, phi]) * Tcw.

`jax.lax.scan` becomes a Python loop with no host synchronisation inside:
accept/reject is a `torch.where`, the 6x6 solve is `torch.linalg.solve_ex`
(`torch.linalg.solve` checks its `info` on the host on CUDA). The robust
cost at the current pose is taken from the residuals that were just
linearised — the same function of the same inputs as the reference's
second evaluation.
"""

from __future__ import annotations

from typing import NamedTuple

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
    eye = torch.eye(3, dtype=R.dtype, device=R.device).expand(Xc.shape + (3,))
    dXc = torch.cat([eye, -lie.hat(Xc)], dim=-1)  # (N,3,6)
    J = torch.einsum("nij,njk->nik", Jc3, dXc)
    return e, J, ok, is_stereo


def _chi2(e, obs: PoseObs):
    inv_s2 = 1.0 / obs.sigma2
    return torch.sum(e * e, dim=-1) * inv_s2, inv_s2


def _robust_cost(e, ok, is_stereo, active, obs, hub_mult):
    c2, _ = _chi2(e, obs)
    d2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO) * hub_mult
    rho = torch.where(c2 <= d2, c2, 2.0 * torch.sqrt(d2 * torch.clamp(c2, min=1e-12)) - d2)
    return torch.sum(torch.where(ok & active, rho, 0.0))


def optimize_pose(model: cam.CameraModel, params: torch.Tensor, R0: torch.Tensor,
                  t0: torch.Tensor, obs: PoseObs, bf: float = 0.0, rounds: int = 4,
                  iters_per_round: int = 10) -> PoseResult:
    """The 4x10 schedule of `Optimizer::PoseOptimization` with chi2 re-gating."""
    dev, dt = R0.device, R0.dtype
    eye6 = torch.eye(6, dtype=dt, device=dev)
    R, t = R0, t0
    active = obs.valid
    for rnd in range(rounds):
        # Round 0 widens the Huber quadratic region 10x (cold-start guard).
        hub = torch.full((), 10.0 if rnd == 0 else 1.0, dtype=dt, device=dev)
        lamb = torch.full((), 1e-4, dtype=dt, device=dev)
        for _ in range(iters_per_round):
            e, J, ok, is_stereo = _residuals(model, params, bf, R, t, obs)
            c2, inv_s2 = _chi2(e, obs)
            delta2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO) * hub
            w = torch.where(ok & active, inv_s2 * lm.huber_weight(c2, delta2), 0.0)
            Jw = J * w[:, None, None]
            H = torch.einsum("nij,nik->jk", Jw, J)
            b = torch.einsum("nij,ni->j", Jw, e)
            H_damped = H + lamb * torch.diag(torch.diag(H)) + 1e-9 * eye6
            delta = -torch.linalg.solve_ex(H_damped, b).result
            R_step, t_step = lie.exp_se3(delta)
            R_new, t_new = lie.se3_compose(R_step, t_step, R, t)
            R_new = lie.normalize_rotation(R_new)
            c_old = _robust_cost(e, ok, is_stereo, active, obs, hub)
            e_n, ok_n, st_n, _, _ = _errors(model, params, bf, R_new, t_new, obs)
            c_new = _robust_cost(e_n, ok_n, st_n, active, obs, hub)
            accept = c_new < c_old
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lamb = torch.clamp(torch.where(accept, lamb * 0.5, lamb * 4.0), 1e-9, 1e6)
        # Re-classify against the original valid set (outliers can return).
        e, ok, is_stereo, _, _ = _errors(model, params, bf, R, t, obs)
        c2, _ = _chi2(e, obs)
        active = ok & (c2 <= torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO))

    e, ok, is_stereo, _, _ = _errors(model, params, bf, R, t, obs)
    c2, _ = _chi2(e, obs)
    inlier = ok & (c2 <= torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO))
    return PoseResult(R=R, t=t, inlier=inlier,
                      n_inliers=inlier.to(torch.int32).sum().to(torch.int32), chi2=c2)
