"""Visual-inertial optimization on torch tensors — the port of
`orbslam3_tpu/optim/inertial.py`: the 9-dof preintegration residual
(`EdgeInertial`, `G2oTypes.cc:732-753`) with the bias random walk
(`EdgeGyroRW`/`EdgeAccRW`), the inertial-only MAP of the IMU
initialization (`Optimizer::InertialOptimization`, `Optimizer.cc:5482`) and
the joint visual-inertial BA (`LocalInertialBA` / `FullInertialBA`,
`Optimizer.cc:4753, 473`), its dense branch.

State per keyframe: the 15-dof body state (R_wb, p_wb, v, bg, ba), updated
in the body frame (`ImuCamPose::Update`, `G2oTypes.cc:192`): R <- R Exp(dtheta),
p <- p + R dp.

Jacobians. The reference takes every one from `jax.jacfwd`, mostly inside
`vmap`. The port writes those of the bundle adjustment and of the
pose-inertial solves by hand: the reprojection rows' (the pinhole Jacobian
through the body -> camera chain, `_visual_res_jac`) and the preintegration
rows' (`imu_residual_jac`, ORB-SLAM3's `EdgeInertial::linearizeOplus`).
`torch.func.jacfwd` through the same residuals cost ~80 ms of Python per
pose-inertial iteration (its forward-mode rules fall back to Python
decompositions), and gives a 0-d float32 tensor times a Python float a
float64 tangent (`optim/sim3.py`). Both are held against `torch.func`
Jacobians in `tests/test_torch_inertial.py`, as is the inertial-only MAP's
(`_init_rows`).

Every `lm_loop` is a Python loop with no host read; the linear algebra uses
the `_ex` forms (no host check of the factorization on CUDA).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops import lie
from orbslam3_tpu_torch.optim import lm
from orbslam3_tpu_torch.optim.ba import CameraSums, point_slots, point_sum

STATE_DIM = 15  # [theta(3), p(3), v(3), bg(3), ba(3)]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


class BodyState(NamedTuple):
    R: torch.Tensor  # (K,3,3) R_wb
    p: torch.Tensor  # (K,3) p_wb
    v: torch.Tensor  # (K,3) world velocity
    bg: torch.Tensor  # (K,3)
    ba: torch.Tensor  # (K,3)


def retract(s: BodyState, dx: torch.Tensor) -> BodyState:
    """Apply the per-keyframe 15-dof update (body-frame pose update)."""
    dth, dp, dv, dbg, dba = dx[..., 0:3], dx[..., 3:6], dx[..., 6:9], dx[..., 9:12], dx[..., 12:15]
    R = lie.normalize_rotation(s.R @ lie.exp_so3(dth))
    return BodyState(R=R, p=s.p + _mv(s.R, dp), v=s.v + dv, bg=s.bg + dbg, ba=s.ba + dba)


class ImuEdge(NamedTuple):
    """Preintegrated constraints between keyframes i -> j (leading axis E)."""

    i: torch.Tensor  # (E,) int
    j: torch.Tensor  # (E,)
    dR: torch.Tensor  # (E,3,3)
    dV: torch.Tensor  # (E,3)
    dP: torch.Tensor  # (E,3)
    JRg: torch.Tensor  # (E,3,3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg0: torch.Tensor  # (E,3) linearization bias
    ba0: torch.Tensor
    dT: torch.Tensor  # (E,)
    info: torch.Tensor  # (E,9,9) information of [r_R, r_v, r_p]
    info_rw: torch.Tensor  # (E,6,6) random-walk information [bg, ba]
    valid: torch.Tensor  # (E,) bool


def make_imu_edges(i, j, preints: imu_ops.Preintegrated, valid) -> ImuEdge:
    """Edges from windows stacked along a leading axis E (`imu.stack`)."""
    C = preints.C
    C9 = C[:, :9, :9]
    info9 = torch.linalg.inv_ex(0.5 * (C9 + C9.transpose(-1, -2)) + 1e-10 * _eye(9, C)).inverse
    info9 = 0.5 * (info9 + info9.transpose(-1, -2))
    info_rw = torch.linalg.inv_ex(C[:, 9:, 9:] + 1e-12 * _eye(6, C)).inverse
    return ImuEdge(
        i=i, j=j, dR=preints.dR, dV=preints.dV, dP=preints.dP,
        JRg=preints.JRg, JVg=preints.JVg, JVa=preints.JVa, JPg=preints.JPg, JPa=preints.JPa,
        bg0=preints.bias_gyro.expand(preints.dV.shape),
        ba0=preints.bias_acc.expand(preints.dV.shape),
        dT=preints.dT, info=info9, info_rw=info_rw, valid=valid,
    )


def imu_residual(Ri, pi, vi, bgi, bai, Rj, pj, vj, e_dR, e_dV, e_dP, e_JRg, e_JVg, e_JVa, e_JPg,
                 e_JPa, e_bg0, e_ba0, dt, g):
    """9-dof residual [r_R, r_v, r_p] of edges with a leading axis (ref
    `EdgeInertial::computeError`, `G2oTypes.cc:732`), with the first-order
    bias correction. `dt` is (E,), `g` broadcasts against (E, 3)."""
    dbg = bgi - e_bg0
    dba = bai - e_ba0
    dR_corr = e_dR @ lie.exp_so3(_mv(e_JRg, dbg))
    dV_corr = e_dV + _mv(e_JVg, dbg) + _mv(e_JVa, dba)
    dP_corr = e_dP + _mv(e_JPg, dbg) + _mv(e_JPa, dba)
    RiT = Ri.transpose(-1, -2)
    dt3 = dt[..., None]
    r_R = lie.log_so3(dR_corr.transpose(-1, -2) @ (RiT @ Rj))
    r_v = _mv(RiT, vj - vi - g * dt3) - dV_corr
    r_p = _mv(RiT, pj - pi - vi * dt3 - 0.5 * g * dt3 * dt3) - dP_corr
    return torch.cat([r_R, r_v, r_p], dim=-1)


def imu_residual_jac(Ri, pi, vi, bgi, bai, Rj, pj, vj, e_dR, e_dV, e_dP, e_JRg, e_JVg, e_JVa,
                     e_JPg, e_JPa, e_bg0, e_ba0, dt, g):
    """`imu_residual` and its Jacobians, by hand (ORB-SLAM3's
    `EdgeInertial::linearizeOplus`), under the body-frame retraction
    R <- R Exp(dtheta), p <- p + R dp, v <- v + dv, b <- b + db. Returns
    (r (E,9), Ji (E,9,15) by [theta_i, p_i, v_i, bg_i, ba_i], Jj (E,9,9) by
    [theta_j, p_j, v_j]); the residual does not read j's biases. With
    E = Exp(r_R) = dR_corr^T Ri^T Rj: dr_R/dtheta_i = -Jr^-1(r_R) Rj^T Ri,
    dr_R/dtheta_j = Jr^-1(r_R), dr_R/dbg = -Jr^-1(r_R) E^T Jr(JRg dbg) JRg;
    dr_v/dtheta_i = [Ri^T a_v]x, dr_p/dtheta_i = [Ri^T a_p]x for the
    residuals' world vectors a_v, a_p; the rest is linear."""
    dbg = bgi - e_bg0
    dba = bai - e_ba0
    phi = _mv(e_JRg, dbg)
    dR_corr = e_dR @ lie.exp_so3(phi)
    RiT = Ri.transpose(-1, -2)
    dt3 = dt[..., None]
    E_ = dR_corr.transpose(-1, -2) @ (RiT @ Rj)
    r_R = lie.log_so3(E_)
    a_v = vj - vi - g * dt3
    a_p = pj - pi - vi * dt3 - 0.5 * g * dt3 * dt3
    RiT_av, RiT_ap = _mv(RiT, a_v), _mv(RiT, a_p)
    r = torch.cat([r_R, RiT_av - (e_dV + _mv(e_JVg, dbg) + _mv(e_JVa, dba)),
                   RiT_ap - (e_dP + _mv(e_JPg, dbg) + _mv(e_JPa, dba))], dim=-1)
    Jinv = lie.inv_right_jacobian_so3(r_R)
    z = torch.zeros_like(RiT)
    eye = _eye(3, RiT).expand(RiT.shape)
    dt33 = dt[..., None, None]
    dRR_dbg = -Jinv @ E_.transpose(-1, -2) @ lie.right_jacobian_so3(phi) @ e_JRg
    Ji = torch.cat([
        torch.cat([-Jinv @ Rj.transpose(-1, -2) @ Ri, z, z, dRR_dbg, z], -1),
        torch.cat([lie.hat(RiT_av), z, -RiT, -e_JVg, -e_JVa], -1),
        torch.cat([lie.hat(RiT_ap), -eye, -RiT * dt33, -e_JPg, -e_JPa], -1),
    ], dim=-2)
    Jj = torch.cat([
        torch.cat([Jinv, z, z], -1),
        torch.cat([z, z, RiT], -1),
        torch.cat([z, RiT @ Rj, z], -1),
    ], dim=-2)
    return r, Ji, Jj


def _edge_residual(state: BodyState, e: ImuEdge, g):
    """(r9 (E,9), r_rw (E,6)) of the edges at the states of their ends."""
    ii, jj = e.i.to(torch.int64), e.j.to(torch.int64)
    si = BodyState(*(x[ii] for x in state))
    sj = BodyState(*(x[jj] for x in state))
    r9 = imu_residual(si.R, si.p, si.v, si.bg, si.ba, sj.R, sj.p, sj.v, e.dR, e.dV, e.dP, e.JRg,
                      e.JVg, e.JVa, e.JPg, e.JPa, e.bg0, e.ba0, e.dT, g)
    return r9, torch.cat([sj.bg - si.bg, sj.ba - si.ba], dim=-1)


def _edge_res_jac(state: BodyState, e: ImuEdge, g):
    """Residuals and their Jacobians by each end's 15-dof perturbation:
    (r9, J9i, J9j, r_rw, Jrwi, Jrwj), Jacobians (E, 9|6, 15). Linearized at
    the ends retracted by zero, as the reference's (the rotations
    re-normalized)."""
    ii, jj = e.i.to(torch.int64), e.j.to(torch.int64)
    z = torch.zeros(STATE_DIM, dtype=state.p.dtype, device=state.p.device)
    si = retract(BodyState(*(x[ii] for x in state)), z)
    sj = retract(BodyState(*(x[jj] for x in state)), z)
    r9, J9i, Jj = imu_residual_jac(si.R, si.p, si.v, si.bg, si.ba, sj.R, sj.p, sj.v, e.dR, e.dV,
                                   e.dP, e.JRg, e.JVg, e.JVa, e.JPg, e.JPa, e.bg0, e.ba0, e.dT, g)
    J9j = torch.nn.functional.pad(Jj, (0, 6))
    eye6 = _eye(6, r9).expand(r9.shape[0], 6, 6)
    z69 = torch.zeros((r9.shape[0], 6, 9), dtype=r9.dtype, device=r9.device)
    rrw = torch.cat([sj.bg - si.bg, sj.ba - si.ba], dim=-1)
    return (r9, J9i, J9j, rrw, torch.cat([z69, -eye6], -1), torch.cat([z69, eye6], -1))


# ---------------------------------------------------------------------------
# Inertial-only initialization (scale + gravity + bias + velocities)
# ---------------------------------------------------------------------------


class InertialInitResult(NamedTuple):
    scale: torch.Tensor
    Rwg: torch.Tensor  # (3,3) gravity direction
    bg: torch.Tensor  # (3,) shared gyro bias
    ba: torch.Tensor  # (3,)
    vel: torch.Tensor  # (K,3) per-keyframe world velocities (in the old frame)
    cost: torch.Tensor


def _kron(onehot: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Per edge, kron(onehot (1, K), M (3, 3)) -> (E, 3, 3K)."""
    E, K = onehot.shape
    return (onehot[:, None, :, None] * M[:, :, None, :]).reshape(E, 3, 3 * K)


def _init_rows(x, R_wb, p_wb, edges: ImuEdge, w_valid, L_eff, Rwg0, prior_gyro: float,
               prior_acc: float, fix_scale: bool, jac: bool = False):
    """The inertial-only MAP's whitened residuals at x = [v (3K), bg, ba,
    gravity direction (2), log-scale], and with `jac` their Jacobian by x,
    by hand from `imu_residual_jac`: velocities through each end's velocity
    block, the shared biases through end i's, the log-scale through the
    positions s p (dr_p = Ri^T (s p_j - s p_i) dlog_s), the direction through
    g = Rwg0 Exp([gd, 0]) G0 (dg = -Rwg0 Exp(w) [G0]x Jr(w) dw)."""
    K = R_wb.shape[0]
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    E = ei.shape[0]
    v = x[: 3 * K].reshape(K, 3)
    bg, ba = x[3 * K : 3 * K + 3], x[3 * K + 3 : 3 * K + 6]
    gd, log_s = x[3 * K + 6 : 3 * K + 8], x[3 * K + 8 : 3 * K + 9]
    s = torch.exp(log_s) if not fix_scale else torch.ones_like(log_s)
    w = torch.cat([gd, torch.zeros_like(log_s)])[None]
    Rwg = Rwg0 @ lie.exp_so3(w)[0]
    G0 = imu_ops.gravity(x.device, x.dtype)
    g = _mv(Rwg, G0)
    args = (R_wb[ei], s * p_wb[ei], v[ei], bg.expand(E, 3), ba.expand(E, 3), R_wb[ej],
            s * p_wb[ej], v[ej], edges.dR, edges.dV, edges.dP, edges.JRg, edges.JVg, edges.JVa,
            edges.JPg, edges.JPa, edges.bg0, edges.ba0, edges.dT, g)
    LT = L_eff.transpose(-1, -2)
    r_prior = torch.cat([prior_gyro ** 0.5 * bg, prior_acc ** 0.5 * ba])
    if not jac:
        r_edges = torch.where(w_valid[:, None], _mv(LT, imu_residual(*args)), 0.0)
        return torch.cat([r_edges.reshape(-1), r_prior])
    r, Ji, Jj = imu_residual_jac(*args)
    r_edges = torch.where(w_valid[:, None], _mv(LT, r), 0.0)
    kk = torch.arange(K, device=x.device)
    oi = (ei[:, None] == kk).to(x.dtype)
    oj = (ej[:, None] == kk).to(x.dtype)

    def kron9(onehot, M):  # (E,K) x (E,9,3) -> (E,9,3K)
        return (onehot[:, None, :, None] * M[:, :, None, :]).reshape(E, 9, 3 * K)

    RiT = R_wb[ei].transpose(-1, -2)
    dt = edges.dT[:, None, None]
    z3 = torch.zeros((E, 3, 3), dtype=x.dtype, device=x.device)
    dr_dg = torch.cat([z3, -RiT * dt, -0.5 * RiT * dt * dt], 1)  # (E,9,3)
    dg_dw = -(Rwg @ lie.hat(G0) @ lie.right_jacobian_so3(w)[0])[:, :2]  # (3,2)
    dp = torch.cat([torch.zeros((E, 6), dtype=x.dtype, device=x.device),
                    _mv(RiT, s * (p_wb[ej] - p_wb[ei]))], 1)[..., None]  # (E,9,1)
    if fix_scale:
        dp = torch.zeros_like(dp)
    J = torch.cat([kron9(oi, Ji[:, :, 6:9]) + kron9(oj, Jj[:, :, 6:9]), Ji[:, :, 9:15],
                   dr_dg @ dg_dw, dp], 2)  # (E,9,3K+9)
    J = torch.where(w_valid[:, None, None], LT @ J, 0.0).reshape(E * 9, 3 * K + 9)
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    J_prior = torch.cat([torch.zeros((6, 3 * K), dtype=x.dtype, device=x.device),
                         torch.block_diag(prior_gyro ** 0.5 * eye3, prior_acc ** 0.5 * eye3),
                         torch.zeros((6, 3), dtype=x.dtype, device=x.device)], 1)
    return torch.cat([r_edges.reshape(-1), r_prior]), torch.cat([J, J_prior], 0)


def inertial_only_optimization(R_wb, p_wb, kf_valid, edges: ImuEdge, prior_gyro: float = 1e2,
                               prior_acc: float = 1e6, iters: int = 20,
                               fix_scale: bool = False) -> InertialInitResult:
    """`Optimizer::InertialOptimization` (`Optimizer.cc:5482`): MAP over the
    keyframe velocities, one shared bias pair, the gravity direction (2 dof)
    and the log-scale, with the poses (R_wb (K,3,3), unscaled p_wb (K,3))
    fixed. Seeded by the reference's closed-form linear alignment of
    (velocities, gravity, scale), whose residual floor inflates each edge's
    covariance before the polish (its errors-in-variables guard)."""
    K = R_wb.shape[0]
    dim = 3 * K + 9  # v, bg, ba, gdir, log_s
    ldim = 3 * K + 4
    ei, ej = edges.i.to(torch.int64), edges.j.to(torch.int64)
    E = ei.shape[0]
    w_valid = edges.valid & kf_valid[ei] & kf_valid[ej]
    wv = w_valid.to(R_wb.dtype)

    # Closed-form linear alignment: per edge the preintegration identities
    # are linear in [velocities, gravity, scale].
    RiT = R_wb[ei].transpose(-1, -2)
    dT = edges.dT[:, None, None]
    kk = torch.arange(K, device=RiT.device)
    oi = (ei[:, None] == kk).to(RiT.dtype)  # one-hot rows (`one_hot` checks its range on
    oj = (ej[:, None] == kk).to(RiT.dtype)  # the host)
    z1 = torch.zeros((E, 3, 1), dtype=RiT.dtype, device=RiT.device)
    row_v = torch.cat([_kron(oj, RiT) - _kron(oi, RiT), -dT * RiT, z1], dim=2)
    dp_col = _mv(RiT, p_wb[ej] - p_wb[ei])[..., None]
    row_p = torch.cat([_kron(oi, -dT * RiT), -0.5 * dT * dT * RiT, dp_col], dim=2)
    A_e = torch.where(w_valid[:, None, None], torch.cat([row_v, row_p], dim=1), 0.0)
    b_e = torch.where(w_valid[:, None], torch.cat([edges.dV, edges.dP], dim=-1), 0.0)
    A_lin = A_e.reshape(-1, ldim)
    b_lin = b_e.reshape(-1)
    Hl = A_lin.T @ A_lin + 1e-6 * _eye(ldim, A_lin)
    xl = torch.linalg.solve_ex(Hl, A_lin.T @ b_lin).result
    v_lin = xl[: 3 * K].reshape(K, 3)
    g_lin = xl[3 * K : 3 * K + 3]
    s_lin = torch.clamp(xl[3 * K + 3 : 3 * K + 4], 0.05, 20.0)  # (1,)

    # Gravity-direction seed from the linear solve.
    dirG = g_lin / torch.clamp(torch.linalg.norm(g_lin), min=1e-9)
    gI = imu_ops.gravity(dirG.device, dirG.dtype) / imu_ops.GRAVITY_VALUE  # (0, 0, -1)
    axis = torch.linalg.cross(gI, dirG)
    sin_a = torch.linalg.norm(axis)
    cos_a = torch.sum(gI * dirG)
    ang = torch.atan2(sin_a, cos_a)
    Rwg0 = lie.exp_so3((axis / torch.clamp(sin_a, min=1e-9) * ang)[None])[0]

    # The residual floor of the linear seed (IMU noise plus map noise),
    # added to each edge's covariance before inverting.
    zE = torch.zeros((E, 3), dtype=RiT.dtype, device=RiT.device)
    r9_seed = imu_residual(
        R_wb[ei], s_lin * p_wb[ei], v_lin[ei], zE, zE, R_wb[ej], s_lin * p_wb[ej], v_lin[ej],
        edges.dR, edges.dV, edges.dP, edges.JRg, edges.JVg, edges.JVa, edges.JPg, edges.JPa,
        edges.bg0, edges.ba0, edges.dT, 9.81 * dirG)
    n_val = torch.clamp(torch.sum(wv), min=1.0)
    var_blk = torch.stack([torch.sum(wv * torch.sum(r9_seed[:, b : b + 3] ** 2, -1))
                           / (3.0 * n_val) for b in (0, 3, 6)])
    infl = torch.repeat_interleave(var_blk, 3)
    eye9 = _eye(9, RiT)
    C9 = torch.linalg.inv_ex(edges.info).inverse
    info_eff = torch.linalg.inv_ex(C9 + torch.diag(infl)[None] + 1e-12 * eye9[None]).inverse
    info_eff = 0.5 * (info_eff + info_eff.transpose(-1, -2))
    L_eff = torch.linalg.cholesky_ex(info_eff + 1e-8 * eye9[None]).L

    def residuals(x, jac=False):
        return _init_rows(x, R_wb, p_wb, edges, w_valid, L_eff, Rwg0, prior_gyro, prior_acc,
                          fix_scale, jac)

    log_s0 = torch.zeros_like(s_lin) if fix_scale else torch.log(s_lin)
    x0 = torch.cat([v_lin.reshape(-1), torch.zeros(8, dtype=xl.dtype, device=xl.device), log_s0])
    eye_d = _eye(dim, x0)

    def step(params, lamb):
        (x,) = params
        r, J = residuals(x, jac=True)
        H = J.T @ J
        b = J.T @ r
        H = H + lamb * torch.diag(torch.diag(H)) + 1e-8 * eye_d
        return (x - torch.linalg.solve_ex(H, b).result,)

    def cost(params):
        r = residuals(params[0])
        return torch.sum(r * r)

    (x,), c = lm.lm_loop((x0,), cost, step, iters)
    s = torch.exp(x[3 * K + 8]) if not fix_scale else torch.ones_like(x[0])
    w = torch.cat([x[3 * K + 6 : 3 * K + 8], torch.zeros_like(x[:1])])[None]
    return InertialInitResult(scale=s, Rwg=Rwg0 @ lie.exp_so3(w)[0], bg=x[3 * K : 3 * K + 3],
                              ba=x[3 * K + 3 : 3 * K + 6], vel=x[: 3 * K].reshape(K, 3), cost=c)


# ---------------------------------------------------------------------------
# Visual-inertial bundle adjustment
# ---------------------------------------------------------------------------


class VIProblem(NamedTuple):
    state: BodyState  # (K,) body states
    kf_fixed: torch.Tensor  # (K,) bool: fixes the POSE only; velocity and
    # biases of a fixed keyframe stay estimated through the IMU chain
    # (`Optimizer.cc:FullInertialBA:500-520`)
    Tcb_R: torch.Tensor  # (3,3) camera <- body
    Tcb_t: torch.Tensor  # (3,)
    points: torch.Tensor  # (P,3)
    point_valid: torch.Tensor  # (P,)
    obs_cam: torch.Tensor  # (O,) keyframe index
    obs_point: torch.Tensor  # (O,)
    obs_uv: torch.Tensor  # (O,2)
    obs_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,)
    edges: ImuEdge


class VIResult(NamedTuple):
    state: BodyState
    points: torch.Tensor
    cost: torch.Tensor
    obs_inlier: torch.Tensor


def _visual_res_jac(model, params, Tcb_R, Tcb_t, R, p, Xw, uv):
    """Reprojection residuals of observations (leading axis O) and their
    Jacobians by the body's [dtheta, dp] (O,2,6) and by the point (O,2,3),
    with the depth. Tcw = Tcb * Tbw; the body point
    Xb = Exp(-dtheta) R^T (X - p - R dp) moves by [Xb]x dtheta - dp."""
    Xb = _mv(R.transpose(-1, -2), Xw - p)
    Xc = _mv(Tcb_R, Xb) + Tcb_t
    r = cam.project(model, params, Xc) - uv
    JcB = cam.project_jac(model, params, Xc) @ Tcb_R  # (O,2,3): by Xb
    Jx = torch.cat([JcB @ lie.hat(Xb), -JcB], dim=-1)
    Jp = JcB @ R.transpose(-1, -2)
    return r, Jx, Jp, Xc[..., 2]


def _visual_residual(model, params, Tcb_R, Tcb_t, R, p, Xw, uv):
    Xc = _mv(Tcb_R, _mv(R.transpose(-1, -2), Xw - p)) + Tcb_t
    return cam.project(model, params, Xc) - uv, Xc[..., 2]


def coupling_bytes(P: int, K: int) -> int:
    """Bytes of the dense branch's (P, K, 3, 6) float32 point-keyframe
    coupling tensor."""
    return P * K * 3 * 6 * 4


def solve_vi_ba(model: cam.CameraModel, params: torch.Tensor, prob: VIProblem, iters: int = 8,
                pcg_iters: int = 50, huber_mono: float = lm.CHI2_MONO, prior_gyro: float = 1e2,
                prior_acc: float = 1e6, dense_solve: bool = True,
                axis_name: Optional[str] = None, obs_per_cam: Optional[int] = None) -> VIResult:
    """Joint visual-inertial BA (`LocalInertialBA` `Optimizer.cc:4753` /
    `FullInertialBA` `:473`): 15-dof keyframe states, Schur-eliminated
    points, the IMU chain and the bias random walk in the reduced system,
    zero-bias priors (`prior_gyro`, `prior_acc`) on the first free
    keyframe (`EdgePriorGyro/Acc`). The reduced (15K)^2 system is assembled
    densely: block-diagonal keyframe blocks, the IMU off-diagonal blocks,
    minus the visual Schur term through the (P, K, 3, 6) point-keyframe
    coupling; Jacobi-rescaled (whitened IMU rows are ~1e8 against visual
    ~1) and solved once per iteration. The matrix-free PCG branch and the
    sharded form are ROADMAP A15.

    Sums run in a fixed order, so that a solve on the card repeats exactly
    (CUDA's `index_add_` adds in no fixed order): a point's sums go through
    its (point, keyframe) slots (`ba.point_sum`, as the visual BA's), a
    keyframe's through `ba.CameraSums` (with `obs_per_cam`, observations laid
    out keyframe by keyframe, that many each, as the mapper lays them out, a
    reduction over its block)."""
    if not dense_solve:
        raise NotImplementedError("the PCG path of solve_vi_ba is ROADMAP A15")
    if axis_name is not None:
        raise NotImplementedError("the sharded solve_vi_ba is ROADMAP A15")
    del pcg_iters
    K = prob.state.R.shape[0]
    P = prob.points.shape[0]
    ref = prob.points
    g = imu_ops.gravity(ref.device, ref.dtype)
    obs_cam = prob.obs_cam.to(torch.int64)
    obs_point = prob.obs_point.to(torch.int64)
    ei, ej = prob.edges.i.to(torch.int64), prob.edges.j.to(torch.int64)
    eye3, eye15 = _eye(3, ref), _eye(STATE_DIM, ref)
    kf_fixed = prob.kf_fixed
    free_dim = torch.where(kf_fixed[:, None],
                           (torch.arange(STATE_DIM, device=ref.device) >= 6)[None, :],
                           torch.ones((1, STATE_DIM), dtype=torch.bool, device=ref.device))
    first_free = (torch.arange(K, device=ref.device)
                  == torch.argmax((~kf_fixed).to(torch.int32))).to(ref.dtype)  # one-hot (K,)
    ok_base = prob.obs_valid & prob.point_valid[obs_point]

    def pt_sum(vals):
        return point_sum(vals, obs_point, obs_cam, P, K)

    cam_sum = CameraSums(obs_cam, K, obs_per_cam, ref.dtype)

    def gn_step(state_tuple, lamb):
        state, points = state_tuple
        # ---- visual part -------------------------------------------------
        r_v, Jx, Jp, depth = _visual_res_jac(model, params, prob.Tcb_R, prob.Tcb_t,
                                             state.R[obs_cam], state.p[obs_cam],
                                             points[obs_point], prob.obs_uv)
        ok = ok_base & (depth > 1e-3)
        inv_s2 = 1.0 / prob.obs_sigma2
        chi2 = torch.sum(r_v * r_v, -1) * inv_s2
        w = torch.where(ok, inv_s2 * lm.huber_weight(chi2, huber_mono), 0.0)
        free = (~kf_fixed[obs_cam]).to(ref.dtype)
        sw = torch.sqrt(w)
        # Rows outside `ok` are zeroed, not only weighted (fault C14: the
        # Kannala-Brandt 8 Jacobian is NaN at the camera centre, where an
        # unobserved row's slot-0 point can sit, and 0 * NaN is NaN).
        okr = ok[:, None, None]
        Jx_w = torch.where(okr, Jx * (sw * free)[:, None, None], 0.0)  # (O,2,6)
        Jp_w = torch.where(okr, Jp * sw[:, None, None], 0.0)  # (O,2,3)
        e_w = torch.where(ok[:, None], r_v * sw[:, None], 0.0)
        Hpp = pt_sum(torch.einsum("oij,oik->ojk", Jp_w, Jp_w))
        bp = -pt_sum(torch.einsum("oij,oi->oj", Jp_w, e_w))
        Hcc_vis = cam_sum(torch.einsum("oij,oik->ojk", Jx_w, Jx_w))
        bc_vis = -cam_sum(torch.einsum("oij,oi->oj", Jx_w, e_w))

        # ---- inertial part ----------------------------------------------
        r9, J9i, J9j, rrw, Jrwi, Jrwj = _edge_res_jac(state, prob.edges, g)
        L9 = torch.linalg.cholesky_ex(prob.edges.info + 1e-8 * _eye(9, ref)).L.transpose(-1, -2)
        Lrw = torch.linalg.cholesky_ex(prob.edges.info_rw + 1e-8 * _eye(6, ref)).L.transpose(-1, -2)
        m = prob.edges.valid.to(ref.dtype)[:, None]
        # Pose-only fixing: the pose columns of fixed keyframes are zeroed.
        fi = free_dim[ei].to(ref.dtype)[:, None, :]
        fj = free_dim[ej].to(ref.dtype)[:, None, :]
        r9 = m * _mv(L9, r9)
        J9i = m[..., None] * (L9 @ J9i) * fi
        J9j = m[..., None] * (L9 @ J9j) * fj
        rrw = m * _mv(Lrw, rrw)
        Jrwi = m[..., None] * (Lrw @ Jrwi) * fi
        Jrwj = m[..., None] * (Lrw @ Jrwj) * fj

        # ---- the reduced (keyframe-state) system -------------------------
        Hkk = torch.nn.functional.pad(Hcc_vis, (0, 9, 0, 9))
        bk = torch.nn.functional.pad(bc_vis, (0, 9))

        def gram(A, B):
            return torch.einsum("eai,eaj->eij", A, B)

        Hii = gram(J9i, J9i) + gram(Jrwi, Jrwi)
        Hjj = gram(J9j, J9j) + gram(Jrwj, Jrwj)
        Hij = gram(J9i, J9j) + gram(Jrwi, Jrwj)
        bi = torch.einsum("eai,ea->ei", J9i, r9) + torch.einsum("eai,ea->ei", Jrwi, rrw)
        bj = torch.einsum("eai,ea->ei", J9j, r9) + torch.einsum("eai,ea->ei", Jrwj, rrw)
        Hkk = Hkk.index_add(0, ei, Hii).index_add(0, ej, Hjj)
        bk = bk.index_add(0, ei, -bi).index_add(0, ej, -bj)

        # Bias priors on the first free keyframe.
        prior_blk = torch.block_diag(torch.zeros((9, 9), dtype=ref.dtype, device=ref.device),
                                     prior_gyro * eye3, prior_acc * eye3)
        Hkk = Hkk + first_free[:, None, None] * prior_blk
        bg_ff = torch.sum(first_free[:, None] * state.bg, 0)
        ba_ff = torch.sum(first_free[:, None] * state.ba, 0)
        zeros9 = torch.zeros(9, dtype=ref.dtype, device=ref.device)
        bk = bk + first_free[:, None] * torch.cat([zeros9, -prior_gyro * bg_ff,
                                                   -prior_acc * ba_ff])[None]

        # Damping, and identity rows for the frozen pose dims.
        Hkk = Hkk + lamb * torch.abs(Hkk) * eye15[None] + 1e-6 * eye15[None]
        fd = free_dim.to(ref.dtype)
        Hkk = Hkk * fd[:, :, None] * fd[:, None, :]
        Hkk = Hkk + (1.0 - fd)[:, :, None] * eye15[None]
        bk = bk * fd
        Hpp2 = Hpp + lamb * torch.abs(Hpp) * eye3[None] + 1e-7 * eye3[None]
        Hpp_inv = lm.inv3x3(Hpp2)

        # Reduced right-hand side.
        y0 = _mv(Hpp_inv, bp)
        v0 = _mv(Jp_w, y0[obs_point])
        b_red = bk - torch.nn.functional.pad(cam_sum(torch.einsum("oij,oi->oj", Jx_w, v0)),
                                             (0, 9))

        # Dense reduced system: blockdiag(Hkk) + IMU off-diagonals - the
        # visual Schur term through the per-(point, keyframe) 3x6 coupling.
        dim = K * STATE_DIM
        JpTJx = torch.einsum("oia,oib->oab", Jp_w, Jx_w)  # (O,3,6)
        Bpk = point_slots(JpTJx, obs_point, obs_cam, P, K)  # (P,K,3,6)
        HB = torch.einsum("pij,pkjb->pkib", Hpp_inv, Bpk)  # (P,K,3,6)
        Bm = Bpk.permute(0, 2, 1, 3).reshape(P * 3, K * 6)
        HBm = HB.permute(0, 2, 1, 3).reshape(P * 3, K * 6)
        S_schur = (Bm.T @ HBm).reshape(K, 6, K, 6)
        ar = torch.arange(K, device=ref.device)
        S4 = torch.zeros((K, K, STATE_DIM, STATE_DIM), dtype=ref.dtype, device=ref.device)
        S4[ar, ar] = Hkk
        S4 = S4.index_put((ei, ej), Hij, accumulate=True)
        S4 = S4.index_put((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        S = S4.permute(0, 2, 1, 3).clone()  # (K,15,K,15)
        S[:, :6, :, :6] -= S_schur
        S = S.reshape(dim, dim)
        S = 0.5 * (S + S.T)
        # Jacobi rescaling: fatal for a float32 solve without it.
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        S_s = S / d[:, None] / d[None, :] + 1e-7 * _eye(dim, ref)
        y = torch.linalg.solve_ex(S_s, b_red.reshape(-1) / d).result
        dx = (y / d).reshape(K, STATE_DIM) * fd

        # Back-substitute the points.
        u = _mv(Jx_w, dx[obs_cam, :6])
        tp = pt_sum(torch.einsum("oij,oi->oj", Jp_w, u))
        dp = _mv(Hpp_inv, bp - tp)
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        return (retract(state, dx), points + dp)

    def chi2_of(state, points):
        r_v, depth = _visual_residual(model, params, prob.Tcb_R, prob.Tcb_t, state.R[obs_cam],
                                      state.p[obs_cam], points[obs_point], prob.obs_uv)
        return torch.sum(r_v * r_v, -1) / prob.obs_sigma2, ok_base & (depth > 1e-3)

    def cost_fn(state_tuple):
        state, points = state_tuple
        chi2, ok = chi2_of(state, points)
        rho = torch.where(chi2 <= huber_mono, chi2,
                          2.0 * torch.sqrt(huber_mono * torch.clamp(chi2, min=1e-12)) - huber_mono)
        c_vis = torch.sum(torch.where(ok, rho, 0.0))
        r9, rrw = _edge_residual(state, prob.edges, g)
        c = (torch.einsum("ei,eij,ej->e", r9, prob.edges.info, r9)
             + torch.einsum("ei,eij,ej->e", rrw, prob.edges.info_rw, rrw))
        c_imu = torch.sum(torch.where(prob.edges.valid, c, 0.0))
        bg_ff = torch.sum(first_free[:, None] * state.bg, 0)
        ba_ff = torch.sum(first_free[:, None] * state.ba, 0)
        c_prior = prior_gyro * torch.sum(bg_ff ** 2) + prior_acc * torch.sum(ba_ff ** 2)
        return c_vis + c_imu + c_prior

    (state, points), cost = lm.lm_loop((prob.state, prob.points), cost_fn, gn_step, iters)
    chi2, ok = chi2_of(state, points)
    return VIResult(state=state, points=points, cost=cost, obs_inlier=ok & (chi2 <= huber_mono))
