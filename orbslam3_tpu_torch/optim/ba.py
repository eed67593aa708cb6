"""Bundle adjustment on torch tensors — the dense-Schur path of
`orbslam3_tpu/optim/ba.py` (`_solve_ba_dense`) on one device, with its
residuals (`_linearize`, mono and stereo-`ur` rows), robust cost and
closed-form 3x3 Cholesky. The matrix-free PCG path waits for ROADMAP A9,
the two-camera rig rows for A12 and the sharded layouts for A15.

The problem is a fixed-shape batch: cameras (C), points (P), observations
(O) with validity masks. Per LM iteration the reduced camera system
S = Hcc - W Hpp^-1 W^T over the first `n_opt` cameras is built explicitly
and solved by one dense Cholesky; a rejected step re-damps the stored
linearization.

Host synchronisation: none. The reference's `while_loop` with early stop
runs here as `iters` iterations of the same body; once the stop condition
holds, the accepted state is frozen with `torch.where`, so the result is the
reference's. Its `lax.cond` accept is a `torch.where` on each carried
tensor, and the Cholesky is `cholesky_ex` (no error check on the host).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import lie
from orbslam3_tpu_torch.optim import lm


class BAProblem(NamedTuple):
    cam_R: torch.Tensor  # (C,3,3) Tcw rotations
    cam_t: torch.Tensor  # (C,3)
    cam_fixed: torch.Tensor  # (C,) bool
    points: torch.Tensor  # (P,3) world positions
    point_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) int
    obs_point: torch.Tensor  # (O,) int
    obs_uv: torch.Tensor  # (O,2)
    obs_ur: torch.Tensor  # (O,) right-u; <0 => mono
    obs_sigma2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,) bool


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool, chi2-gated at the final state
    cost: torch.Tensor


def _linearize(model, params, bf, cam_R, cam_t, points, prob: BAProblem, active):
    """Whitened residuals and Jacobians for every observation.

    Returns e_w (O,3), Jc_w (O,3,6), Jp_w (O,3,3), chi2 (O,), ok (O,),
    is_stereo (O,).

    Finite-row gating (fault C4): the weighted rows are zeroed elementwise
    where `ok` is false. The reference multiplies them by a zero weight
    instead, and 0 * NaN is NaN: one observation of a non-finite point
    then poisons the reduced camera system, whose Cholesky fails every
    iteration, and the solve moves no camera. On a finite problem the rows
    outside `ok` have zero weight and finite Jacobians, so this gating
    changes nothing.
    """
    oc = prob.obs_cam.to(torch.int64)
    op = prob.obs_point.to(torch.int64)
    Rc = cam_R[oc]
    Xc = lie.se3_apply(Rc, cam_t[oc], points[op])
    z = Xc[..., 2]
    uv_hat = cam.project(model, params, Xc)
    Jproj = cam.project_jac(model, params, Xc)  # (O,2,3)
    is_stereo = prob.obs_ur >= 0.0
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    ur_hat = uv_hat[..., 0] - bf * inv_z
    e = torch.cat([uv_hat - prob.obs_uv,
                   torch.where(is_stereo, ur_hat - prob.obs_ur, 0.0)[..., None]], dim=-1)

    zero = torch.zeros_like(z)
    Jur = Jproj[:, 0, :] + torch.stack([zero, zero, bf * inv_z * inv_z], dim=-1)
    Jur = torch.where(is_stereo[:, None], Jur, 0.0)
    JXc = torch.cat([Jproj, Jur[:, None, :]], dim=1)  # (O,3,3) de/dXc
    # Camera: left-multiplied update of Tcw -> dXc/d[rho,phi] = [I | -hat(Xc)].
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape + (3,))
    Jc = JXc @ torch.cat([eye, -lie.hat(Xc)], dim=-1)  # (O,3,6)
    Jp = JXc @ Rc  # dXc/dXw = Rc

    inv_s2 = 1.0 / prob.obs_sigma2
    chi2 = torch.sum(e * e, dim=-1) * inv_s2
    ok = (active & prob.obs_valid & (z > 1e-3) & prob.point_valid[op] & torch.isfinite(chi2))
    delta2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    w = torch.where(ok, inv_s2 * lm.huber_weight(chi2, delta2), 0.0)
    sw = torch.sqrt(w)
    cam_free = ~prob.cam_fixed[oc]
    okr = ok[:, None, None]
    Jc_w = torch.where(okr & cam_free[:, None, None], Jc * sw[:, None, None], 0.0)
    Jp_w = torch.where(okr, Jp * sw[:, None, None], 0.0)
    e_w = torch.where(ok[:, None], e * sw[:, None], 0.0)
    return e_w, Jc_w, Jp_w, chi2, ok, is_stereo


def _robust_cost(chi2, ok, is_stereo, n_struct=None):
    """Huber-robust total cost. Rows counted in `n_struct` (valid
    observation of a valid point) that the current state puts outside `ok`
    cost 1e3 each, so a candidate that invalidates observations cannot win
    the accept test by scoring 0."""
    d2 = torch.where(is_stereo, lm.CHI2_STEREO, lm.CHI2_MONO)
    rho = torch.where(chi2 <= d2, chi2,
                      2.0 * torch.sqrt(d2 * torch.clamp(chi2, min=1e-12)) - d2)
    cost = torch.sum(torch.where(ok, rho, 0.0))
    if n_struct is not None:
        cost = cost + 1e3 * (n_struct - torch.sum(ok.to(torch.float32)))
    return cost


def _chol3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched lower Cholesky of SPD (..., 3, 3)."""
    a11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=1e-20))
    l21 = A[..., 1, 0] / a11
    l31 = A[..., 2, 0] / a11
    a22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=1e-20))
    l32 = (A[..., 2, 1] - l31 * l21) / a22
    a33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32, min=1e-20))
    z = torch.zeros_like(a11)
    return torch.stack([
        torch.stack([a11, z, z], -1),
        torch.stack([l21, a22, z], -1),
        torch.stack([l31, l32, a33], -1),
    ], -2)


def _block_diag(X: torch.Tensor) -> torch.Tensor:
    """(n,k,k) blocks -> (n,k,n,k) with X[i] at [i, :, i, :] and zeros elsewhere."""
    n = X.shape[0]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    return eye[:, None, :, None] * X[:, :, None, :]


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


class _Lin(NamedTuple):
    """One linearization: everything a damped re-solve needs."""

    S_und: torch.Tensor  # (n,6,n,6) undamped reduced camera system
    b_red: torch.Tensor  # (n,6)
    Hcc_w: torch.Tensor  # (n,6,6)
    bp: torch.Tensor  # (P,3)
    Hpp_inv: torch.Tensor  # (P,3,3)
    Jc_w: torch.Tensor
    Jp_w: torch.Tensor
    inlier: torch.Tensor  # (O,) bool
    cost: torch.Tensor


def _solve_ba_dense(model, params, prob: BAProblem, bf, iters, point_damping,
                    n_opt_prefix=None, obs_per_cam=None, early_stop_tol=None) -> BAResult:
    """Explicit-reduced-camera-system LM with deferred accept: each
    iteration linearizes the candidate once, and its cost decides whether the
    previous step is kept. `n_opt_prefix`: the optimizable cameras are the
    first n rows (S spans only them). `obs_per_cam`: observations are
    camera-major with this many per camera (Hcc, bc by one batched matmul).
    `early_stop_tol`: stop after an accepted step that lowers the cost by a
    relative amount below it."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    O = prob.obs_cam.shape[0]
    n_opt = C if n_opt_prefix is None else int(n_opt_prefix)
    dev, dtype = prob.cam_R.device, prob.cam_R.dtype
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    fixed = prob.cam_fixed
    fixed_w = fixed[:n_opt]
    oc = prob.obs_cam.to(torch.int64)
    op = prob.obs_point.to(torch.int64)
    n_struct = torch.sum((prob.obs_valid & prob.point_valid[op]).to(torch.float32))
    active = torch.ones_like(prob.obs_valid)

    # A (point, camera) pair holds at most one observation, so the coupling
    # blocks are a placement: index map (P*n_opt -> obs row) built once;
    # invalid and fixed-camera rows go to a dump slot that is sliced away.
    in_win = oc < n_opt
    pk = op * n_opt + torch.where(in_win, oc, 0)
    pk_safe = torch.where(prob.obs_valid & in_win, pk, P * n_opt)
    inv_idx = torch.full((P * n_opt + 1,), O, dtype=torch.int64, device=dev)
    inv_idx[pk_safe] = torch.arange(O, dtype=torch.int64, device=dev)
    inv_idx = inv_idx[: P * n_opt]

    def cam_reduce(Jc_w, e_w):
        """(Hcc (C,6,6), bc (C,6))."""
        if obs_per_cam is not None:
            A = torch.cat([Jc_w, e_w[:, :, None]], dim=-1).reshape(C, int(obs_per_cam) * 3, 7)
            H7 = A.transpose(1, 2) @ A  # (C,7,7)
            return H7[:, :6, :6], -H7[:, :6, 6]
        Hcc = _segment_sum(Jc_w.transpose(1, 2) @ Jc_w, oc, C)
        bc = -_segment_sum(torch.einsum("oij,oi->oj", Jc_w, e_w), oc, C)
        return Hcc, bc

    def linearize_pack(cam_R, cam_t, points) -> _Lin:
        e_w, Jc_w, Jp_w, chi2, ok, is_st = _linearize(
            model, params, bf, cam_R, cam_t, points, prob, active)
        cost = _robust_cost(chi2, ok, is_st, n_struct=n_struct)
        inlier = ok & (chi2 <= torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO))
        Hcc, bc = cam_reduce(Jc_w, e_w)
        # Point side as one fused (O,12) segment sum: [Jp^T Jp | -Jp^T e].
        pp = (Jp_w.transpose(1, 2) @ Jp_w).reshape(O, 9)
        pe = -torch.einsum("oij,oi->oj", Jp_w, e_w)
        ppe = _segment_sum(torch.cat([pp, pe], dim=-1), op, P)
        Hpp = ppe[:, :9].reshape(P, 3, 3)
        bp = ppe[:, 9:]
        # Lambda-independent point damping, so a rejected step re-damps S only.
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hpp_inv = lm.inv3x3(Hpp + (point_damping + 1e-4 * torch.abs(Hpp)) * eye3)
        L = _chol3x3(Hpp_inv)  # Hpp_d^-1 = L L^T
        # G_o = L_p^T Jp_o^T Jc_o placed into B (P, n, 3, 6): S_cross = B^T B.
        G = (Jp_w @ L[op]).transpose(1, 2) @ Jc_w  # (O,3,6)
        G = torch.cat([G.reshape(O, 18), torch.zeros((1, 18), dtype=dtype, device=dev)])
        B = G[inv_idx].reshape(P, n_opt, 3, 6)
        Bm = B.permute(0, 2, 1, 3).reshape(3 * P, 6 * n_opt)
        S_cross = (Bm.T @ Bm).reshape(n_opt, 6, n_opt, 6)
        y0 = torch.einsum("pij,pj->pi", Hpp_inv, bp)
        v = torch.einsum("oij,oj->oi", Jp_w, y0[op])  # b_red = bc - W^T y0, per obs
        wv = torch.einsum("oij,oi->oj", Jc_w, v)
        if obs_per_cam is not None:
            wy = wv.reshape(C, int(obs_per_cam), 6).sum(dim=1)
        else:
            wy = _segment_sum(wv, oc, C)
        S_und = _block_diag(Hcc[:n_opt]) - S_cross
        return _Lin(S_und, (bc - wy)[:n_opt], Hcc[:n_opt], bp, Hpp_inv, Jc_w, Jp_w,
                    inlier, cost)

    keep = (~fixed_w).to(dtype)
    fixed_eye = _block_diag(torch.where(fixed_w, 1.0, 0.0).to(dtype)[:, None, None] * eye6)
    jitter = 1e-7 * torch.eye(n_opt * 6, dtype=dtype, device=dev)

    def damped_step(lin: _Lin, state, lamb):
        cam_R, cam_t, points = state
        damp = lamb * torch.abs(lin.Hcc_w) * eye6 + 1e-8 * eye6
        S_g = lin.S_und + _block_diag(damp)
        S_g = S_g * keep[:, None, None, None] * keep[None, None, :, None] + fixed_eye
        S = S_g.reshape(n_opt * 6, n_opt * 6)
        S = 0.5 * (S + S.T)
        rhs = torch.where(fixed_w[:, None], 0.0, lin.b_red)
        Lc, info = torch.linalg.cholesky_ex(S + jitter, check_errors=False)
        dc_w = torch.cholesky_solve(rhs.reshape(-1, 1), Lc).reshape(n_opt, 6)
        # Self-healing on a failed factorization: a zero step cannot be
        # accepted, so the loop raises lambda instead of writing NaN poses.
        # (`cholesky_ex` leaves a finite partial factor where JAX returns
        # NaN, hence the `info` test beside the finiteness test.)
        good = torch.isfinite(dc_w).all() & (info == 0)
        dc_w = torch.where(good & ~fixed_w[:, None], dc_w, 0.0)
        dc = torch.cat([dc_w, torch.zeros((C - n_opt, 6), dtype=dtype, device=dev)])
        # Back-substitute points at observation level.
        u = torch.einsum("oij,oj->oi", lin.Jc_w, dc[oc])
        tp = _segment_sum(torch.einsum("oij,oi->oj", lin.Jp_w, u), op, P)
        dp = torch.einsum("pij,pj->pi", lin.Hpp_inv, lin.bp - tp)
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        dR, dt = lie.exp_se3(dc)
        R_new, t_new = lie.se3_compose(dR, dt, cam_R, cam_t)
        R_new = lie.normalize_rotation(R_new)
        R_new = torch.where(fixed[:, None, None], cam_R, R_new)
        t_new = torch.where(fixed[:, None], cam_t, t_new)
        return (R_new, t_new, points + dp)

    base = (prob.cam_R, prob.cam_t, prob.points)
    lin = linearize_pack(*base)
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    cand = damped_step(lin, base, lam)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        lin_c = linearize_pack(*cand)
        accept = lin_c.cost < lin.cost
        # After the stop, nothing is accepted any more: base and lin (the
        # result) stay frozen, as when the reference's while_loop exits.
        take = accept & ~done
        if early_stop_tol is not None:
            rel = (lin.cost - lin_c.cost) / torch.clamp(lin.cost, min=1e-12)
            done = done | (take & (rel < early_stop_tol))
        base = tuple(torch.where(take, c, b) for c, b in zip(cand, base))
        lin = _Lin(*(torch.where(take, c, b) for c, b in zip(lin_c, lin)))
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        cand = damped_step(lin, base, lam)
    cam_R, cam_t, points = base
    return BAResult(cam_R=cam_R, cam_t=cam_t, points=points, obs_inlier=lin.inlier,
                    cost=lin.cost)


def solve_ba(model: cam.CameraModel, params: torch.Tensor, prob: BAProblem, bf: float = 0.0,
             iters: int = 10, point_damping: float = 1e-6, dense_schur: bool = False,
             n_opt_prefix: Optional[int] = None, obs_per_cam: Optional[int] = None,
             early_stop_tol: Optional[float] = None) -> BAResult:
    """LM bundle adjustment. Only the dense-Schur path is ported."""
    if not dense_schur:
        raise NotImplementedError(
            "the matrix-free PCG path of solve_ba is not ported yet (ROADMAP A9)")
    return _solve_ba_dense(model, params, prob, bf, iters, point_damping,
                           n_opt_prefix=n_opt_prefix, obs_per_cam=obs_per_cam,
                           early_stop_tol=early_stop_tol)
