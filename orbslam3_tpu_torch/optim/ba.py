"""Bundle adjustment on torch tensors — `orbslam3_tpu/optim/ba.py` on one
device: the dense-Schur path (`_solve_ba_dense`) and the matrix-free PCG path
(`_solve_ba_pcg`, with `lm.pcg`), with their residuals (`_linearize`: mono
and stereo-`ur` rows, and with `cam2` a two-camera rig's right-camera rows),
robust cost and closed-form 3x3 Cholesky. `auto_dense_schur` chooses between
them by the reference's memory budget.

Both paths also run sharded over a `torch.distributed` group (`group`, the
reference's `axis_name`; `parallel/ba_sharded.py` lays the problem out):
with the observations sharded and the state replicated, every sum over
observations is a local sum and one all-reduce (the PCG path: one per CG
product; the dense path: the point blocks, the cameras' blocks and the cost
in one, the coupling tensor, the reduced right-hand side, the
back-substitution); with the points sharded as well (`point_axis_local`,
each rank owns its points and all their observations) the point sums need
none, and the dense path's only collective is one all-reduce of the packed
(S, b_red, Hcc, cost) per linearization. The accept test reads the
all-reduced cost, so every rank takes the same decision.

The problem is a fixed-shape batch: cameras (C), points (P), observations
(O) with validity masks. On the dense path, per LM iteration the reduced
camera system S = Hcc - W Hpp^-1 W^T over the first `n_opt` cameras is built
explicitly and solved by one dense Cholesky; a rejected step re-damps the
stored linearization. On the PCG path S is never formed: each LM iteration
runs a fixed number of conjugate-gradient steps on it, each a product with
W Hpp^-1 W^T through the observations, preconditioned by the inverse of
each camera's 6x6 block (`inv_ex`, no host check).

Sums over observations go through `point_sum` and `CameraSums`: on the
CPU `index_add_` in row order (the reference's `segment_sum`), on CUDA a
fixed order, so a solve repeats bit for bit from run to run.

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
from orbslam3_tpu_torch.parallel import comm


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
    # Two-camera rigs: rows flagged here project through Trl * Tcw into the
    # right camera (`EdgeSE3ProjectXYZToBody`); None = every row is left.
    obs_right: Optional[torch.Tensor] = None  # (O,) bool


class BAResult(NamedTuple):
    cam_R: torch.Tensor
    cam_t: torch.Tensor
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool, chi2-gated at the final state
    cost: torch.Tensor


def _linearize(model, params, bf, cam_R, cam_t, points, prob: BAProblem, active,
               cam2=None):
    """Whitened residuals and Jacobians for every observation.

    `cam2 = (params2, R_rl, t_rl)`: the rows flagged in `prob.obs_right`
    project through the rig's extrinsics into the second camera; the chain
    rule puts R_rl between the projection's Jacobian and the pose and point
    blocks, and such a row has no stereo column.

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
    if cam2 is not None and prob.obs_right is not None:
        params2, R_rl, t_rl = cam2
        is_r = prob.obs_right
        Xc2 = Xc @ R_rl.T + t_rl
        z = torch.where(is_r, Xc2[..., 2], Xc[..., 2])
        uv_hat = torch.where(is_r[:, None], cam.project(model, params2, Xc2),
                             cam.project(model, params, Xc))
        Jproj = torch.where(is_r[:, None, None], cam.project_jac(model, params2, Xc2) @ R_rl,
                            cam.project_jac(model, params, Xc))
        is_stereo = (prob.obs_ur >= 0.0) & ~is_r
    else:
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
        cost = cost + 1e3 * (n_struct - torch.sum(ok.to(cost.dtype)))
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


def segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """`jax.ops.segment_sum(vals, idx, num_segments=n)`."""
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


def point_slots(vals: torch.Tensor, op: torch.Tensor, oc: torch.Tensor, P: int,
                C: int) -> torch.Tensor:
    """Observation rows placed into their (point, camera) slots, (P, C, ...):
    a pair holds at most one observation (rows of invalid observations are
    zero, so where they share a slot the sum is exact in any order)."""
    return segment_sum(vals, op * C + oc, P * C).reshape((P, C) + vals.shape[1:])


class CameraSums:
    """Per-camera sums of observation rows in a fixed order, set up once per
    solve (the rows' cameras `oc` do not change within it). Camera-major
    rows with `obs_per_cam` each: one reduction over that axis. Else on the
    CPU `index_add_` in row order (the reference's `segment_sum`); on CUDA
    (where `index_add_` adds rows that share a target in no fixed order) the
    one-hot product `onehot(oc)^T @ vals`, the reference's own form of this
    sum, which cuBLAS computes the same way every run. The (O, C) one-hot
    matrix is built here, once."""

    def __init__(self, oc: torch.Tensor, C: int, obs_per_cam: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        self.oc, self.C = oc, C
        self.obs_per_cam = None if obs_per_cam is None else int(obs_per_cam)
        self.onehot = None
        if self.obs_per_cam is None and oc.device.type != "cpu":
            self.onehot = (oc[:, None] == torch.arange(C, device=oc.device)[None, :]).to(dtype)

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        C = self.C
        if self.obs_per_cam is not None:
            return vals.reshape((C, self.obs_per_cam) + vals.shape[1:]).sum(1)
        if self.onehot is None:
            return segment_sum(vals, self.oc, C)
        return (self.onehot.T @ vals.reshape(vals.shape[0], -1)).reshape((C,) + vals.shape[1:])


def point_sum(vals: torch.Tensor, op: torch.Tensor, oc: torch.Tensor, P: int,
              C: int) -> torch.Tensor:
    """Per-point sums of observation rows in a fixed order. On the CPU
    `index_add_` adds them in row order, the reference's `segment_sum`
    order. On CUDA it adds rows that share a target in no fixed order, so a
    solve would not repeat exactly: there the rows go through their
    (point, camera) slots and one reduction over the camera axis."""
    if vals.device.type == "cpu":
        return segment_sum(vals, op, P)
    return point_slots(vals, op, oc, P, C).sum(1)


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
                    n_opt_prefix=None, obs_per_cam=None, early_stop_tol=None,
                    cam2=None, group=None, point_axis_local=False) -> BAResult:
    """Explicit-reduced-camera-system LM with deferred accept: each
    iteration linearizes the candidate once, and its cost decides whether the
    previous step is kept. `n_opt_prefix`: the optimizable cameras are the
    first n rows (S spans only them). `obs_per_cam`: observations are
    camera-major with this many per camera (Hcc, bc by one batched matmul,
    in a fixed order as the point sums are, `point_sum`).
    `early_stop_tol`: stop after an accepted step that lowers the cost by a
    relative amount below it. `cam2`: the rig's right-camera rows
    (`_linearize`). `group`, `point_axis_local`: the sharded layouts (module
    docstring)."""
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
    n_struct = torch.sum((prob.obs_valid & prob.point_valid[op]).to(dtype))
    active = torch.ones_like(prob.obs_valid)
    obs_shared = group is not None and not point_axis_local
    red = comm.reducer(group if obs_shared else None, "ba/dense obs-sharded")
    red_pack = comm.reducer(group if not obs_shared else None, "ba/dense packed system")

    # A (point, camera) pair holds at most one observation, so the coupling
    # blocks are a placement: index map (P*n_opt -> obs row) built once;
    # invalid and fixed-camera rows go to a dump slot that is sliced away.
    in_win = oc < n_opt
    pk = op * n_opt + torch.where(in_win, oc, 0)
    pk_safe = torch.where(prob.obs_valid & in_win, pk, P * n_opt)
    inv_idx = torch.full((P * n_opt + 1,), O, dtype=torch.int64, device=dev)
    inv_idx[pk_safe] = torch.arange(O, dtype=torch.int64, device=dev)
    inv_idx = inv_idx[: P * n_opt]
    cam_sum = CameraSums(oc, C, obs_per_cam, dtype)

    def cam_reduce(Jc_w, e_w):
        """(Hcc (C,6,6), bc (C,6))."""
        if obs_per_cam is not None:
            A = torch.cat([Jc_w, e_w[:, :, None]], dim=-1).reshape(C, int(obs_per_cam) * 3, 7)
            H7 = A.transpose(1, 2) @ A  # (C,7,7)
            return H7[:, :6, :6], -H7[:, :6, 6]
        Hb = cam_sum(torch.cat([(Jc_w.transpose(1, 2) @ Jc_w).reshape(O, 36),
                                torch.einsum("oij,oi->oj", Jc_w, e_w)], dim=-1))
        return Hb[:, :36].reshape(C, 6, 6), -Hb[:, 36:]

    def linearize_pack(cam_R, cam_t, points) -> _Lin:
        e_w, Jc_w, Jp_w, chi2, ok, is_st = _linearize(
            model, params, bf, cam_R, cam_t, points, prob, active, cam2=cam2)
        cost = _robust_cost(chi2, ok, is_st, n_struct=n_struct)
        inlier = ok & (chi2 <= torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO))
        Hcc, bc = cam_reduce(Jc_w, e_w)
        # Point side as one fused (O,12) segment sum: [Jp^T Jp | -Jp^T e].
        pp = (Jp_w.transpose(1, 2) @ Jp_w).reshape(O, 9)
        pe = -torch.einsum("oij,oi->oj", Jp_w, e_w)
        ppe = point_sum(torch.cat([pp, pe], dim=-1), op, oc, P, C)
        if obs_shared:  # the point blocks must be global before Hpp^-1: one all-reduce
            pack = red(torch.cat([ppe.reshape(-1), Hcc.reshape(-1), bc.reshape(-1),
                                  cost.reshape(1)]))
            n_p, n_h = P * 12, C * 36
            ppe, Hcc = pack[:n_p].reshape(P, 12), pack[n_p:n_p + n_h].reshape(C, 6, 6)
            bc, cost = pack[n_p + n_h:-1].reshape(C, 6), pack[-1]
        Hpp = ppe[:, :9].reshape(P, 3, 3)
        bp = ppe[:, 9:]
        # Lambda-independent point damping, so a rejected step re-damps S only.
        eye3 = torch.eye(3, dtype=dtype, device=dev)
        Hpp_inv = lm.inv3x3(Hpp + (point_damping + 1e-4 * torch.abs(Hpp)) * eye3)
        L = _chol3x3(Hpp_inv)  # Hpp_d^-1 = L L^T
        # G_o = L_p^T Jp_o^T Jc_o placed into B (P, n, 3, 6): S_cross = B^T B.
        G = (Jp_w @ L[op]).transpose(1, 2) @ Jc_w  # (O,3,6)
        G = torch.cat([G.reshape(O, 18), torch.zeros((1, 18), dtype=dtype, device=dev)])
        B = red(G[inv_idx].reshape(P, n_opt, 3, 6))  # obs-sharded: another shard's pairs
        Bm = B.permute(0, 2, 1, 3).reshape(3 * P, 6 * n_opt)
        S_cross = (Bm.T @ Bm).reshape(n_opt, 6, n_opt, 6)
        y0 = torch.einsum("pij,pj->pi", Hpp_inv, bp)
        v = torch.einsum("oij,oj->oi", Jp_w, y0[op])  # b_red = bc - W^T y0, per obs
        wy = red(cam_sum(torch.einsum("oij,oi->oj", Jc_w, v)))
        S_und = _block_diag(Hcc[:n_opt]) - S_cross
        b_red, Hcc_w = (bc - wy)[:n_opt], Hcc[:n_opt]
        if group is not None and point_axis_local:
            # Point-sharded: the one collective of the linearization.
            n_s, n_b = S_und.numel(), b_red.numel()
            pack = red_pack(torch.cat([S_und.reshape(-1), b_red.reshape(-1),
                                       Hcc_w.reshape(-1), cost.reshape(1)]))
            S_und = pack[:n_s].reshape(S_und.shape)
            b_red = pack[n_s:n_s + n_b].reshape(n_opt, 6)
            Hcc_w, cost = pack[n_s + n_b:-1].reshape(n_opt, 6, 6), pack[-1]
        return _Lin(S_und, b_red, Hcc_w, bp, Hpp_inv, Jc_w, Jp_w, inlier, cost)

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
        tp = red(point_sum(torch.einsum("oij,oi->oj", lin.Jp_w, u), op, oc, P, C))
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
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
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


def dense_schur_bytes(C: int, P: int) -> int:
    """The reference's estimate of the explicit reduced camera system's peak
    memory: about 3 coupling tensors of C * P * 18 float32 (C cameras, P
    points; the observation count does not enter)."""
    return 3 * C * P * 18 * 4


def auto_dense_schur(C: int, P: int, hbm_budget_bytes: int = 4 << 30) -> bool:
    """The reference's choice of the explicit reduced camera system: its peak
    memory (`dense_schur_bytes`) within the budget. At config 1's Kmax 256
    and Pmax 16384 that is 0.9 GB, so global BA takes the dense path."""
    return dense_schur_bytes(C, P) <= hbm_budget_bytes


def _solve_ba_pcg(model, params, prob: BAProblem, bf, iters, pcg_iters, point_damping,
                  obs_per_cam=None, cam2=None, group=None, point_axis_local=False) -> BAResult:
    """The reference's matrix-free LM (`solve_ba` without `dense_schur`):
    each iteration linearizes, damps the point blocks (lambda |Hpp| plus
    `point_damping`) and the camera blocks (lambda |Hcc| plus 1e-8), solves
    the reduced camera system by `pcg_iters` steps of `lm.pcg` with the
    block-Jacobi preconditioner, back-substitutes the points, and `lm_loop`
    accepts the step if it lowers the robust cost. Per-camera sums go through
    `CameraSums` (`obs_per_cam`: camera-major rows, one reduction), per-point
    sums through `point_sum`; no host read. With `group` every per-camera
    sum, every per-point sum unless `point_axis_local`, and the cost are
    all-reduced (the reference's `seg_cam` / `seg_point` under `axis_name`)."""
    C = prob.cam_R.shape[0]
    P = prob.points.shape[0]
    dev, dtype = prob.cam_R.device, prob.cam_R.dtype
    oc = prob.obs_cam.to(torch.int64)
    op = prob.obs_point.to(torch.int64)
    cam_sum = CameraSums(oc, C, obs_per_cam, dtype)
    active = torch.ones_like(prob.obs_valid)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    fixed = prob.cam_fixed
    red_cam = comm.reducer(group, "ba/pcg cameras")
    red_pt = comm.reducer(None if point_axis_local else group, "ba/pcg points")
    red_cost = comm.reducer(group, "ba/pcg cost")

    def seg_point(vals):
        return red_pt(point_sum(vals, op, oc, P, C))

    def seg_cam(vals):
        return red_cam(cam_sum(vals))

    def gn_step(state, lamb):
        cam_R, cam_t, points = state
        e_w, Jc_w, Jp_w, _, _, _ = _linearize(model, params, bf, cam_R, cam_t, points, prob,
                                              active, cam2=cam2)
        pp = seg_point(torch.cat([(Jp_w.transpose(1, 2) @ Jp_w).reshape(-1, 9),
                                  -torch.einsum("oij,oi->oj", Jp_w, e_w)], dim=-1))
        Hpp, bp = pp[:, :9].reshape(P, 3, 3), pp[:, 9:]
        Hpp_inv = lm.inv3x3(Hpp + lamb * torch.abs(Hpp) * eye3 + point_damping * eye3)
        y0 = torch.einsum("pij,pj->pi", Hpp_inv, bp)
        v0 = torch.einsum("oij,oj->oi", Jp_w, y0[op])
        cc = seg_cam(torch.cat([(Jc_w.transpose(1, 2) @ Jc_w).reshape(-1, 36),
                                -torch.einsum("oij,oi->oj", Jc_w, e_w),
                                torch.einsum("oij,oi->oj", Jc_w, v0)], dim=-1))
        Hcc = cc[:, :36].reshape(C, 6, 6)
        Hcc = Hcc + lamb * torch.abs(Hcc) * eye6 + 1e-8 * eye6
        Hcc = torch.where(fixed[:, None, None], eye6, Hcc)
        b_red = cc[:, 36:42] - cc[:, 42:]  # bc - W Hpp^-1 bp
        Hcc_inv, _ = torch.linalg.inv_ex(Hcc)  # the block-Jacobi preconditioner

        def schur_cross(x):  # W Hpp^-1 W^T x, through the observations
            u = torch.einsum("oij,oj->oi", Jc_w, x[oc])
            y = torch.einsum("pij,pj->pi", Hpp_inv, seg_point(torch.einsum("oij,oi->oj", Jp_w, u)))
            return seg_cam(torch.einsum("oij,oi->oj", Jc_w, torch.einsum("oij,oj->oi", Jp_w, y[op])))

        dc = lm.pcg(lambda x: torch.einsum("cij,cj->ci", Hcc, x) - schur_cross(x), b_red,
                    lambda r: torch.einsum("cij,cj->ci", Hcc_inv, r), iters=pcg_iters).x
        dc = torch.where(fixed[:, None], 0.0, dc)
        u = torch.einsum("oij,oj->oi", Jc_w, dc[oc])
        tp = seg_point(torch.einsum("oij,oi->oj", Jp_w, u))
        dp = torch.einsum("pij,pj->pi", Hpp_inv, bp - tp)
        dp = torch.where(prob.point_valid[:, None], dp, 0.0)
        dR, dt = lie.exp_se3(dc)
        R_new, t_new = lie.se3_compose(dR, dt, cam_R, cam_t)
        R_new = lie.normalize_rotation(R_new)
        R_new = torch.where(fixed[:, None, None], cam_R, R_new)
        t_new = torch.where(fixed[:, None], cam_t, t_new)
        return (R_new, t_new, points + dp)

    n_struct = torch.sum((prob.obs_valid & prob.point_valid[op]).to(dtype))

    def cost_fn(state):
        _, _, _, chi2, ok, is_st = _linearize(model, params, bf, *state, prob, active, cam2=cam2)
        return red_cost(_robust_cost(chi2, ok, is_st, n_struct=n_struct))

    (cam_R, cam_t, points), cost = lm.lm_loop((prob.cam_R, prob.cam_t, prob.points), cost_fn,
                                              gn_step, iters)
    _, _, _, chi2, ok, is_st = _linearize(model, params, bf, cam_R, cam_t, points, prob, active,
                                          cam2=cam2)
    inlier = ok & (chi2 <= torch.where(is_st, lm.CHI2_STEREO, lm.CHI2_MONO))
    return BAResult(cam_R=cam_R, cam_t=cam_t, points=points, obs_inlier=inlier, cost=cost)


def solve_ba(model: cam.CameraModel, params: torch.Tensor, prob: BAProblem, bf: float = 0.0,
             iters: int = 10, pcg_iters: int = 50, point_damping: float = 1e-6,
             dense_schur: bool = False, n_opt_prefix: Optional[int] = None,
             obs_per_cam: Optional[int] = None, early_stop_tol: Optional[float] = None,
             cam2=None, group=None, point_axis_local: bool = False) -> BAResult:
    """LM bundle adjustment: the dense-Schur path with `dense_schur`, else the
    matrix-free PCG path (`pcg_iters` CG steps per LM iteration; it takes no
    `n_opt_prefix` or `early_stop_tol`, as in the reference). `cam2 =
    (params2, R_rl, t_rl)`: a two-camera rig's extrinsics for the rows
    flagged in `prob.obs_right`.

    `group`: a `torch.distributed` group over which this rank holds a shard
    of the observations (cameras and points replicated; the reference's
    `axis_name`). `point_axis_local`: the rank owns `prob.points` and every
    observation of them (`obs_point` local indices), so the point sums stay
    local (`parallel/ba_sharded.py::solve_ba_point_sharded`). The result's
    cameras (and with replicated points, the points) are the same on every
    rank; `obs_inlier` is this rank's rows."""
    if not dense_schur:
        return _solve_ba_pcg(model, params, prob, bf, iters, pcg_iters, point_damping,
                             obs_per_cam=obs_per_cam, cam2=cam2, group=group,
                             point_axis_local=point_axis_local)
    return _solve_ba_dense(model, params, prob, bf, iters, point_damping,
                           n_opt_prefix=n_opt_prefix, obs_per_cam=obs_per_cam,
                           early_stop_tol=early_stop_tol, cam2=cam2, group=group,
                           point_axis_local=point_axis_local)
