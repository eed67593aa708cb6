"""Sim(3) pose graph (the essential graph) on torch tensors — the port of
`orbslam3_tpu/optim/pose_graph.py` (`Optimizer::OptimizeEssentialGraph`,
`Optimizer.cc:2526`), the loop closer's correction.

Vertices are Sim3 (R, t, s) per keyframe slot; an edge i -> j with the
measurement M_ji has the 7-dof residual r = log_sim3(M^-1 S_j S_i^-1),
linearized at zero perturbation by autodiff over all edges at once
(`torch.func.vmap(torch.func.jacrev)` for the reference's
`jax.vmap(jax.jacfwd)`: under `vmap` every per-edge scalar is a 0-d tensor,
whose forward-mode tangents PyTorch turns float64 (`optim/sim3.py`);
reverse mode gives the same 7x7 Jacobians, 7 outputs by 7 inputs). The
7-DoF graph perturbs each vertex on the left, exp(xi) S_iw, in its
camera's frame. The 4-DoF graph (`dof4`) perturbs it on the world side,
S_iw exp(xi), with the tangent's x and y rotation and its scale frozen: as
ORB-SLAM3's `VertexPose4DoF` (`ImuCamPose::UpdateW`, `G2oTypes.cc:222`), a
keyframe turns about the world's z axis, the gravity axis of an inertial
map, and its world translation moves (fault C22: frozen on the left, the
same dims left the rotation about each camera's optical axis free, so a
camera looking sideways took no yaw). The normal equations are dense,
(7K, 7K); their 7x7 blocks are summed into the block layout (K, K, 7, 7) in
a fixed order by `index_put_(accumulate=True)` (CUDA's `index_add_` adds
rows that share a target in no fixed order; `index_put_` sorts them first
there, and sums them in row order on the CPU; two replicas of a distributed
map must correct a loop bit for bit alike), and solved by one
`torch.linalg.solve` in float32 (TF32 off, see the package docstring). The
caller builds the edges (`pipeline/loop_closing.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.ops import lie


class PoseGraph(NamedTuple):
    # Vertices: S_iw (world -> keyframe i)
    R: torch.Tensor  # (K,3,3)
    t: torch.Tensor  # (K,3)
    s: torch.Tensor  # (K,)
    fixed: torch.Tensor  # (K,) bool
    # Edges i -> j with measurement M_ji = S_jw S_iw^-1
    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    edge_R: torch.Tensor  # (E,3,3)
    edge_t: torch.Tensor  # (E,3)
    edge_s: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) information scale


def _perturb(xi, R, t, s, world: bool):
    """exp(xi) S (the camera's side) or, with `world`, S exp(xi)."""
    if world:
        return lie.sim3_compose(R, t, s, *lie.exp_sim3(xi))
    return lie.sim3_compose(*lie.exp_sim3(xi), R, t, s)


def _residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, xi_i, xi_j, world: bool = False):
    """r = log_sim3(M^-1 (exp(xi_j) S_j) (exp(xi_i) S_i)^-1), or with the
    perturbations on the world side."""
    Ri2, ti2, si2 = _perturb(xi_i, Ri, ti, si, world)
    Rj2, tj2, sj2 = _perturb(xi_j, Rj, tj, sj, world)
    Rji, tji, sji = lie.sim3_compose(Rj2, tj2, sj2, *lie.sim3_inv(Ri2, ti2, si2))
    return lie.log_sim3(*lie.sim3_compose(*lie.sim3_inv(Rm, tm, sm), Rji, tji, sji))


def _edge_res_and_jac(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, world: bool = False):
    """One edge's (r (7,), dr/dxi_i (7,7), dr/dxi_j (7,7)) at zero."""
    z = torch.zeros(7, dtype=Ri.dtype, device=Ri.device)
    args = (Ri, ti, si, Rj, tj, sj, Rm, tm, sm)
    r = _residual(*args, z, z, world)
    Ji = torch.func.jacrev(lambda x: _residual(*args, x, z, world))(z)
    Jj = torch.func.jacrev(lambda x: _residual(*args, z, x, world))(z)
    return r, Ji, Jj


def solve_pose_graph(g: PoseGraph, iters: int = 20, lam: float = 1e-6, dof4: bool = False):
    """Gauss-Newton with a small fixed damping (well posed once a vertex is
    fixed). Returns the corrected (R, t, s). `dof4` restricts the update to
    the world translation and the yaw about the world's z axis at unit scale
    (the inertial graph, `OptimizeEssentialGraph4DoF`, `Optimizer.cc:8604`;
    the world's z is gravity's axis once the IMU is initialized): the
    inertial `LoopCloser`'s graph and the inertial merge's."""
    K = g.R.shape[0]
    dim = 7 * K
    dev, dt = g.R.device, g.R.dtype
    free = torch.ones(7, dtype=dt, device=dev)  # free tangent dims [rho, phi, sigma]
    if dof4:  # translation and yaw
        free[[3, 4, 6]] = 0.0
    ei, ej = g.edge_i.to(torch.int64), g.edge_j.to(torch.int64)
    w = torch.where(g.edge_valid, g.edge_weight, 0.0).to(dt)
    fi = (~g.fixed[ei]).to(dt)[:, None, None] * free
    fj = (~g.fixed[ej]).to(dt)[:, None, None] * free
    fixed_rows = g.fixed.repeat_interleave(7)
    diag = torch.diag(torch.where(fixed_rows, 1.0, lam).to(dt))
    res_jac = torch.func.vmap(lambda *a: _edge_res_and_jac(*a, world=dof4))
    R, t, s = g.R, g.t, g.s
    for _ in range(iters):
        r, Ji, Jj = res_jac(R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], g.edge_R, g.edge_t,
                            g.edge_s)  # (E,7), (E,7,7), (E,7,7)
        Ji = Ji * fi
        Jj = Jj * fj
        rw = r * w[:, None]
        blocks = torch.cat([torch.einsum("eai,eaj,e->eij", Ji, Ji, w),
                            torch.einsum("eai,eaj,e->eij", Jj, Jj, w),
                            torch.einsum("eai,eaj,e->eij", Ji, Jj, w),
                            torch.einsum("eai,eaj,e->eji", Ji, Jj, w)])
        at = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
        H = torch.zeros((K * K, 7, 7), dtype=dt, device=dev).index_put_((at,), blocks,
                                                                         accumulate=True)
        H = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(dim, dim)
        b = torch.zeros((K, 7), dtype=dt, device=dev).index_put_(
            (torch.cat([ei, ej]),), torch.cat([torch.einsum("eai,ea->ei", Ji, rw),
                                               torch.einsum("eai,ea->ei", Jj, rw)]),
            accumulate=True)
        H = torch.where(fixed_rows[:, None] | fixed_rows[None, :], 0.0, H) + diag
        rhs = torch.where(fixed_rows, 0.0, -b.reshape(-1))
        delta = torch.linalg.solve_ex(H, rhs)[0].reshape(K, 7)
        R, t, s = _perturb(delta, R, t, s, dof4)
        R = lie.normalize_rotation(R)
    return R, t, s


def se3_to_sim3(R, t):
    """SE3 poses lifted to Sim3 with s = 1."""
    return R, t, torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)


def correct_points(mp_pos, ref_R_old, ref_t_old, ref_s_old, ref_R_new, ref_t_new, ref_s_new):
    """Points re-expressed through their reference keyframe's correction,
    X' = S_new^-1 (S_old X) (`CorrectLoop`, `LoopClosing.cc:1175-1204`)."""
    Xc = lie.sim3_apply(ref_R_old, ref_t_old, ref_s_old, mp_pos)
    return lie.sim3_apply(*lie.sim3_inv(ref_R_new, ref_t_new, ref_s_new), Xc)
