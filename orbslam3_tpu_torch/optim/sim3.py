"""Sim3 refinement of a loop candidate on torch tensors — the port of
`orbslam3_tpu/optim/sim3.py` (`Optimizer::OptimizeSim3`,
`Optimizer.cc:4111`).

Each matched pair (X1 in keyframe 1's camera, X2 in keyframe 2's) gives
two reprojection residuals, e2 = uv2 - proj(S21 X1) and e1 = uv1 -
proj(S21^-1 X2), weighted by their octaves' information. Every
Gauss-Newton step re-gates the pairs by chi2 < 9.99 on both edges and
solves the 7x7 normal system in (omega, nu, lambda). The reference builds
the Jacobian with `jax.jacfwd`; the port with `torch.func.jacfwd`, on a
(1, 7) view of the step: PyTorch's forward-mode rules give a 0-d float32
tensor times a Python float a float64 tangent, which a float32 matmul then
refuses, and a leading axis of 1 keeps every intermediate 1-d. Its
`fori_loop` is a Python loop with no host read; a non-finite step is
dropped with `torch.where`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import lie

CHI2_SIM3 = 9.99  # ref th2 = 10 (`Optimizer.cc:4230`)


class Sim3Result(NamedTuple):
    R: torch.Tensor  # (3,3) refined R21
    t: torch.Tensor  # (3,)
    s: torch.Tensor  # ()
    inlier: torch.Tensor  # (N,) the pair passes both chi2 gates
    n_inliers: torch.Tensor  # ()


def optimize_sim3(model: cam.CameraModel, params: torch.Tensor, R21, t21, s21, X1, X2, uv1, uv2,
                  sigma2_1, sigma2_2, valid, fix_scale: bool = False, iters: int = 8) -> Sim3Result:
    """Refine S21 = (R21, t21, s21) on the pairs (X1, X2) observed at uv1 in
    keyframe 1 and uv2 in keyframe 2; a zero `sigma2` makes that edge
    weightless."""
    X1 = X1.to(torch.float32)
    X2 = X2.to(torch.float32)
    dev = X1.device
    w1 = torch.where(sigma2_1 > 0, 1.0 / torch.clamp(sigma2_1, min=1e-9), 0.0)
    w2 = torch.where(sigma2_2 > 0, 1.0 / torch.clamp(sigma2_2, min=1e-9), 0.0)

    def residuals(delta, R, t, s):
        d = delta[None]  # (1, 7): see the module docstring
        Rd = lie.exp_so3(d[:, :3])[0] @ R
        td = t + delta[3:6]
        sd = s if fix_scale else s * torch.exp(d[:, 6])
        Y2 = sd * (X1 @ Rd.T) + td  # S21 X1
        Y1 = (1.0 / sd) * ((X2 - td) @ Rd)  # S21^-1 X2
        return uv1 - cam.project(model, params, Y1), uv2 - cam.project(model, params, Y2)

    def gate(e1, e2):
        return (valid & (torch.sum(e1 * e1, -1) * w1 < CHI2_SIM3)
                & (torch.sum(e2 * e2, -1) * w2 < CHI2_SIM3))

    z = torch.zeros(7, dtype=torch.float32, device=dev)
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)
    R, t = R21.to(torch.float32), t21.to(torch.float32)
    s = torch.as_tensor(s21, dtype=torch.float32, device=dev)
    for _ in range(iters):
        inl = gate(*residuals(z, R, t, s))
        m = inl.to(torch.float32)
        sw1, sw2 = torch.sqrt(w1) * m, torch.sqrt(w2) * m

        def flat(delta):
            f1, f2 = residuals(delta, R, t, s)
            return torch.cat([(f1 * sw1[:, None]).reshape(-1), (f2 * sw2[:, None]).reshape(-1)])

        r0 = flat(z)
        J = torch.func.jacfwd(flat)(z)  # (4N, 7)
        delta = -torch.linalg.solve_ex(J.T @ J + 1e-6 * eye7, J.T @ r0)[0]
        delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
        R = lie.exp_so3(delta[:3]) @ R
        t = t + delta[3:6]
        if not fix_scale:
            s = s * torch.exp(delta[6])
    inl = gate(*residuals(z, R, t, s))
    return Sim3Result(R=R, t=t, s=s, inlier=inl, n_inliers=inl.sum())
