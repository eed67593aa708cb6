"""Robust-kernel constants and weights shared by the port's solvers, the
Levenberg-Marquardt loop and the preconditioned conjugate gradients of the
matrix-free bundle adjustment: the port of `orbslam3_tpu/optim/lm.py`."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

# Chi2 gates at 95% for 2/3 DoF (ref Optimizer.cc chi2Mono / chi2Stereo).
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber IRLS weight on the squared error: 1 if chi2 <= delta2 else
    delta / sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / safe))


def inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det), |det| floored at
    1e-12 as in the reference."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def _tree_where(cond: torch.Tensor, new, old):
    """`torch.where(cond, new, old)` leaf by leaf over tuples and NamedTuples."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    vals = [_tree_where(cond, n, o) for n, o in zip(new, old)]
    return type(new)(*vals) if hasattr(new, "_fields") else tuple(vals)


def _first_leaf(tree) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else _first_leaf(tree[0])


def lm_loop(init_params, cost_fn, step_fn, iters: int, lam0: float = 1e-4, lam_up: float = 4.0,
            lam_down: float = 0.5):
    """`iters` Levenberg-Marquardt iterations (the reference's `lm_loop`, a
    `fori_loop`): `step_fn(params, lam)` proposes a damped Gauss-Newton
    step, `cost_fn(params)` scores it; a step that does not lower the cost
    is rejected and lambda raised. Accept and reject are `torch.where`s, so
    the loop reads nothing back to the host. `params` is a tensor or a
    tuple / NamedTuple of them. Returns (params, cost)."""
    leaf = _first_leaf(init_params)
    lam = torch.full((), lam0, dtype=torch.float32, device=leaf.device)
    params = init_params
    cost = cost_fn(params)
    for _ in range(iters):
        cand = step_fn(params, lam)
        new_cost = cost_fn(cand)
        accept = new_cost < cost
        params = _tree_where(accept, cand, params)
        lam = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up), 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return params, cost


class PCGResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor


def pcg(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
        precond: Callable[[torch.Tensor], torch.Tensor], iters: int,
        tol: float = 1e-6) -> PCGResult:
    """`iters` steps of preconditioned conjugate gradients on an SPD operator
    (the reference's fixed-iteration `pcg`): once the relative residual is
    under `tol`, the steps leave the state as it is (`torch.where`, no host
    read). `matvec` and `precond` take and return tensors shaped as `b`."""
    def dot(u, v):
        return torch.sum(u * v)

    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = dot(r, p)
    b_norm = torch.sqrt(dot(b, b)) + 1e-30
    for _ in range(iters):
        done = torch.sqrt(dot(r, r)) / b_norm < tol
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = torch.where(torch.abs(denom) < 1e-30, 0.0, rz / denom)
        alpha = torch.where(done, 0.0, alpha)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(torch.abs(rz) < 1e-30, 0.0, rz_new / rz)
        p = torch.where(done, p, z + beta * p)
        rz = rz_new
    return PCGResult(x=x, residual_norm=torch.sqrt(dot(r, r)) / b_norm)
