"""SO(3) / SE(3) / Sim(3) operations on torch tensors — the port's subset of
`orbslam3_tpu/ops/lie.py`, same conventions:

* rotations are (..., 3, 3) float32 matrices;
* `exp` updates apply on the right in the body frame for SO(3) and as
  ``[rho, phi]`` (translation first) for SE(3);
* small-angle branches are second-order Taylor expansions selected with
  `torch.where`, so no function branches on the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``w``: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta(w: torch.Tensor):
    """(theta_safe, theta2, small), as the reference's `_theta`."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta_safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return theta_safe, theta2, small


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential so(3) -> SO(3), batched."""
    theta, theta2, small = _theta(w)
    W = hat(w)
    W2 = W @ W
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3), batched (`ImuTypes.cc:RightJacobianSO3`):
    Jr(w) = I - (1 - cos t) / t^2 W + (t - sin t) / t^3 W^2."""
    theta, theta2, small = _theta(w)
    W = hat(w)
    W2 = W @ W
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t3 = safe_t2 * theta
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * W2


def inv_right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3), batched
    (`ImuTypes.cc:InverseRightJacobianSO3`): Jr^-1(w) = I + W / 2 +
    (1 / t^2 - (1 + cos t) / (2 t sin t)) W^2, the derivative of `log_so3`
    under a right perturbation."""
    theta, theta2, small = _theta(w)
    W = hat(w)
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_den = torch.where(small, torch.ones_like(theta), 2.0 * theta * torch.sin(theta))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / safe_t2 - (1.0 + torch.cos(theta)) / safe_den)
    return _eye_like(W) + 0.5 * W + c[..., None, None] * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Logarithm SO(3) -> so(3), batched: the reference's atan2 form, with
    the small-angle Taylor branch and the near-pi branch (axis from the
    diagonal of (R + I) / 2, signs from the largest axis' column). The
    1e-24 keeps the square root differentiable at 0 and pi, so derivatives
    stay finite on every branch."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2))  # 2 sin(theta) * axis
    sin2 = 0.25 * torch.sum(w_skew * w_skew, dim=-1)
    sin_t_n = torch.sqrt(sin2 + 1e-24)
    theta = torch.atan2(sin_t_n, cos_t)
    small = theta < 1e-4
    near_pi = theta > torch.pi - 1e-3
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_t_n), sin_t_n)
    generic = w_skew * (theta / (2.0 * safe_sin))[..., None]
    small_w = 0.5 * w_skew * (1.0 + theta[..., None] ** 2 / 6.0)
    B = (R + _eye_like(R)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    diag_safe = torch.where(near_pi[..., None], torch.clamp(diag, min=1e-9),
                            torch.ones_like(diag))
    axis = torch.sqrt(diag_safe)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(*k.shape, 3, 1))[..., 0]
    sign = torch.sign(torch.where(col == 0.0, torch.ones_like(col), col))
    axis = axis * sign / torch.linalg.norm(axis * sign + _EPS, dim=-1, keepdim=True)
    pi_w = axis * theta[..., None]
    out = torch.where(small[..., None], small_w, generic)
    return torch.where(near_pi[..., None], pi_w, out)


def exp_se3(xi: torch.Tensor):
    """se(3) -> SE(3). ``xi = [rho (3), phi (3)]``; returns (R, V(phi) rho)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    theta, theta2, small = _theta(phi)
    W = hat(phi)
    W2 = W @ W
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t3 = safe_t2 * theta
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / safe_t3)
    V = _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2
    return R, torch.einsum("...ij,...j->...i", V, rho)


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize a near-rotation through a normalized quaternion."""
    q = quat_from_mat(R)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return mat_from_quat(q)


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), branch-free: all four
    Shepperd candidates, the best-conditioned one picked by argmax."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22
    traces = torch.stack([tw, tx, ty, tz], dim=-1)

    def s_of(tr):
        return torch.sqrt(torch.clamp(tr, min=_EPS)) * 2.0

    sw, sx, sy, sz = s_of(tw), s_of(tx), s_of(ty), s_of(tz)
    cands = torch.stack(
        [
            torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], -1),
            torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], -1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], -1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], -1),
        ],
        dim=-2,
    )  # (..., 4, 4)
    best = torch.argmax(traces, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix, batched."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def se3_apply(R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R @ p + t, broadcasting over batch dims."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def se3_inv(R: torch.Tensor, t: torch.Tensor):
    """Inverse transform: (R^T, -R^T t)."""
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s), the loop closer's vertices and measurements
# ---------------------------------------------------------------------------


def sim3_apply(R, t, s, p):
    """s * R @ p + t."""
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) * (Rb, tb, sb)."""
    return Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb) + ta, sa * sb


def _sim3_V(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """V(phi, sigma) = integral over [0, 1] of exp(sigma tau) exp_so3(phi tau),
    by the reference's 32-point midpoint rule, its nodes evaluated as one
    batch (the reference's `fori_loop` adds them in turn; the sums agree to
    float32 rounding)."""
    n_steps = 32
    dt = 1.0 / n_steps
    tau = (torch.arange(n_steps, dtype=phi.dtype, device=phi.device) + 0.5) * dt  # (32,)
    R = exp_so3(phi[..., None, :] * tau[:, None])  # (..., 32, 3, 3)
    w = dt * torch.exp(sigma[..., None] * tau)  # (..., 32)
    return torch.sum(w[..., None, None] * R, dim=-3)


def exp_sim3(xi: torch.Tensor):
    """sim(3) -> Sim(3). ``xi = [rho (3), phi (3), sigma (1)]``."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _sim3_V(phi, sigma)
    return exp_so3(phi), torch.einsum("...ij,...j->...i", V, rho), torch.exp(sigma)


def log_sim3(R, t, s):
    """Sim(3) -> sim(3), inverting V on the translation."""
    phi = log_so3(R)
    sigma = torch.log(s)
    rho = torch.linalg.solve(_sim3_V(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
