"""SO(3) / SE(3) operations on torch tensors — the slice's subset of
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
