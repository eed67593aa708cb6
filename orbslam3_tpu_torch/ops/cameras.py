"""Camera models on torch tensors — the port of `orbslam3_tpu/ops/cameras.py`:
the pinhole (+ radtan, ``[fx, fy, cx, cy, k1, k2, p1, p2]``) and the
Kannala-Brandt 8 fisheye (``[fx, fy, cx, cy, k1, k2, k3, k4]``) models, one
flat parameter vector each, hand-derived Jacobians, and the model chosen by
a Python enum (`project`, `unproject`, `project_jac`).

The r -> 0 limits of the KB8 model are written as the reference writes
them, `torch.where` on both branches with the untaken one fed a safe value,
so no NaN leaks from it (a NaN in a `torch.where` branch that is not taken
is dropped, but one in the gradient or in a product is not)."""

from __future__ import annotations

import enum
import math

import torch


class CameraModel(enum.IntEnum):
    PINHOLE = 0
    KB8 = 1


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, k1, k2, p1, p2], dtype=torch.float32, device=device)


def make_kb8(fx, fy, cx, cy, k1, k2, k3, k4, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, k1, k2, k3, k4], dtype=torch.float32, device=device)


def _inv_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def _pinhole_distort(params, xn, yn):
    k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * k2)
    xd = xn * radial + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + p1 * (r2 + 2.0 * yn * yn) + 2.0 * p2 * xn * yn
    return xd, yd


def pinhole_project(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    inv_z = _inv_z(Xc[..., 2])
    xn = Xc[..., 0] * inv_z
    yn = Xc[..., 1] * inv_z
    xd, yd = _pinhole_distort(params, xn, yn)
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def pinhole_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth rays (..., 3) (z = 1), undistorted by
    8 fixed-point radtan steps, as the reference."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(8):
        dx, dy = _pinhole_distort(params, x, y)
        x, y = x + (xd - dx), y + (yd - dy)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(Xc): (..., 2, 3), distortion terms included."""
    fx, fy = params[0], params[1]
    k1, k2, p1, p2 = params[4], params[5], params[6], params[7]
    x, y = Xc[..., 0], Xc[..., 1]
    inv_z = _inv_z(Xc[..., 2])
    xn = x * inv_z
    yn = y * inv_z
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dradial_dr2 = k1 + 2.0 * k2 * r2
    dxd_dxn = radial + xn * dradial_dr2 * 2.0 * xn + 2.0 * p1 * yn + 6.0 * p2 * xn
    dxd_dyn = xn * dradial_dr2 * 2.0 * yn + 2.0 * p1 * xn + 2.0 * p2 * yn
    dyd_dxn = yn * dradial_dr2 * 2.0 * xn + 2.0 * p2 * yn + 2.0 * p1 * xn
    dyd_dyn = radial + yn * dradial_dr2 * 2.0 * yn + 6.0 * p1 * yn + 2.0 * p2 * xn
    du_dx = fx * dxd_dxn * inv_z
    du_dy = fx * dxd_dyn * inv_z
    du_dz = -fx * (dxd_dxn * xn + dxd_dyn * yn) * inv_z
    dv_dx = fy * dyd_dxn * inv_z
    dv_dy = fy * dyd_dyn * inv_z
    dv_dz = -fy * (dyd_dxn * xn + dyd_dyn * yn) * inv_z
    row_u = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row_v = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def kb8_project(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """`KannalaBrandt8::project`: theta = atan2(r, z), d = theta (1 + k1 th^2
    + k2 th^4 + k3 th^6 + k4 th^8), uv = f d (x, y) / r + c; on the axis
    (r < 1e-8) the pinhole's x / z scaling."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    th2 = theta * theta
    d = theta * (1.0 + th2 * (k1 + th2 * (k2 + th2 * (k3 + th2 * k4))))
    near = r < 1e-8
    inv_r = torch.where(near, 0.0, 1.0 / torch.where(near, 1.0, r))
    scale = torch.where(near, 1.0 / torch.clamp(z, min=1e-8), d * inv_r)
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def kb8_unproject(params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth rays (..., 3) (z = 1): 10 Newton steps
    on the theta polynomial (`KannalaBrandt8::unprojectEig`), a Python loop
    with no host read."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -math.pi / 2, math.pi / 2)
    theta = theta_d_c
    for _ in range(10):
        th2 = theta * theta
        th4 = th2 * th2
        th6 = th4 * th2
        th8 = th4 * th4
        k_th = theta * (1.0 + k1 * th2 + k2 * th4 + k3 * th6 + k4 * th8)
        d_k = 1.0 + 3 * k1 * th2 + 5 * k2 * th4 + 7 * k3 * th6 + 9 * k4 * th8
        theta = theta - (k_th - theta_d_c) / d_k
    near = theta_d < 1e-8
    scale = torch.where(near, 1.0, torch.tan(theta) / torch.where(near, 1.0, theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """d(uv)/d(Xc): (..., 2, 3) (`KannalaBrandt8::projectJac`); r is floored
    at 1e-9 as in the reference."""
    fx, fy = params[0], params[1]
    k1, k2, k3, k4 = params[4], params[5], params[6], params[7]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    R2 = r2 + z * z
    theta = torch.atan2(r, z)
    th2 = theta * theta
    th4 = th2 * th2
    th6 = th4 * th2
    th8 = th4 * th4
    f_th = theta * (1.0 + k1 * th2 + k2 * th4 + k3 * th6 + k4 * th8)
    fd_th = 1.0 + 3 * k1 * th2 + 5 * k2 * th4 + 7 * k3 * th6 + 9 * k4 * th8
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    inv_r = 1.0 / r
    inv_r3 = inv_r * inv_r * inv_r
    du_dx = fx * (fd_th * dth_dx * x * inv_r + f_th * (inv_r - x * x * inv_r3))
    du_dy = fx * (fd_th * dth_dy * x * inv_r - f_th * x * y * inv_r3)
    du_dz = fx * fd_th * dth_dz * x * inv_r
    dv_dx = fy * (fd_th * dth_dx * y * inv_r - f_th * x * y * inv_r3)
    dv_dy = fy * (fd_th * dth_dy * y * inv_r + f_th * (inv_r - y * y * inv_r3))
    dv_dz = fy * fd_th * dth_dz * y * inv_r
    row_u = torch.stack([du_dx, du_dy, du_dz], dim=-1)
    row_v = torch.stack([dv_dx, dv_dy, dv_dz], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def project(model: CameraModel, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model == CameraModel.PINHOLE:
        return pinhole_project(params, Xc)
    return kb8_project(params, Xc)


def unproject(model: CameraModel, params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    if model == CameraModel.PINHOLE:
        return pinhole_unproject(params, uv)
    return kb8_unproject(params, uv)


def project_jac(model: CameraModel, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model == CameraModel.PINHOLE:
        return pinhole_project_jac(params, Xc)
    return kb8_project_jac(params, Xc)
