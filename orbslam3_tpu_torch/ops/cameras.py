"""Camera models on torch tensors — the pinhole (+ radtan) part of
`orbslam3_tpu/ops/cameras.py`, same flat parameter layout
``[fx, fy, cx, cy, k1, k2, p1, p2]`` and hand-derived Jacobians.
Kannala-Brandt waits for the fisheye slice."""

from __future__ import annotations

import enum

import torch


class CameraModel(enum.IntEnum):
    PINHOLE = 0
    KB8 = 1


def make_pinhole(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, device=None) -> torch.Tensor:
    return torch.tensor([fx, fy, cx, cy, k1, k2, p1, p2], dtype=torch.float32, device=device)


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


def project(model: CameraModel, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model != CameraModel.PINHOLE:
        raise NotImplementedError(f"camera model {model!r} is not ported yet")
    return pinhole_project(params, Xc)


def unproject(model: CameraModel, params: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    if model != CameraModel.PINHOLE:
        raise NotImplementedError(f"camera model {model!r} is not ported yet")
    return pinhole_unproject(params, uv)


def project_jac(model: CameraModel, params: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    if model != CameraModel.PINHOLE:
        raise NotImplementedError(f"camera model {model!r} is not ported yet")
    return pinhole_project_jac(params, Xc)
