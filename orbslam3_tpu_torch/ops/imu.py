"""On-manifold IMU preintegration (Forster-style) on torch tensors — the
port of `orbslam3_tpu/ops/imu.py` (ORB-SLAM3's `IMU::Preintegrated`,
`ImuTypes.cc:185-498`).

State per window (`Preintegrated`): dR (3,3), dV (3,), dP (3,); the bias
Jacobians JRg, JVg, JVa, JPg, JPa; the covariance C (15,15) of
[phi, v, p, bg, ba]; the total time dT; the biases of the integration.

The reference integrates a window padded to a fixed capacity with dt = 0
rows in one `lax.scan`. A dt = 0 step is an exact no-op of the update
equations, so the port loops over the real samples only (about 11 per
frame gap at 200 Hz IMU / 20 Hz camera): the host knows their count, so the
loop reads nothing back. A padded window gives the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.device import require_cuda
from orbslam3_tpu_torch.ops import lie

GRAVITY_VALUE = 9.81  # ref `ImuTypes.h:GRAVITY_VALUE`


def gravity(device, dtype=torch.float32) -> torch.Tensor:
    """(0, 0, -9.81) on `device`, made there (writing an element from a
    Python number would copy it up with a host sync)."""
    z = torch.arange(3, device=device) == 2
    return torch.where(z, -GRAVITY_VALUE, 0.0).to(dtype)


class ImuCalib(NamedTuple):
    """Ref `IMU::Calib` (`ImuTypes.h:87`): body <- camera extrinsics and noise."""

    Rbc: torch.Tensor  # (3,3)
    tbc: torch.Tensor  # (3,)
    cov: torch.Tensor  # (6,6) diag [gyro^2 * freq x3, acc^2 * freq x3]
    cov_walk: torch.Tensor  # (6,6) diag random walk

    @staticmethod
    def create(Rbc, tbc, noise_gyro, noise_acc, walk_gyro, walk_acc, freq, device=None):
        """Noise densities are continuous-time: scaled by sqrt(freq) as the
        reference does (`Tracking.cc:280-292`), in float32 as the JAX
        package computes them. On `device` (None: the first CUDA card,
        raising where there is none)."""
        if device is None:
            device = require_cuda()
        sf = np.sqrt(np.float32(freq))
        ng, na = np.float32(noise_gyro) * sf, np.float32(noise_acc) * sf
        wg, wa = np.float32(walk_gyro) / sf, np.float32(walk_acc) / sf
        cov = np.diag(np.asarray([ng * ng] * 3 + [na * na] * 3, np.float32))
        cov_walk = np.diag(np.asarray([wg * wg] * 3 + [wa * wa] * 3, np.float32))
        return ImuCalib(*(convert.tensor(np.asarray(x, np.float32), device)
                          for x in (Rbc, tbc, cov, cov_walk)))


class Preintegrated(NamedTuple):
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor  # (15,15)
    dT: torch.Tensor  # scalar
    bias_gyro: torch.Tensor  # (3,) bias used during integration
    bias_acc: torch.Tensor  # (3,)


def init_preintegrated(bias_gyro: torch.Tensor, bias_acc: torch.Tensor) -> Preintegrated:
    """The empty window at the given biases (on their device)."""
    z33 = torch.zeros((3, 3), dtype=bias_gyro.dtype, device=bias_gyro.device)
    z3 = z33[0]
    return Preintegrated(
        dR=torch.eye(3, dtype=z3.dtype, device=z3.device), dV=z3, dP=z3,
        JRg=z33, JVg=z33, JVa=z33, JPg=z33, JPa=z33,
        C=torch.zeros((15, 15), dtype=z3.dtype, device=z3.device),
        dT=torch.zeros((), dtype=z3.dtype, device=z3.device),
        bias_gyro=bias_gyro, bias_acc=bias_acc,
    )


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def integrate(acc: torch.Tensor, gyro: torch.Tensor, dt: torch.Tensor, bias_gyro: torch.Tensor,
              bias_acc: torch.Tensor, calib: ImuCalib) -> Preintegrated:
    """Integrate one window of midpoint-averaged samples acc (N,3), gyro
    (N,3), dt (N,) (`IntegrateNewMeasurement`, `ImuTypes.cc:266-336`):
    position and velocity with the old dR, covariance through the (A, B)
    system (Forster eq. 62-63), the bias-Jacobian recursion, then the
    rotation with re-normalization. A dt = 0 row leaves the covariance
    untouched, as in the reference."""
    s = init_preintegrated(bias_gyro, bias_acc)
    dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C, dT = s[:10]
    eye3 = torch.eye(3, dtype=acc.dtype, device=acc.device)
    z33 = torch.zeros_like(eye3)
    for k in range(acc.shape[0]):
        a = acc[k] - bias_acc
        w = gyro[k] - bias_gyro
        h = dt[k]
        h2 = h * h
        dRa = _mv(dR, a)
        dP_n = dP + dV * h + 0.5 * h2 * dRa
        dV_n = dV + h * dRa
        dRWa = dR @ lie.hat(a)
        dRi = lie.exp_so3(w * h)
        Jr = lie.right_jacobian_so3(w * h)
        A = torch.cat([
            torch.cat([dRi.T, z33, z33], 1),
            torch.cat([-h * dRWa, eye3, z33], 1),
            torch.cat([-0.5 * h2 * dRWa, h * eye3, eye3], 1),
        ], 0)
        B = torch.cat([
            torch.cat([h * Jr, z33], 1),
            torch.cat([z33, h * dR], 1),
            torch.cat([z33, 0.5 * h2 * dR], 1),
        ], 0)
        JPa_n = JPa + JVa * h - 0.5 * h2 * dR
        JPg_n = JPg + JVg * h - 0.5 * h2 * dRWa @ JRg
        JVa_n = JVa - h * dR
        JVg_n = JVg - h * dRWa @ JRg
        C99 = A @ C[:9, :9] @ A.T + B @ calib.cov @ B.T
        C_n = torch.cat([torch.cat([C99, C[:9, 9:]], 1),
                         torch.cat([C[9:, :9], C[9:, 9:] + calib.cov_walk], 1)], 0)
        C = torch.where(h > 0, C_n, C)
        JRg = dRi.T @ JRg - h * Jr
        dR = lie.normalize_rotation(dR @ dRi)
        dP, dV, JPa, JPg, JVa, JVg = dP_n, dV_n, JPa_n, JPg_n, JVa_n, JVg_n
        dT = dT + h
    return Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         C=C, dT=dT, bias_gyro=bias_gyro, bias_acc=bias_acc)


def delta_rotation(p: Preintegrated, bias_gyro: torch.Tensor) -> torch.Tensor:
    """First-order bias-corrected dR (`ImuTypes.cc:GetDeltaRotation:373`)."""
    dbg = bias_gyro - p.bias_gyro
    return lie.normalize_rotation(p.dR @ lie.exp_so3(_mv(p.JRg, dbg)))


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    """`GetDeltaVelocity` (`ImuTypes.cc:381`)."""
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dV + _mv(p.JVg, dbg) + _mv(p.JVa, dba)


def delta_position(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    """`GetDeltaPosition` (`ImuTypes.cc:389`)."""
    dbg = bias_gyro - p.bias_gyro
    dba = bias_acc - p.bias_acc
    return p.dP + _mv(p.JPg, dbg) + _mv(p.JPa, dba)


def merge(p1: Preintegrated, p2: Preintegrated, calib: ImuCalib) -> Preintegrated:
    """Two consecutive windows as one, composed in closed form under p1's
    bias (the reference's `MergePrevious`, `ImuTypes.cc:328`, re-integrates);
    the covariance by the first-order transition through p2."""
    dR = lie.normalize_rotation(p1.dR @ p2.dR)
    dV = p1.dV + _mv(p1.dR, p2.dV)
    dP = p1.dP + p1.dV * p2.dT + _mv(p1.dR, p2.dP)
    JRg = p2.dR.T @ p1.JRg + p2.JRg
    JVg = p1.JVg + p1.dR @ p2.JVg - p1.dR @ lie.hat(p2.dV) @ p1.JRg
    JVa = p1.JVa + p1.dR @ p2.JVa
    JPg = p1.JPg + p1.JVg * p2.dT + p1.dR @ p2.JPg - p1.dR @ lie.hat(p2.dP) @ p1.JRg
    JPa = p1.JPa + p1.JVa * p2.dT + p1.dR @ p2.JPa
    eye3 = torch.eye(3, dtype=p1.C.dtype, device=p1.C.device)
    z33 = torch.zeros_like(eye3)
    F = torch.cat([
        torch.cat([p2.dR.T, z33, z33], 1),
        torch.cat([-p1.dR @ lie.hat(p2.dV), eye3, z33], 1),
        torch.cat([-p1.dR @ lie.hat(p2.dP), p2.dT * eye3, eye3], 1),
    ], 0)
    C99 = F @ p1.C[:9, :9] @ F.T + p2.C[:9, :9]
    C = torch.cat([torch.cat([C99, p1.C[:9, 9:]], 1),
                   torch.cat([p1.C[9:, :9], p1.C[9:, 9:] + p2.C[9:, 9:]], 1)], 0)
    return Preintegrated(dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
                         C=C, dT=p1.dT + p2.dT, bias_gyro=p1.bias_gyro, bias_acc=p1.bias_acc)


def information_matrix(p: Preintegrated) -> torch.Tensor:
    """(9,9) information of [phi, v, p] (`GetInformationMatrix`,
    `ImuTypes.cc:450`): the symmetrized inverse of the covariance block
    (`inv_ex`: no host check of the factorization)."""
    C = p.C[:9, :9]
    C = 0.5 * (C + C.T) + 1e-12 * torch.eye(9, dtype=C.dtype, device=C.device)
    info = torch.linalg.inv_ex(C).inverse
    return 0.5 * (info + info.T)


def stack(pres) -> Preintegrated:
    """Windows stacked along a new leading axis (the reference's
    `tree_map(jnp.stack)`)."""
    return Preintegrated(*(torch.stack(xs) for xs in zip(*pres)))


def midpoint_samples(acc, gyro, ts, t_start, t_end):
    """Raw samples covering [t_start, t_end] -> midpoint-averaged (acc, gyro,
    dt) numpy arrays, with the window-border interpolation of
    `Tracking::PreintegrateIMU` (`Tracking.cc:719-757`) and the boundary
    hold of the last sample up to t_end (the `tstep = tend - t` tail path).
    A numpy copy of the JAX package's host helper."""
    acc = np.asarray(acc, np.float32)
    gyro = np.asarray(gyro, np.float32)
    ts = np.asarray(ts, np.float64)
    n = len(ts)
    a_out, g_out, dt_out = [], [], []
    for i in range(n - 1):
        t0, t1 = ts[i], ts[i + 1]
        if t1 <= t_start or t0 >= t_end:
            continue
        tini = max(t0, t_start)
        tend_ = min(t1, t_end)
        if t1 == t0:
            continue
        a0, a1 = acc[i], acc[i + 1]
        w0, w1 = gyro[i], gyro[i + 1]
        f0 = (tini - t0) / (t1 - t0)
        f1 = (tend_ - t0) / (t1 - t0)
        ai = a0 + f0 * (a1 - a0)
        ae = a0 + f1 * (a1 - a0)
        wi = w0 + f0 * (w1 - w0)
        we = w0 + f1 * (w1 - w0)
        a_out.append(0.5 * (ai + ae))
        g_out.append(0.5 * (wi + we))
        dt_out.append(tend_ - tini)
    if n >= 1:
        if ts[0] > t_start and ts[0] < t_end:
            a_out.insert(0, acc[0])
            g_out.insert(0, gyro[0])
            dt_out.insert(0, float(ts[0] - t_start))
        if ts[-1] < t_end and ts[-1] > t_start:
            a_out.append(acc[-1])
            g_out.append(gyro[-1])
            dt_out.append(float(t_end - max(ts[-1], t_start)))
    if not a_out:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
                np.zeros((0,), np.float32))
    return (np.stack(a_out).astype(np.float32), np.stack(g_out).astype(np.float32),
            np.asarray(dt_out, np.float32))
