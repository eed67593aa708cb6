"""Port parity: the pose-inertial solves (`orbslam3_tpu_torch.optim.
pose_inertial`) against the JAX package on the CPU: the keyframe -> frame
1 (LastKeyFrame) -> frame 2 (LastFrame) chain of
`tests/test_pose_inertial.py`, with mono rows only and with stereo-`ur`
rows, and a camera offset from the body. Gates: the same inlier set; pose,
velocity and biases within 1e-4; H within 1e-3 of its largest entry (its
position rows reach ~1e7 from the whitened IMU edge)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import pose_inertial as pi_j
from orbslam3_tpu.optim.pose_only import PoseObs as PoseObsJ
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.optim import pose_inertial as pi_t
from orbslam3_tpu_torch.optim.pose_only import PoseObs as PoseObsT
from tests.test_pose_inertial import _propagate

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

BF = 300.0 * 0.11


def T(x):
    return torch.from_numpy(np.array(x, np.float32))


def _obs(rng, params, R_wb, p_wb, Rbc, tbc, stereo: bool, N=96):
    """Seeded observations of the frame at body pose (R_wb, p_wb); 10%
    outliers; with `stereo`, half the rows carry a right u."""
    Xw = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 6, N)],
                  -1).astype(np.float32)
    Rwc, twc = R_wb @ Rbc, p_wb + R_wb @ tbc
    Xc = (Xw - twc) @ Rwc
    uv = np.asarray(cam_j.pinhole_project(params, jnp.asarray(Xc))).copy()
    uv += rng.normal(0, 0.3, uv.shape)
    out = rng.random(N) < 0.1
    uv[out] += rng.uniform(30, 80, (out.sum(), 2))
    ur = np.full(N, -1.0)
    if stereo:
        has = rng.random(N) < 0.5
        ur[has] = uv[has, 0] - BF / Xc[has, 2] + rng.normal(0, 0.3, has.sum())
    arrays = dict(Xw=Xw, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
                  sigma2=(1.2 ** (2 * rng.integers(0, 3, N))).astype(np.float32),
                  valid=Xc[:, 2] > 0.3)
    return (PoseObsJ(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            PoseObsT(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}))


def _same(rt, rj, H_tol=1e-3):
    assert np.array_equal(rt.inlier.numpy(), np.asarray(rj.inlier))
    assert int(rt.n_inliers) == int(rj.n_inliers)
    for name in ("R_wb", "p_wb", "v", "bg", "ba", "Rcw", "tcw"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)),
                                   atol=1e-4, err_msg=name)
    Hj = np.asarray(rj.H)
    np.testing.assert_allclose(rt.H.numpy(), Hj, atol=H_tol * np.abs(Hj).max())


@pytest.mark.parametrize("stereo", [False, True])
def test_pose_inertial_chain(stereo):
    rng = np.random.default_rng(11 + stereo)
    Rbc = np.asarray(lie_j.exp_so3(jnp.asarray([0.02, -0.03, 0.01]))).astype(np.float32)
    tbc = np.array([0.03, -0.01, 0.02], np.float32)
    cj = imu_j.ImuCalib.create(Rbc, tbc, 1.7e-4, 2e-3, 2e-5, 3e-3, 200.0)
    params = cam_j.make_pinhole(300.0, 300.0, 320.0, 240.0)
    params_t = T(np.asarray(params))
    bf = BF if stereo else 0.0
    model_j, model_t = cam_j.CameraModel.PINHOLE, cam_t.CameraModel.PINHOLE

    R_kf = np.eye(3, dtype=np.float32)
    p_kf = np.zeros(3, np.float32)
    v_kf = np.array([0.3, -0.1, 0.05], np.float32)
    bg_kf = np.array([0.002, -0.001, 0.001], np.float32)
    ba_kf = np.array([0.01, 0.02, -0.01], np.float32)
    (R1, p1, v1), (acc1, gyr1, dt1) = _propagate(R_kf, p_kf, v_kf, (0.1, -0.2, 0.3),
                                                 (0.4, 0.1, 0.2))
    pre1 = imu_j.integrate(jnp.asarray(acc1), jnp.asarray(gyr1), jnp.asarray(dt1),
                           jnp.zeros(3), jnp.zeros(3), cj)
    oj, ot = _obs(rng, params, R1, p1, Rbc, tbc, stereo)
    dR = np.asarray(lie_j.exp_so3(jnp.asarray([0.03, -0.02, 0.04])))
    g1 = (R1 @ dR, p1 + [0.05, -0.04, 0.06], v1 + [0.3, -0.2, 0.25])
    r1j = pi_j.optimize_pose_inertial(
        model_j, params, oj, jnp.asarray(Rbc), jnp.asarray(tbc), jnp.asarray(R_kf),
        jnp.asarray(p_kf), jnp.asarray(v_kf), jnp.asarray(bg_kf), jnp.asarray(ba_kf), pre1,
        *(jnp.asarray(x, jnp.float32) for x in g1), bf=bf)
    r1t = pi_t.optimize_pose_inertial(
        model_t, params_t, ot, T(Rbc), T(tbc), T(R_kf), T(p_kf), T(v_kf), T(bg_kf), T(ba_kf),
        convert.preintegrated(pre1, "cpu"), *(T(x) for x in g1), bf=bf)
    _same(r1t, r1j)
    assert np.linalg.norm(r1t.p_wb.numpy() - p1) < 2e-2

    (R2, p2, v2), (acc2, gyr2, dt2) = _propagate(R1, p1, v1, (-0.2, 0.1, 0.15),
                                                 (-0.3, 0.2, 0.1))
    pre2 = imu_j.integrate(jnp.asarray(acc2), jnp.asarray(gyr2), jnp.asarray(dt2),
                           r1j.bg, r1j.ba, cj)
    oj, ot = _obs(rng, params, R2, p2, Rbc, tbc, stereo)
    dR = np.asarray(lie_j.exp_so3(jnp.asarray([0.02, -0.03, 0.02])))
    g2 = (R2 @ dR, p2 + [0.04, -0.03, 0.05], v2 + [0.2, -0.15, 0.2])
    # Both continue from the JAX package's frame-1 result (its H on the host).
    anchor = [np.asarray(x) for x in (r1j.R_wb, r1j.p_wb, r1j.v, r1j.bg, r1j.ba)]
    r2j = pi_j.optimize_pose_inertial_last_frame(
        model_j, params, oj, jnp.asarray(Rbc), jnp.asarray(tbc), *map(jnp.asarray, anchor),
        r1j.H, pre2, *(jnp.asarray(x, jnp.float32) for x in g2), bf=bf)
    r2t = pi_t.optimize_pose_inertial_last_frame(
        model_t, params_t, ot, T(Rbc), T(tbc), *map(T, anchor), np.asarray(r1j.H),
        convert.preintegrated(pre2, "cpu"), *(T(x) for x in g2), bf=bf)
    _same(r2t, r2j)
    assert np.linalg.norm(r2t.p_wb.numpy() - p2) < 2e-2


def test_psd_clamp():
    """The host clamp against the JAX package's: within 1e-5 of the largest
    entry, and PSD."""
    rng = np.random.default_rng(5)
    A = rng.normal(0, 1, (15, 15)).astype(np.float32)
    H = (A @ A.T - 3.0 * np.eye(15)).astype(np.float32) * np.logspace(0, 4, 15)[None]
    got = pi_t.psd_clamp(H)
    want = np.asarray(pi_j.psd_clamp(jnp.asarray(H)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert np.linalg.eigvalsh(got.astype(np.float64)).min() > -1e-4 * np.abs(want).max()


def test_hand_jacobians_equal_torch_func():
    """The solves' hand-written Jacobians against `torch.func`: the
    reprojection rows (mono and stereo) by the body's [dtheta, dp], and
    `inv_right_jacobian_so3` (the prior rows' rotation block) as the
    derivative of `log_so3` under a right perturbation; within 1e-4 of each
    Jacobian's largest entry."""
    from orbslam3_tpu_torch.ops import lie

    rng = np.random.default_rng(3)
    R = lie.exp_so3(torch.tensor([0.1, -0.2, 0.05]))
    p = torch.tensor([0.1, 0.0, -0.2])
    Rbc = lie.exp_so3(torch.tensor([0.02, 0.01, -0.03]))
    tbc = torch.tensor([0.03, -0.01, 0.02])
    _, ot = _obs(rng, np.asarray(cam_j.make_pinhole(300.0, 300.0, 320.0, 240.0)), R.numpy(),
                 p.numpy(), Rbc.numpy(), tbc.numpy(), stereo=True, N=40)
    params = T([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
    model = cam_t.CameraModel.PINHOLE
    _, _, _, J = pi_t._vis_rows(model, params, BF, R, p, Rbc, tbc, ot)

    def e_of(d):
        Rd, pd, *_ = pi_t._retract(R, p, p, p, p, torch.cat([d, torch.zeros(9)]))
        return pi_t._vis_rows(model, params, BF, Rd, pd, Rbc, tbc, ot)[0]

    J_ad = torch.func.jacrev(e_of)(torch.zeros(6))
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-4 * float(J.abs().max()))
    for w in ([0.3, -0.2, 0.1], [1e-3, 2e-3, -1e-3], [0.0, 0.0, 0.0]):
        R0 = lie.exp_so3(torch.tensor(w))
        Jinv = lie.inv_right_jacobian_so3(lie.log_so3(R0[None]))[0]
        J_ad = torch.func.jacrev(lambda d: lie.log_so3((R0 @ lie.exp_so3(d[None])[0])[None])[0])(
            torch.zeros(3))
        np.testing.assert_allclose(Jinv.numpy(), J_ad.numpy(), atol=1e-4)
