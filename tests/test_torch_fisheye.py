"""Port parity: the Kannala-Brandt 8 camera (`orbslam3_tpu_torch/ops/
cameras.py`), the two-camera rig's lapping-area match and its triangulation
(`ops/stereo.py::match_stereo_fisheye`, `ops/ransac.py::triangulate_linear`)
against `orbslam3_tpu/ops/cameras.py` and `ops/stereo.py` on the CPU, and
config 4's settings against `scripts/make_synth_euroc.py --fisheye`.

Tolerances: projection, unprojection and the projection Jacobian within
1e-5 relative (float32 on both sides; the same formulas), on the axis
(r = 0, the model's limit branches), near it, and beyond 80 degrees off
axis; the Jacobian also against `torch.func.jacrev` of the port's own
projection. The match: `right_idx` and `valid` equal, depth and the
triangulated points within 1e-4 m. The port triangulates without an SVD
(on CUDA `torch.linalg.svd` reads its convergence flags on the host, a
sync per frame): its inverse iteration in float64 gives the reference's
DLT point within 1e-4 m, which is within the reference's own float32 error
against the true point.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.ops import ransac as ransac_j
from orbslam3_tpu.ops import stereo as stereo_j
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import ransac as ransac_t
from orbslam3_tpu_torch.ops import stereo as stereo_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

# The reference's fisheye test camera (`tests/test_stereo.py`), TUM-VI-like.
KB8 = np.array([190.978477, 190.973307, 254.931706, 256.897442, 0.003482389402,
                0.000715034845, -0.002053236141, 0.000202936736], np.float32)


def _points(rng, n=400):
    """Camera-frame points: on the axis, within 1e-6 of it, and directions
    from 0 to 85 degrees off axis at 0.3-8 m."""
    theta = np.concatenate([np.zeros(2), np.full(2, 1e-7), rng.uniform(0, np.radians(85), n)])
    phi = rng.uniform(-np.pi, np.pi, theta.shape)
    dist = rng.uniform(0.3, 8.0, theta.shape)
    d = np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)
    X = (d * dist[:, None]).astype(np.float32)
    X[0] = [0.0, 0.0, 2.0]
    return X


def test_kb8_project_and_jacobian_match_reference():
    X = _points(np.random.default_rng(0))
    assert np.degrees(np.arccos(X[:, 2] / np.linalg.norm(X, axis=1))).max() > 80
    uv_j = np.asarray(cam_j.project(cam_j.CameraModel.KB8, jnp.asarray(KB8), jnp.asarray(X)))
    uv_t = cam_t.project(cam_t.CameraModel.KB8, torch.from_numpy(KB8), torch.from_numpy(X))
    np.testing.assert_allclose(uv_t.numpy(), uv_j, rtol=1e-5, atol=1e-5 * 256)
    np.testing.assert_allclose(uv_t.numpy()[:2], np.tile(KB8[2:4], (2, 1)), atol=1e-4)
    J_j = np.asarray(cam_j.project_jac(cam_j.CameraModel.KB8, jnp.asarray(KB8), jnp.asarray(X)))
    J_t = cam_t.project_jac(cam_t.CameraModel.KB8, torch.from_numpy(KB8), torch.from_numpy(X))
    assert np.isfinite(J_t.numpy()).all()
    np.testing.assert_allclose(J_t.numpy(), J_j, rtol=1e-5, atol=1e-5 * np.abs(J_j).max())
    # Against autodiff of the projection, away from the axis (where the
    # reference's Jacobian floors r and autodiff of its limit branch differs).
    far = X[4:].astype(np.float64)
    auto = torch.func.vmap(torch.func.jacrev(
        lambda x: cam_t.kb8_project(torch.from_numpy(KB8.astype(np.float64)), x)))(
        torch.from_numpy(far))
    J64 = cam_t.kb8_project_jac(torch.from_numpy(KB8.astype(np.float64)), torch.from_numpy(far))
    np.testing.assert_allclose(J64.numpy(), auto.numpy(), rtol=1e-6, atol=1e-6)


def test_kb8_unproject_matches_reference_and_inverts_project():
    """Pixels over the whole 512x512 image (corners beyond 90 degrees, which
    the model's clamp at pi/2 folds), the principal point, and the
    projections of points up to 85 degrees: the same rays as the
    reference; the rays of projected points point back at them."""
    u, v = np.meshgrid(np.linspace(0, 511, 23), np.linspace(0, 511, 19))
    uv = np.concatenate([np.stack([u.ravel(), v.ravel()], -1), KB8[None, 2:4]]).astype(np.float32)
    X = _points(np.random.default_rng(1))
    uv_p = cam_t.project(cam_t.CameraModel.KB8, torch.from_numpy(KB8), torch.from_numpy(X))
    uv = np.concatenate([uv, uv_p.numpy()])
    r_j = np.asarray(cam_j.unproject(cam_j.CameraModel.KB8, jnp.asarray(KB8), jnp.asarray(uv)))
    r_t = cam_t.unproject(cam_t.CameraModel.KB8, torch.from_numpy(KB8), torch.from_numpy(uv))
    r_t = r_t.numpy()
    assert np.isfinite(r_t).all()
    np.testing.assert_allclose(r_t, r_j, rtol=1e-5, atol=1e-5)
    n = len(X)
    ray = r_t[-n:] / np.linalg.norm(r_t[-n:], axis=1, keepdims=True)
    dirs = X / np.linalg.norm(X, axis=1, keepdims=True)
    assert np.abs(ray - dirs).max() < 1e-4


def test_triangulate_linear_matches_the_reference_dlt():
    rng = np.random.default_rng(2)
    n = 500
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                    rng.uniform(0.5, 6, n)], -1).astype(np.float32)
    R = np.asarray(lie_j.exp_so3(jnp.asarray([0.01, 0.05, 0.0], jnp.float32)))
    t = np.array([-0.15, 0.0, 0.0], np.float32)
    X2 = pts @ R.T + t
    noise = rng.normal(0, 0.3 / 190, (2, n, 2)).astype(np.float32)
    p1 = (pts[:, :2] / pts[:, 2:] + noise[0]).astype(np.float32)
    p2 = (X2[:, :2] / X2[:, 2:] + noise[1]).astype(np.float32)
    X_j = np.asarray(ransac_j.triangulate_linear(*(jnp.asarray(a) for a in (R, t, p1, p2))))
    X_t = ransac_t.triangulate_linear(*(torch.from_numpy(a) for a in (R, t, p1, p2))).numpy()
    np.testing.assert_allclose(X_t, X_j, atol=1e-4, rtol=0)


def _features(uv, desc, octave):
    n = len(uv)
    return feat_j.Features(uv=uv.astype(np.float32), response=np.ones(n, np.float32),
                           octave=octave.astype(np.int32), angle=np.zeros(n, np.float32),
                           desc=desc, valid=np.ones(n, bool))


@pytest.mark.parametrize("lap", [(0.0, 512.0), (120.0, 400.0)])
def test_match_stereo_fisheye_matches_reference(lap):
    """The reference's rig scene (`tests/test_stereo.py::
    test_fisheye_stereo_triangulation`: 256 points at 1-4 m, a 0.05 rad
    toe-in and a 0.1 m baseline), with a quarter of the right descriptors
    scrambled, one-pixel noise on a tenth of the right keypoints (some fail
    the reprojection gate) and octaves 0-2, with the whole image and with a
    narrower lapping area: the same matches and valid set, depth and points
    within 1e-4 m, and the points of noise-free matches within 2 cm of the
    truth."""
    rng = np.random.default_rng(3)
    n = 256
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(1.0, 4.0, n)],
                   -1).astype(np.float32)
    R_rl = np.asarray(lie_j.exp_so3(jnp.asarray([0.0, 0.05, 0.0], jnp.float32)))
    t_rl = np.array([-0.1, 0.0, 0.0], np.float32)
    uv_l = np.asarray(cam_j.kb8_project(jnp.asarray(KB8), jnp.asarray(pts)))
    uv_r = np.asarray(cam_j.kb8_project(jnp.asarray(KB8), jnp.asarray(pts @ R_rl.T + t_rl)))
    noisy = rng.uniform(size=n) < 0.1
    uv_r = uv_r + noisy[:, None] * rng.normal(0, 1.0, (n, 2))
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    desc_r = desc.copy()
    scramble = rng.uniform(size=n) < 0.25
    desc_r[scramble] = rng.integers(0, 256, (int(scramble.sum()), 32), dtype=np.uint8)
    octave = rng.integers(0, 3, n)
    fl, fr_ = _features(uv_l, desc, octave), _features(uv_r, desc_r, octave)
    s2 = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    got_j = stereo_j.match_stereo_fisheye(
        cam_j.CameraModel.KB8, jnp.asarray(KB8), jnp.asarray(KB8),
        feat_j.Features(*(jnp.asarray(x) for x in fl)),
        feat_j.Features(*(jnp.asarray(x) for x in fr_)), jnp.asarray(R_rl), jnp.asarray(t_rl),
        jnp.asarray(s2), lap_l=lap, lap_r=lap)
    got_t = stereo_t.match_stereo_fisheye(
        cam_t.CameraModel.KB8, torch.from_numpy(KB8), torch.from_numpy(KB8),
        feat_t.Features(*(torch.from_numpy(np.asarray(x)) for x in fl)),
        feat_t.Features(*(torch.from_numpy(np.asarray(x)) for x in fr_)),
        torch.from_numpy(R_rl), torch.from_numpy(t_rl), torch.from_numpy(s2), lap_l=lap,
        lap_r=lap)
    Xl_j, d_j, idx_j, ok_j = (np.asarray(x) for x in got_j)
    Xl_t, d_t, idx_t, ok_t = (x.numpy() for x in got_t)
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(idx_t, idx_j)
    assert 0.3 * n < ok_j.sum() < 0.8 * n
    np.testing.assert_allclose(d_t, d_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(Xl_t[ok_j], Xl_j[ok_j], atol=1e-4, rtol=0)
    clean = ok_t & ~noisy
    np.testing.assert_allclose(Xl_t[clean], pts[clean], atol=0.02)


def test_config4_is_the_scripts_fisheye_settings():
    """`entry.EUROC_STEREO_VI_FISHEYE` holds `make_synth_euroc.py
    --fisheye`'s cameras, rig and IMU, and its frames are the script's
    512x512 pair (a few rendered here)."""
    M = E.synth_euroc()
    cfg = E.EUROC_STEREO_VI_FISHEYE
    params2, Tlr, lap1, lap2 = cfg["camera2"]
    np.testing.assert_array_equal(cfg["camera"], M.FE_INTR_L)
    np.testing.assert_array_equal(params2, M.FE_INTR_R)
    np.testing.assert_array_equal(Tlr[:3, 3], [M.FE_BASELINE_M, 0.0, 0.0])
    assert cfg["img_wh"] == (M.FE_W, M.FE_H) and lap1 == lap2 == (0.0, M.FE_W - 1.0)
    assert cfg["orb"] == feat_t.OrbParams(1000, 8, 1.2, 20.0, 7.0)
    assert cfg["imu"] == E.EUROC_MONO_VI["imu"]
    ts, imgs, centres, imu = E.euroc_frames(3, 0, imu=True, fisheye=True)
    assert imgs.shape == (3, 2, 512, 512) and imgs.dtype == np.uint8
    assert np.abs(np.linalg.norm(centres[:, :2], axis=1) - 1.4).max() < 0.2  # the 1.4 m circle
    assert len(imu[0]) == int(round(2 / 20 * 200)) + 1
    assert 40 < imgs[:, :, 100:400, 100:400].std() < 90  # textured, not blank
