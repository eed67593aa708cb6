"""Port parity: the bundle-adjustment pieces of the mapping pass against the
JAX package on the CPU — `cameras.unproject`, `lm.inv3x3`, `ba._chol3x3`,
`ba._linearize`, `ba._robust_cost`, the dense-Schur `solve_ba` and
`store.update_poses_points` — on seeded numpy inputs. Float32 pieces agree
within 1e-5 relative; the LM solve within the tolerances of each test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import ba as ba_j
from orbslam3_tpu.optim import lm as lm_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.optim import ba as ba_t
from orbslam3_tpu_torch.optim import lm as lm_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

FX, FY, CX, CY = 458.654, 457.296, 376.0, 240.0


def _close(got, ref, rtol=1e-5, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    # Relative to the array's scale: entries near zero carry absolute error.
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale + atol)


def _make_ba(C=8, P=400, obs_per_cam=60, n_fixed=2, fixed_last=True, seed=0,
             stereo_every=0, n_invalid=0):
    """numpy BA problem shaped like `bench.py::_make_ba` (a forward
    trajectory, noisy pixels, perturbed cameras and points), with small
    random rotations. Optional: every `stereo_every`-th row stereo, and
    `n_invalid` rows marked invalid."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P), rng.uniform(4, 12, P)],
                   -1).astype(np.float32)
    cam_R = np.asarray(lie_j.exp_so3(jnp.asarray(
        rng.normal(0, 0.02, (C, 3)).astype(np.float32))))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.linspace(0, 1.5, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_cam)
    obs_pt = np.concatenate([rng.choice(P, obs_per_cam, replace=False)
                             for _ in range(C)]).astype(np.int32)
    Xc = np.einsum("oij,oj->oi", cam_R[obs_cam], pts[obs_pt]) + cam_t[obs_cam]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    O = len(obs_cam)
    ur = np.full(O, -1.0, np.float32)
    if stereo_every:
        s = np.arange(O) % stereo_every == 0
        ur[s] = uv[s, 0] - 40.0 / Xc[s, 2] + rng.normal(0, 0.5, s.sum()).astype(np.float32)
    valid = np.ones(O, bool)
    valid[rng.choice(O, n_invalid, replace=False)] = False
    fixed = (np.arange(C) >= C - n_fixed) if fixed_last else (np.arange(C) < n_fixed)
    oct_ = rng.integers(0, 4, O)
    return dict(
        cam_R=cam_R, cam_t=(cam_t + rng.normal(0, 0.01, cam_t.shape)).astype(np.float32),
        cam_fixed=fixed, points=(pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32),
        point_valid=np.ones(P, bool), obs_cam=obs_cam, obs_point=obs_pt, obs_uv=uv,
        obs_ur=ur, obs_sigma2=(1.44 ** oct_).astype(np.float32), obs_valid=valid,
    )


def _probs(d):
    return (ba_j.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
            ba_t.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()}))


def _params(dist=(0.0, 0.0, 0.0, 0.0)):
    return cam_j.make_pinhole(FX, FY, CX, CY, *dist), cam_t.make_pinhole(FX, FY, CX, CY, *dist)


@pytest.mark.parametrize("dist", [(0.0, 0.0, 0.0, 0.0), (-0.28, 0.07, 2e-4, 1.8e-5)])
def test_unproject(dist):
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(0, 752, 500), rng.uniform(0, 480, 500)], -1).astype(np.float32)
    pj, pt = _params(dist)
    ref = cam_j.unproject(cam_j.CameraModel.PINHOLE, pj, jnp.asarray(uv))
    got = cam_t.unproject(cam_t.CameraModel.PINHOLE, pt, torch.from_numpy(uv))
    _close(got, ref)


def test_inv3x3_and_chol3x3():
    rng = np.random.default_rng(2)
    A = rng.normal(0, 1, (300, 3, 3)).astype(np.float32)
    spd = (A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3)).astype(np.float32)
    for M in (A, spd):
        _close(lm_t.inv3x3(torch.from_numpy(M)), lm_j.inv3x3(jnp.asarray(M)))
    L_t = ba_t._chol3x3(torch.from_numpy(spd))
    _close(L_t, ba_j._chol3x3(jnp.asarray(spd)))
    np.testing.assert_allclose((L_t @ L_t.transpose(1, 2)).numpy(), spd, rtol=1e-4, atol=1e-4)


def test_linearize_and_robust_cost():
    """Mono and stereo rows (bf 40), invalid rows, one fixed camera column."""
    d = _make_ba(stereo_every=3, n_invalid=40, seed=3)
    pj, pt = _params()
    prob_j, prob_t = _probs(d)
    bf = 40.0
    ref = ba_j._linearize(cam_j.CameraModel.PINHOLE, pj, bf, prob_j.cam_R, prob_j.cam_t,
                          prob_j.points, prob_j, jnp.ones_like(prob_j.obs_valid))
    got = ba_t._linearize(cam_t.CameraModel.PINHOLE, pt, bf, prob_t.cam_R, prob_t.cam_t,
                          prob_t.points, prob_t, torch.ones_like(prob_t.obs_valid))
    # Residuals are differences of ~400 px coordinates: they agree within
    # float32 rounding of the pixels (2e-7 of 752 px), not relative to
    # themselves; chi2 = |e|^2 / sigma^2 inherits that.
    px = 2e-7 * 752
    e_max = float(np.abs(np.asarray(ref[0])).max())
    _close(got[0], ref[0], rtol=0, atol=px)
    _close(got[3], ref[3], atol=2 * e_max * px)
    for g, r in zip(got[1:3], ref[1:3]):  # Jc_w, Jp_w
        _close(g, r, atol=1e-6)
    for g, r in zip(got[4:], ref[4:]):  # ok, is_stereo
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    chi2_j, ok_j, st_j_ = ref[3:]
    n_struct = float(d["obs_valid"].sum())
    for n in (None, n_struct):
        _close(ba_t._robust_cost(*got[3:], n_struct=n),
               ba_j._robust_cost(chi2_j, ok_j, st_j_, n_struct=n))


@pytest.mark.parametrize("layout", ["window_prefix", "full"])
def test_solve_ba_dense(layout):
    """The dense-Schur LM on both paths: window prefix + camera-major
    observations + early stop (the local BA's), and the plain layout."""
    if layout == "window_prefix":
        d = _make_ba(fixed_last=True, seed=4)
        kw = dict(n_opt_prefix=6, obs_per_cam=60, early_stop_tol=1e-3)
    else:
        d = _make_ba(fixed_last=False, seed=5, n_invalid=20)
        kw = {}
    pj, pt = _params()
    prob_j, prob_t = _probs(d)
    ref = ba_j.solve_ba(cam_j.CameraModel.PINHOLE, pj, prob_j, iters=10, dense_schur=True, **kw)
    got = ba_t.solve_ba(cam_t.CameraModel.PINHOLE, pt, prob_t, iters=10, dense_schur=True, **kw)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
    np.testing.assert_allclose(got.cam_R.numpy(), np.asarray(ref.cam_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))
    # The solve did work: the cameras moved and the cost fell below the start.
    start = ba_t.solve_ba(cam_t.CameraModel.PINHOLE, pt, prob_t, iters=0, dense_schur=True, **kw)
    assert float(got.cost) < float(start.cost)
    assert float((got.cam_t - prob_t.cam_t).abs().max()) > 1e-4


def test_solve_ba_pcg_path_is_not_ported():
    """(The name is older than the port of the PCG path.) `solve_ba` without
    `dense_schur` takes the matrix-free PCG path, as the reference does, and
    lands within 1e-4 (poses) and 1e-3 (points) of the reference's, with
    stereo rows and invalid rows in the problem. Every camera sees every
    point: a point seen once has a depth that only the damping fixes, where
    two float32 solvers part by 1e-2."""
    d = _make_ba(C=6, P=100, obs_per_cam=100, fixed_last=False, seed=5, n_invalid=20,
                 stereo_every=3)
    pj, pt = _params()
    prob_j, prob_t = _probs(d)
    ref = ba_j.solve_ba(cam_j.CameraModel.PINHOLE, pj, prob_j, bf=40.0, iters=10, pcg_iters=50)
    got = ba_t.solve_ba(cam_t.CameraModel.PINHOLE, pt, prob_t, bf=40.0, iters=10, pcg_iters=50)
    np.testing.assert_allclose(got.cam_R.numpy(), np.asarray(ref.cam_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))


def test_update_poses_points():
    """Masked write-back. The reference also writes the old value back
    through the masked-out rows; where such a row's clipped id repeats a
    written one (fault C6: keyframe 0 here, after a -1 pad), the write is
    lost. The port writes the masked rows only."""
    rng = np.random.default_rng(6)
    s = convert.to_numpy(st_t.empty_map(Kmax=8, Pmax=64, Nf=16, device="cpu"))
    kf_ids = np.asarray([0, 3, 5, 0], np.int32)  # the last row is a clipped -1 pad
    kf_mask = np.asarray([True, True, False, False])
    mp_ids = np.asarray([2, 7, 9, 63, 63], np.int32)  # ...and a clipped pad point slot
    mp_mask = np.asarray([True, True, False, True, False])
    R = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.3, (4, 3)).astype(np.float32))))
    t = rng.normal(0, 1, (4, 3)).astype(np.float32)
    pos = rng.normal(0, 1, (5, 3)).astype(np.float32)
    args = (kf_ids, R, t, kf_mask, mp_ids, pos, mp_mask)
    ref = st_j.update_poses_points(st_j.MapState(*(jnp.asarray(x) for x in s)),
                                   *(jnp.asarray(x) for x in args))
    got = st_t.update_poses_points(convert.to_torch(s, "cpu"),
                                   *(torch.from_numpy(np.array(x)) for x in args))
    for k in ("kf_R", "kf_t", "mp_pos"):
        g, r = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        np.testing.assert_array_equal(np.delete(g, [0] if k != "mp_pos" else [63], 0),
                                      np.delete(r, [0] if k != "mp_pos" else [63], 0))
    np.testing.assert_array_equal(got.kf_t.numpy()[[0, 3]], t[[0, 1]])
    np.testing.assert_array_equal(got.mp_pos.numpy()[[2, 7, 63]], pos[[0, 1, 3]])
    np.testing.assert_array_equal(got.kf_t.numpy()[5], s.kf_t[5])
    # The reference lost both writes that a pad row repeats.
    np.testing.assert_array_equal(np.asarray(ref.kf_t)[0], s.kf_t[0])
    np.testing.assert_array_equal(np.asarray(ref.mp_pos)[63], s.mp_pos[63])
