"""Port parity: a two-camera rig's right-camera rows
(`EdgeSE3ProjectXYZOnlyPoseToBody` / `EdgeSE3ProjectXYZToBody`) in the pose
solve (`orbslam3_tpu_torch/optim/pose_only.py`), in the tracker's pose
solve from associations (`pipeline/tracking.py::_pose_opt_from_assoc`) and
in the dense-Schur BA (`optim/ba.py`, `cam2`), against the JAX package on
the CPU on the scenes of `tests/test_two_cam.py` (a pinhole pair 0.11 m
apart with a small relative rotation) and on a Kannala-Brandt 8 pair; and
`ba.CameraSums`, the BA's per-camera sums.

Tolerances: the right rows' errors and Jacobians within 1e-4 (float32,
the same formulas), the Jacobian also against `torch.func.jacrev` of the
port's own errors; the pose solve within 1e-4 with the same inlier set;
the BA with right rows: after 2 LM iterations poses and points within
1e-4, after the reference test's 8 the poses within 1e-4, the cost within
1e-5 relative and each point within 1e-4 of its distance, with the same
inlier set. The scene's points are weakly held in depth (4-9 m seen from a
1 m line of cameras), and the cost is nearly flat there: over iterations
3-8 the two packages' float32 steps walk the points apart by up to 7e-4 m
at 8 m, on this scene's pinhole pair without the right rows as much as
with them (4.7e-4 m with every row a left one), while their costs agree to
1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import ba as ba_j
from orbslam3_tpu.optim import pose_only as po_j
from orbslam3_tpu.pipeline import tracking as trk_j
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import lie as lie_t
from orbslam3_tpu_torch.optim import ba as ba_t
from orbslam3_tpu_torch.optim import pose_only as po_t
from orbslam3_tpu_torch.pipeline import tracking as trk_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

PIN_L = np.array([300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0], np.float32)
PIN_R = np.array([305.0, 298.0, 158.0, 122.0, 0, 0, 0, 0], np.float32)
KB8_L = np.array([190.97, 190.97, 254.93, 256.90, 0.0034823894, 0.00071503485,
                  -0.0020532361, 0.00020293674], np.float32)
KB8_R = np.array([190.44, 190.44, 252.20, 254.00, 0.0034003171, 0.0017662782,
                  -0.0026631257, 0.00032995174], np.float32)
RIGS = {"pinhole": (cam_t.CameraModel.PINHOLE, PIN_L, PIN_R),
        "kb8": (cam_t.CameraModel.KB8, KB8_L, KB8_R)}


def _extrinsics():
    R_rl = np.asarray(lie_j.exp_so3(jnp.asarray([0.01, -0.02, 0.005], jnp.float32)))
    return R_rl, np.asarray([-0.11, 0.002, -0.001], np.float32)


def _T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pose_scene(rng, model, pl, pr, n=120):
    """`test_two_cam.py::test_pose_two_cam_recovers`'s frame: points at 3-8 m,
    0.3 px noise, half of them with a right match, a few outliers."""
    R_rl, t_rl = _extrinsics()
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                  -1).astype(np.float32)
    R_true = np.asarray(lie_j.exp_so3(jnp.asarray([0.05, -0.03, 0.08], jnp.float32)))
    t_true = np.asarray([0.3, -0.2, 0.1], np.float32)
    Xc = Xw @ R_true.T + t_true
    proj = lambda p, X: np.asarray(cam_j.project(model, jnp.asarray(p), jnp.asarray(X)))
    uv_l = proj(pl, Xc) + rng.normal(0, 0.3, (n, 2))
    uv_r = proj(pr, Xc @ R_rl.T + t_rl) + rng.normal(0, 0.3, (n, 2))
    uv_l[:4] += 25.0  # left outliers
    uv_r[5:9] -= 25.0  # right outliers
    has_r = np.zeros(n, bool)
    has_r[: n // 2] = True
    s2 = (1.2 ** (2 * rng.integers(0, 3, n))).astype(np.float32)
    return dict(Xw=Xw, uv_l=uv_l.astype(np.float32), uv_r=uv_r.astype(np.float32), s2=s2,
                has_r=has_r, R_rl=R_rl, t_rl=t_rl, R_true=R_true, t_true=t_true)


def _obs(mod, arr, sc, uv, valid):
    n = len(sc["Xw"])
    return mod.PoseObs(Xw=arr(sc["Xw"]), uv=arr(uv), ur=arr(np.full(n, -1.0, np.float32)),
                       sigma2=arr(sc["s2"]), valid=arr(valid))


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_right_rows_match_reference(rig):
    model, pl, pr = RIGS[rig]
    sc = _pose_scene(np.random.default_rng(0), model, pl, pr)
    R0 = np.asarray(lie_j.exp_so3(jnp.asarray([0.03, 0.05, -0.02], jnp.float32)))
    t0 = np.asarray([0.2, -0.1, 0.05], np.float32)
    valid = np.ones(len(sc["Xw"]), bool)
    e_j, J_j, ok_j = (np.asarray(x) for x in po_j._residuals_right(
        model, jnp.asarray(pr), jnp.asarray(sc["R_rl"]), jnp.asarray(sc["t_rl"]),
        jnp.asarray(R0), jnp.asarray(t0), _obs(po_j, jnp.asarray, sc, sc["uv_r"], valid)))
    obs_t = _obs(po_t, _T, sc, sc["uv_r"], valid)
    e_t, J_t, ok_t = (x.numpy() for x in po_t._residuals_right(
        model, _T(pr), _T(sc["R_rl"]), _T(sc["t_rl"]), _T(R0), _T(t0), obs_t))
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_allclose(e_t, e_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(J_t, J_j, atol=1e-4 * np.abs(J_j).max(), rtol=0)
    # Against autodiff of the port's own errors (float64; left update).
    R64, t64 = _T(R0.astype(np.float64)), _T(t0.astype(np.float64))
    obs64 = po_t.PoseObs(*(x.to(torch.float64) if x.is_floating_point() else x for x in obs_t))
    args = (_T(pr.astype(np.float64)), _T(sc["R_rl"].astype(np.float64)),
            _T(sc["t_rl"].astype(np.float64)))

    def err(d):
        dR, dt = lie_t.exp_se3(d)
        Rn, tn = lie_t.se3_compose(dR, dt, R64, t64)
        return po_t._errors_right(model, *args, Rn, tn, obs64)[0]

    auto = torch.func.jacrev(err)(torch.zeros(6, dtype=torch.float64)).numpy()  # (n,2,6)
    J64 = po_t._residuals_right(model, *args, R64, t64, obs64)[1].numpy()[:, :2]
    np.testing.assert_allclose(J64, auto, atol=1e-6 * np.abs(auto).max(), rtol=1e-6)


@pytest.mark.parametrize("rig", sorted(RIGS))
def test_optimize_pose_with_right_rows_matches_reference(rig):
    """From the identity, left rows for every point and right rows for half:
    the same pose within 1e-4 and the same left inliers as the reference;
    the true pose recovered; the right outliers gated out."""
    model, pl, pr = RIGS[rig]
    sc = _pose_scene(np.random.default_rng(1), model, pl, pr)
    n = len(sc["Xw"])
    valid = np.ones(n, bool)
    res_j = po_j.optimize_pose(
        model, jnp.asarray(pl), jnp.eye(3), jnp.zeros(3),
        _obs(po_j, jnp.asarray, sc, sc["uv_l"], valid),
        obs_r=_obs(po_j, jnp.asarray, sc, sc["uv_r"], sc["has_r"]), params_r=jnp.asarray(pr),
        R_rl=jnp.asarray(sc["R_rl"]), t_rl=jnp.asarray(sc["t_rl"]))
    res_t = po_t.optimize_pose(
        model, _T(pl), torch.eye(3), torch.zeros(3), _obs(po_t, _T, sc, sc["uv_l"], valid),
        obs_r=_obs(po_t, _T, sc, sc["uv_r"], sc["has_r"]), params_r=_T(pr),
        R_rl=_T(sc["R_rl"]), t_rl=_T(sc["t_rl"]))
    np.testing.assert_allclose(res_t.R.numpy(), np.asarray(res_j.R), atol=1e-4)
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t), atol=1e-4)
    np.testing.assert_array_equal(res_t.inlier.numpy(), np.asarray(res_j.inlier))
    np.testing.assert_allclose(res_t.chi2.numpy(), np.asarray(res_j.chi2), rtol=1e-3, atol=1e-3)
    assert int(res_t.n_inliers) == int(res_j.n_inliers) and not res_t.inlier.numpy()[:4].any()
    assert np.abs(res_t.t.numpy() - sc["t_true"]).max() < 5e-3
    # The right rows move the solution: without them it differs.
    res_l = po_t.optimize_pose(model, _T(pl), torch.eye(3), torch.zeros(3),
                               _obs(po_t, _T, sc, sc["uv_l"], valid))
    assert np.abs(res_l.t.numpy() - res_t.t.numpy()).max() > 1e-5


def test_pose_opt_from_assoc_with_the_rig_matches_reference():
    """The tracker's solve from associations with the rig tuple (uv_r,
    sig2_r, has_r per left feature): as the reference's."""
    model, pl, pr = RIGS["kb8"]
    rng = np.random.default_rng(2)
    sc = _pose_scene(rng, model, pl, pr, n=160)
    n, P = len(sc["Xw"]), 300
    mp_pos = np.zeros((P, 3), np.float32)
    slots = rng.permutation(np.arange(1, P))[:n]
    mp_pos[slots] = sc["Xw"]
    mp_valid = np.zeros(P, bool)
    mp_valid[slots] = True
    assoc = slots.astype(np.int32)
    assoc[rng.uniform(size=n) < 0.1] = -1
    octave = rng.integers(0, 3, n).astype(np.int32)
    s2_table = (1.2 ** (2 * np.arange(8))).astype(np.float32)
    f = dict(uv=sc["uv_l"], response=np.ones(n, np.float32), octave=octave,
             angle=np.zeros(n, np.float32), desc=np.zeros((n, 32), np.uint8),
             valid=np.ones(n, bool))
    sig2_r = s2_table[rng.integers(0, 3, n)]
    R0 = np.asarray(lie_j.exp_so3(jnp.asarray([0.05, -0.03, 0.06], jnp.float32)))
    t0 = (sc["t_true"] + 0.03).astype(np.float32)
    from orbslam3_tpu.ops import features as feat_j

    res_j = trk_j._pose_opt_from_assoc(
        model, jnp.asarray(pl), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(assoc),
        feat_j.Features(**{k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray(mp_pos),
        jnp.asarray(mp_valid), jnp.asarray(s2_table),
        rig=(jnp.asarray(pr), jnp.asarray(sc["R_rl"]), jnp.asarray(sc["t_rl"]),
             jnp.asarray(sc["uv_r"]), jnp.asarray(sig2_r), jnp.asarray(sc["has_r"])))
    res_t = trk_t._pose_opt_from_assoc(
        model, _T(pl), _T(R0), _T(t0), _T(assoc), feat_t.Features(**{k: _T(v) for k, v in f.items()}),
        _T(mp_pos), _T(mp_valid), _T(s2_table),
        rig=(_T(pr), _T(sc["R_rl"]), _T(sc["t_rl"]), _T(sc["uv_r"]), _T(sig2_r),
             _T(sc["has_r"])))
    np.testing.assert_allclose(res_t.R.numpy(), np.asarray(res_j.R), atol=1e-4)
    np.testing.assert_allclose(res_t.t.numpy(), np.asarray(res_j.t), atol=1e-4)
    np.testing.assert_array_equal(res_t.inlier.numpy(), np.asarray(res_j.inlier))


def _ba_scene(rng, model, pl, pr):
    """`test_two_cam.py::test_ba_right_rows`'s problem: 6 cameras (2 fixed)
    on a 1 m line, 300 points at 4-9 m, every third row a right-camera row,
    0.3 px noise, perturbed poses and points."""
    R_rl, t_rl = _extrinsics()
    C, P = 6, 300
    pts = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(4, 9, P)],
                   -1).astype(np.float32)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.linspace(0, 1.0, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), P)
    obs_pt = np.tile(np.arange(P, dtype=np.int32), C)
    Xc = pts[obs_pt] + cam_t[obs_cam]
    proj = lambda p, X: np.asarray(cam_j.project(model, jnp.asarray(p), jnp.asarray(X)))
    is_r = (np.arange(len(obs_cam)) % 3) == 0
    uv = np.where(is_r[:, None], proj(pr, Xc @ R_rl.T + t_rl), proj(pl, Xc))
    uv = uv + rng.normal(0, 0.3, uv.shape)
    O = len(obs_cam)
    arrays = dict(
        cam_R=cam_R, cam_t=(cam_t + rng.normal(0, 0.02, cam_t.shape)).astype(np.float32),
        cam_fixed=np.arange(C) < 2,
        points=(pts + rng.normal(0, 0.03, pts.shape)).astype(np.float32),
        point_valid=np.ones(P, bool), obs_cam=obs_cam, obs_point=obs_pt,
        obs_uv=uv.astype(np.float32), obs_ur=np.full(O, -1.0, np.float32),
        obs_sigma2=np.ones(O, np.float32), obs_valid=np.ones(O, bool), obs_right=is_r)
    return arrays, (R_rl, t_rl), cam_t


@pytest.mark.parametrize("iters", [2, 8])
@pytest.mark.parametrize("rig", sorted(RIGS))
def test_ba_with_right_rows_matches_reference(rig, iters):
    model, pl, pr = RIGS[rig]
    arrays, (R_rl, t_rl), cam_t = _ba_scene(np.random.default_rng(3), model, pl, pr)
    res_j = ba_j.solve_ba(model, jnp.asarray(pl),
                          ba_j.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                          iters=iters, dense_schur=True,
                          cam2=(jnp.asarray(pr), jnp.asarray(R_rl), jnp.asarray(t_rl)))
    res_t = ba_t.solve_ba(model, _T(pl), ba_t.BAProblem(**{k: _T(v) for k, v in arrays.items()}),
                          iters=iters, dense_schur=True, cam2=(_T(pr), _T(R_rl), _T(t_rl)))
    for k in ("cam_R", "cam_t") + (("points",) if iters == 2 else ()):
        np.testing.assert_allclose(getattr(res_t, k).numpy(), np.asarray(getattr(res_j, k)),
                                   atol=1e-4, rtol=0, err_msg=k)
    assert abs(float(res_t.cost) / float(res_j.cost) - 1) < 1e-5
    pj = np.asarray(res_j.points)  # 1e-4 of each point's distance (module docstring)
    d = np.abs(res_t.points.numpy() - pj).max(axis=1)
    assert (d <= 1e-4 * np.linalg.norm(pj, axis=1)).all(), d.max()
    np.testing.assert_array_equal(res_t.obs_inlier.numpy(), np.asarray(res_j.obs_inlier))
    assert res_t.obs_inlier.numpy().all()  # every row consistent, the right rows too
    assert np.abs(res_t.cam_t.numpy() - cam_t).max() < 0.1
    # Without the rig's extrinsics the right rows are read as left ones.
    res_l = ba_t.solve_ba(model, _T(pl), ba_t.BAProblem(**{k: _T(v) for k, v in arrays.items()}),
                          iters=8, dense_schur=True)
    assert np.abs(res_l.points.numpy() - res_t.points.numpy()).max() > 1e-3


def test_camera_sum_forms_agree():
    """`ba.CameraSums` on the CPU: `index_add_` in row order (the
    reference's `segment_sum`), also with the rows in another order, and the
    camera-major reduction with `obs_per_cam`, within float32 rounding of
    it. (Its CUDA form, the one-hot product, is held against this on the
    card in `tests/test_torch_cuda.py`.)"""
    rng = np.random.default_rng(4)
    C, per = 7, 40
    vals = torch.from_numpy(rng.normal(size=(C * per, 6, 6)).astype(np.float32))
    oc = torch.arange(C).repeat_interleave(per)
    ref = torch.zeros(C, 6, 6).index_add_(0, oc, vals)
    sums = ba_t.CameraSums(oc, C)
    assert sums.onehot is None
    assert torch.equal(sums(vals), ref)
    np.testing.assert_allclose(ba_t.CameraSums(oc, C, per)(vals).numpy(), ref.numpy(), atol=1e-5)
    perm = torch.from_numpy(rng.permutation(C * per))
    np.testing.assert_allclose(ba_t.CameraSums(oc[perm], C)(vals[perm]).numpy(), ref.numpy(),
                               atol=1e-5)
