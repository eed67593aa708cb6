"""Port parity: the stereo-inertial `System` end to end — config 4's
two-camera Kannala-Brandt 8 rig (`IMU_STEREO`, `KB8`, `camera2`) — against
the JAX package on the CPU, on `tests/stereo_vi_scene.py` (config 4's room
and path, a 256x256 fisheye pair 0.15 m apart, 400 features on 3 levels,
10 Hz camera, 200 Hz ideal IMU, Kmax 64, Pmax 8192): a single-frame
initialization from the rig's match, tracking with the right-camera rows,
the 4 Hz keyframes, the IMU initialization with the scale held fixed
(`ImuInitializer(mono=False)`), the init-time full VI-BA, and frames
tracked with the pose-inertial solve after it.

Both systems see the same features: the port's tracker is handed, call by
call (left, then right), the features the reference extracted (ROADMAP
C1); both keep map-point slot 0 empty and keypoint 0 invalid (C6). The
reference runs with faults C13 (`tests/jax_vi_replay.py --c13`) and C14
(`_repair_c14`) repaired as the port repairs them.

`tests/test_torch_stereo_vi_pinhole.py` runs the same with the rectified
pinhole pair (`Sensor.IMU_STEREO` with a `bf`).

Gates, those of `tests/test_torch_vi_system.py`: the same TrackState on
every frame, keyframe counts within 1, the IMU initialized at the same
frame and keyframe count, its scale within 2% (both hold it at 1: the map
is metric from the first frame), its gravity direction within 1e-2, and
every frame's camera centre within 0.02 m of the reference's. Also here:
the stereo `ImuInitializer` (fixed scale) on the stores of
`tests/test_torch_inertial_support.py` against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereo_vi_scene as scene
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu.optim import pose_only as po_j
from orbslam3_tpu.pipeline import inertial_support as is_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import imu as imu_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.pipeline import inertial_support as is_t
from orbslam3_tpu_torch.system import Sensor, System
from test_torch_inertial_support import _calibs, _chain_stores
from test_torch_vi_system import _np_tuple, _repair_c13, _watch

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = dict(n_features=400, n_levels=3)
N_FRAMES = 33  # the IMU initializes at frame 27 (10 keyframes, 2.7 s)


def _run(slam, ts, left, right, batches, record):
    states, n_kf, centres, init = [], [], [], None
    for k in range(len(ts)):
        slam.track_stereo(left[k], right[k], float(ts[k]), imu_measurements=batches[k])
        states.append(slam.tracking_state.name)
        n_kf.append(slam.store.n_kf)
        f = slam.tracker.last_frame
        R, t = np.asarray(f.R, np.float64), np.asarray(f.t, np.float64)
        centres.append(-R.T @ t)
        if init is None and slam.mapper.imu_initialized:
            init = (k, slam.store.n_kf)
    return dict(states=states, n_kf=n_kf, centres=np.stack(centres), init=init, **record)


def _repair_c14(mp):
    """C14 repaired in the JAX pose solve for this run (the port's repair):
    the rows outside the active set get a zero Jacobian, not only a zero
    weight. Here slot 0 is held empty, so an unassociated row carries the
    world origin, where the Kannala-Brandt 8 Jacobian is NaN while the
    camera sits at the first keyframe: unrepaired, the reference's pose
    solve returns NaN on the second frame and tracking is lost."""
    res, res_r = po_j._residuals, po_j._residuals_right

    def residuals(*a):
        e, J, ok, is_stereo = res(*a)
        return e, jnp.where(ok[:, None, None], J, 0.0), ok, is_stereo

    def residuals_right(*a):
        e, J, ok = res_r(*a)
        return e, jnp.where(ok[:, None, None], J, 0.0), ok

    mp.setattr(po_j, "_residuals", residuals)
    mp.setattr(po_j, "_residuals_right", residuals_right)


def reference_run(fisheye: bool = True):
    """The JAX System(IMU_STEREO) over the scene (the KB8 rig, or the
    rectified pinhole pair): per frame its state, keyframe count and camera
    centre, the IMU initialization's frame, the map transforms, and the
    features of every extraction in order."""
    ts, left, right, _, batches = scene.frames(N_FRAMES, fisheye=fisheye)
    calib = imu_j.ImuCalib.create(np.eye(3), np.zeros(3), **scene.NOISE)
    with pytest.MonkeyPatch.context() as mp:
        _repair_c13(mp)
        _repair_c14(mp)
        if fisheye:
            pl, c2 = scene.fisheye_rig()
            slam = System_j(Sensor_j.IMU_STEREO, cam_j.CameraModel.KB8, pl, scene.FE_WH,
                            orb_params=feat_j.OrbParams(**ORB), imu_calib=calib, camera2=c2,
                            Kmax=64, Pmax=8192, fps=scene.CAM_HZ)
        else:
            slam = System_j(Sensor_j.IMU_STEREO, cam_j.CameraModel.PINHOLE, scene.PIN_PARAMS,
                            scene.PIN_WH, orb_params=feat_j.OrbParams(**ORB), bf=scene.PIN_BF,
                            imu_calib=calib, Kmax=64, Pmax=8192, fps=scene.CAM_HZ)
        slam.store.alloc_mps(1)
        feats = []
        extract = slam.tracker._extract

        def _extract(img):
            f = extract(img)
            f = f._replace(valid=f.valid.at[0].set(False))
            feats.append(_np_tuple(f))
            return f

        slam.tracker._extract = _extract
        record = {}
        _watch(slam, None, record)
        out = _run(slam, ts, left, right, batches, record)
    return dict(out, feats=feats, frames=(ts, left, right, batches))


def port_run(ref, fisheye: bool = True):
    """The port's System(IMU_STEREO) on the reference's features."""
    calib = imu_t.ImuCalib.create(np.eye(3), np.zeros(3), **scene.NOISE, device="cpu")
    if fisheye:
        pl, c2 = scene.fisheye_rig()
        slam = System(Sensor.IMU_STEREO, CameraModel.KB8, pl, scene.FE_WH,
                      orb_params=feat_t.OrbParams(**ORB), device="cpu", camera2=c2,
                      imu_calib=calib, Kmax=64, Pmax=8192, fps=scene.CAM_HZ)
    else:
        slam = System(Sensor.IMU_STEREO, CameraModel.PINHOLE, scene.PIN_PARAMS, scene.PIN_WH,
                      orb_params=feat_t.OrbParams(**ORB), device="cpu", bf=scene.PIN_BF,
                      imu_calib=calib, Kmax=64, Pmax=8192, fps=scene.CAM_HZ)
    slam.store.alloc_mps(1)
    feats = iter(ref["feats"])
    slam.tracker._extract = lambda img: convert.to_torch(next(feats), "cpu", feat_t.Features)
    record = {}
    _watch(slam, None, record)
    out = _run(slam, *ref["frames"], record)
    assert next(feats, None) is None  # as many extractions as the reference
    return dict(out, slam=slam)


def assert_runs_agree(ref, port):
    """The module docstring's gates."""
    assert port["states"] == ref["states"] == ["OK"] * N_FRAMES  # single-frame init
    assert all(abs(a - b) <= 1 for a, b in zip(port["n_kf"], ref["n_kf"]))
    assert ref["init"] is not None and port["init"] == ref["init"]
    assert ref["init"][0] <= N_FRAMES - 4  # pose-inertial frames follow
    (Rwg_j, s_j), = ref["transforms"]
    (Rwg_t, s_t), = port["transforms"]
    assert s_j == 1.0 and abs(s_t / s_j - 1) < 0.02, (s_t, s_j)  # the scale stays fixed
    g = np.array([0.0, 0.0, -1.0])
    np.testing.assert_allclose(Rwg_t @ g, Rwg_j @ g, atol=1e-2)
    np.testing.assert_allclose(port["centres"], ref["centres"], atol=0.02)
    slam = port["slam"]
    tr = slam.tracker
    assert tr.imu_ready and tr.frame_prior is not None  # the last frame took the solve
    assert not slam.mapper.imu_init.mono and slam.mapper.stereo_like


@pytest.fixture(scope="module")
def ref():
    return reference_run()


@pytest.fixture(scope="module")
def port(ref):
    return port_run(ref)


def test_stereo_vi_rig_system_matches_reference(ref, port):
    assert_runs_agree(ref, port)
    last = port["slam"].tracker.last_frame
    assert last.has_r.sum() > 50 and (last.depth > 0).sum() == int(last.has_r.sum())
    assert (last.ur == -1).all()  # the rig's frame has no rectified row


def test_stereo_imu_initializer_keeps_the_scale():
    """`ImuInitializer(mono=False)` (stereo and RGB-D: the inertial-only MAP
    with the scale fixed) on the same stores as the reference's: the same
    verdict, a scale of 1, the applied Rwg within 1e-3, keyframe poses and
    velocities within 1e-3 and biases within 1e-4."""
    store_j, store_t, pre_j, pre_t, Rbc, tbc = _chain_stores(3)
    cj, ct = _calibs(Rbc, tbc)
    ij, it = is_j.ImuInitializer(cj, mono=False), is_t.ImuInitializer(ct, mono=False)
    assert ij.try_initialize(store_j, pre_j, Rbc, tbc) and it.try_initialize(store_t, pre_t,
                                                                              Rbc, tbc)
    (Rj, sj), (Rt, st) = ij.applied_transform, it.applied_transform
    assert sj == st == 1.0
    np.testing.assert_allclose(Rt, Rj, atol=1e-3)
    a, b = store_j.state, store_t.state
    for name, tol in (("kf_R", 1e-3), ("kf_t", 1e-3), ("kf_vel", 1e-3), ("kf_bias_g", 1e-4),
                      ("kf_bias_a", 1e-4)):
        np.testing.assert_allclose(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                   atol=tol, err_msg=name)
