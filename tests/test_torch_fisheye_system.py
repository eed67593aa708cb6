"""Port parity: the monocular `System` with a Kannala-Brandt 8 camera
(`System(MONOCULAR, KB8)`) against the JAX package on the CPU, over 10
frames of the left camera of `tests/stereo_vi_scene.py` (config 4's room and
path through a 256x256 fisheye, 400 features on 3 levels, 10 Hz, Kmax 32,
Pmax 4096): the two-view initialization on unprojected rays, tracking
through the KB8 projection and its Jacobian, keyframes and the mapping pass
(triangulation on the model's rays, fuse, local BA).

Both systems see the same features (the reference's, ROADMAP C1) and keep
map-point slot 0 empty and keypoint 0 invalid (C6). The two packages'
two-view RANSAC samplers draw differently, so the gates are those of
`tests/test_torch_system.py`: initialization within one frame of the
reference's, the same TrackState on every frame after both initialized,
keyframe counts within 1, both Sim3 ATEs against the rendered centres under
0.05 m, and the two Sim3-aligned trajectories within 0.02 m RMS of each
other. Also: `entry.replay` of the two stereo-inertial sensors on the
CPU.
"""

import numpy as np
import pytest
import torch

import stereo_vi_scene as scene
from orbslam3_tpu.eval import ate as ate_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.system import Sensor, System
from test_torch_vi_system import _np_tuple

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = dict(n_features=400, n_levels=3)
N_FRAMES = 10


def _run(slam, ts, imgs):
    states, n_kf = [], []
    for k in range(len(ts)):
        slam.track_monocular(imgs[k], float(ts[k]))
        states.append(slam.tracking_state.name)
        n_kf.append(slam.store.n_kf)
    ts_, pos = slam.get_trajectory()
    return dict(states=states, n_kf=n_kf, ts=ts_, pos=pos,
                n_mp=int(np.asarray(slam.store.state.mp_valid).sum()))


def _aligned(ts, pos, gt_ts, gt):
    ia, ib = ate_j.associate(ts, gt_ts, 0.01)
    s, R, t = ate_j.umeyama(pos[ia], gt[ib], True)
    return {round(float(ts[i]), 6): s * R @ pos[i] + t for i in ia}


def test_mono_kb8_system_matches_reference():
    ts, left, _, gt, _ = scene.frames(N_FRAMES)
    pl, _ = scene.fisheye_rig()
    slam_j = System_j(Sensor_j.MONOCULAR, cam_j.CameraModel.KB8, pl, scene.FE_WH,
                      orb_params=feat_j.OrbParams(**ORB), Kmax=32, Pmax=4096)
    slam_j.store.alloc_mps(1)
    feats, extract = [], slam_j.tracker._extract

    def _extract(img):
        f = extract(img)
        f = f._replace(valid=f.valid.at[0].set(False))
        feats.append(_np_tuple(f))
        return f

    slam_j.tracker._extract = _extract
    ref = _run(slam_j, ts, left)
    slam_t = System(Sensor.MONOCULAR, CameraModel.KB8, pl, scene.FE_WH,
                    orb_params=feat_t.OrbParams(**ORB), device="cpu", Kmax=32, Pmax=4096)
    slam_t.store.alloc_mps(1)
    it = iter(feats)
    slam_t.tracker._extract = lambda img: convert.to_torch(next(it), "cpu", feat_t.Features)
    got = _run(slam_t, ts, left)
    assert next(it, None) is None

    init_p, init_r = got["states"].index("OK"), ref["states"].index("OK")
    assert abs(init_p - init_r) <= 1, (got["states"], ref["states"])
    start = max(init_p, init_r)
    assert got["states"][start:] == ref["states"][start:] == ["OK"] * (N_FRAMES - start)
    assert all(abs(a - b) <= 1 for a, b in zip(got["n_kf"], ref["n_kf"]))
    assert got["n_kf"][-1] >= 3 and got["n_mp"] > 100
    assert np.isfinite(got["pos"]).all()
    for run in (got, ref):
        assert ate_j.ate_rmse(run["ts"], run["pos"], ts, gt, with_scale=True, max_dt=0.01) < 0.05
    a_p = _aligned(got["ts"], got["pos"], ts, gt)
    a_r = _aligned(ref["ts"], ref["pos"], ts, gt)
    common = sorted(set(a_p) & set(a_r))
    assert len(common) >= N_FRAMES - 2
    rms = np.sqrt(np.mean([np.sum((a_p[t] - a_r[t]) ** 2) for t in common]))
    assert rms < 0.02, rms


@pytest.mark.parametrize("sensor", ["stereo_vi", "stereo_vi_fisheye"])
def test_stereo_inertial_replay_on_the_cpu(sensor):
    """`entry.replay` of the stereo-inertial sensors at full width, 2 frames:
    initialized on frame 0 from one frame, the first step metric (within
    1 cm of the rendered one), the IMU's spans recorded, and for config 4
    the fisheye match's and the rig's pose solves'."""
    from orbslam3_tpu_torch import entry as E

    rep = E.replay("cpu", sensor, 2)
    assert rep.states == ["OK", "OK"] and rep.n_kf == 1 and rep.n_mp > 300
    assert rep.syncs == [None, None] and rep.pi_taken == [False, False]
    step, true = (np.linalg.norm(np.diff(x, axis=0)) for x in (rep.pos, rep.gt_pos))
    assert abs(step - true) < 0.01, (step, true)
    assert len(rep.inertial_ms["preintegration"]) == 1
    rig = sensor == "stereo_vi_fisheye"
    assert ("fisheye match" in rep.inertial_ms) == rig
    assert ("pose solve with right rows" in rep.inertial_ms) == rig
    assert rep.system.tracker.img_wh_t.tolist() == ([512.0, 512.0] if rig else [752.0, 480.0])
