"""Port parity: the monocular-inertial `System` end to end, against the JAX
package on the CPU, on the scene of `scripts/drive_slam_vi.py`
(`tests/vi_scene.py`: 320x240, 400 features on 3 levels, 10 Hz camera,
200 Hz IMU, Kmax 64, Pmax 8192), from 2.9 s of its path on, through the
IMU initialization (10 keyframes at the 4 Hz pre-initialization cadence
and 2 s), the init-time full VI-BA and a few frames tracked with the
pose-inertial solve and mapped with the local inertial BA.

Both systems see the same features: the port's tracker is handed, call by
call, the features the reference extracted (ROADMAP C1), and both keep
map-point slot 0 empty and keypoint 0 invalid (C6), as in
`tests/test_torch_stereo_system.py`. The reference runs with fault C13
repaired the way the port repairs it (`tests/jax_vi_replay.py --c13`):
without it, the keyframe frame that initializes the IMU keeps its pose
from before the gravity and scale alignment.

Gates. The two-view initialization's RANSAC samplers draw differently in
the two packages (`tests/test_torch_system.py`), so the initial maps differ
by about 1e-3 of their scale and the runs drift apart slowly, as the
monocular runs there do: the same TrackState on every frame, keyframe
counts within 1, the IMU initialized at the same frame and the same
keyframe count, its scale within 2% and its gravity direction within
1e-2, at least one local inertial BA in both after it, and every frame's
camera centre within 0.02 m of the reference's (the monocular file's RMS
gate between trajectories).

Also here: fault C13 on the tracker alone, the >1 s gap anomalies, the
card-or-raise rule for IMU_MONOCULAR, and the inertial loop closer
(`fix_scale` Sim3 steps, 4-DoF essential graph) on `tests/loop_scene.py`'s
drift map against the JAX one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vi_scene as scene
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu.pipeline import local_mapping as lm_j
from orbslam3_tpu.pipeline import tracking as trk_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import convert, spans
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import imu as imu_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.pipeline import frame as fr_t
from orbslam3_tpu_torch.pipeline import local_mapping as lm_t
from orbslam3_tpu_torch.pipeline.tracking import TrackState
from orbslam3_tpu_torch.system import Sensor, System

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = dict(n_features=400, n_levels=3)
T0 = 2.9  # from 2.9 s on: the reference loses the earlier maps (the watchdog, a loss)
N_FRAMES = 31


def _np_tuple(x):
    return type(x)(*(np.array(v) for v in x))


def _repair_c13(mp):
    """C13 repaired in the JAX Tracker for this run (`tests/jax_vi_replay.py`)."""
    apply, create = trk_j.Tracker.apply_map_transform, trk_j.Tracker._create_keyframe_impl

    def apply_map_transform(self, Rwg, s):
        apply(self, Rwg, s)
        self._map_transformed = True

    def create_keyframe_impl(self, cur):
        self._map_transformed = False
        create(self, cur)
        if self._map_transformed:
            cur.R = np.asarray(self.store.state.kf_R[self.last_kf_id])
            cur.t = np.asarray(self.store.state.kf_t[self.last_kf_id])

    mp.setattr(trk_j.Tracker, "apply_map_transform", apply_map_transform)
    mp.setattr(trk_j.Tracker, "_create_keyframe_impl", create_keyframe_impl)


def _watch(slam, lm_mod, record):
    """Record the map transforms handed to the tracker and count the local
    inertial BAs (not those inside a full VI-BA)."""
    tr, mapper = slam.tracker, slam.mapper
    apply, liba, full = tr.apply_map_transform, mapper._local_inertial_ba, mapper._full_inertial_ba
    depth = [0]

    def apply_map_transform(Rwg, s):
        record.setdefault("transforms", []).append((np.array(Rwg), float(s)))
        apply(Rwg, s)

    def local_inertial_ba(kf_id, **kw):
        if depth[0] == 0:
            record["liba"] = record.get("liba", 0) + 1
        return liba(kf_id, **kw)

    def full_inertial_ba(kf_id, **kw):
        depth[0] += 1
        try:
            return full(kf_id, **kw)
        finally:
            depth[0] -= 1

    tr.apply_map_transform = apply_map_transform
    mapper._local_inertial_ba, mapper._full_inertial_ba = local_inertial_ba, full_inertial_ba


def _run(slam, ts, imgs, batches, record):
    states, n_kf, centres, init = [], [], [], None
    for k in range(len(ts)):
        slam.track_monocular(imgs[k], float(ts[k]), imu_measurements=batches[k])
        states.append(slam.tracking_state.name)
        n_kf.append(slam.store.n_kf)
        f = slam.tracker.last_frame
        R, t = np.asarray(f.R, np.float64), np.asarray(f.t, np.float64)
        centres.append(-R.T @ t)
        if init is None and slam.mapper.imu_initialized:
            init = (k, slam.store.n_kf)
    return dict(states=states, n_kf=n_kf, centres=np.stack(centres), init=init, **record)


def _reference_run():
    ts, imgs, _, batches = scene.frames(N_FRAMES, T0)
    calib = imu_j.ImuCalib.create(np.eye(3), np.zeros(3), **scene.NOISE)
    with pytest.MonkeyPatch.context() as mp:
        _repair_c13(mp)
        slam = System_j(Sensor_j.IMU_MONOCULAR, cam_j.CameraModel.PINHOLE, scene.PARAMS,
                        (scene.W, scene.H), orb_params=feat_j.OrbParams(**ORB),
                        imu_calib=calib, Kmax=64, Pmax=8192)
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
        _watch(slam, lm_j, record)
        out = _run(slam, ts, imgs, batches, record)
    return dict(out, feats=feats, frames=(ts, imgs, batches))


def _port_run(ref):
    slam = _port_system()
    slam.store.alloc_mps(1)
    feats = iter(ref["feats"])
    slam.tracker._extract = lambda img: convert.to_torch(next(feats), "cpu", feat_t.Features)
    record = {}
    _watch(slam, lm_t, record)
    rec = spans.Recorder(cuda=False)
    with rec:
        out = _run(slam, *ref["frames"], record)
    assert next(feats, None) is None  # as many extractions as the reference
    return dict(out, slam=slam, spans=rec.result())


@pytest.fixture(scope="module")
def ref():
    return _reference_run()


@pytest.fixture(scope="module")
def port(ref):
    return _port_run(ref)


def _port_system(device="cpu", calib=True):
    c = imu_t.ImuCalib.create(np.eye(3), np.zeros(3), **scene.NOISE, device="cpu") if calib else None
    return System(Sensor.IMU_MONOCULAR, CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(**ORB), device=device, Kmax=64, Pmax=8192,
                  imu_calib=c)


def test_vi_system_matches_reference(ref, port):
    assert port["states"] == ref["states"]
    assert all(abs(a - b) <= 1 for a, b in zip(port["n_kf"], ref["n_kf"]))
    assert ref["init"] is not None and port["init"] == ref["init"]
    assert all(s == "OK" for s in ref["states"][ref["states"].index("OK"):])
    assert ref["init"][0] <= N_FRAMES - 4  # pose-inertial frames follow
    (Rwg_j, s_j), = ref["transforms"]
    (Rwg_t, s_t), = port["transforms"]
    assert abs(s_t / s_j - 1) < 0.02, (s_t, s_j)
    g = np.array([0.0, 0.0, -1.0])
    np.testing.assert_allclose(Rwg_t @ g, Rwg_j @ g, atol=1e-2)
    assert port.get("liba", 0) >= 1 and ref.get("liba", 0) >= 1
    np.testing.assert_allclose(port["centres"], ref["centres"], atol=0.02)
    tr = port["slam"].tracker
    assert tr.imu_ready and tr.frame_prior is not None  # the last frame took the solve


def test_vi_system_spans_the_inertial_calls(port):
    """The spans at the inertial call sites (`orbslam3_tpu_torch.spans`), as
    `entry.replay` reads them: a preintegration on every frame after the
    first, a span for each keyframe's local inertial BA (none for the full
    VI-BA's inner one), the IMU initialization and its full VI-BA, and the
    pose-inertial solves after it; host times only on the CPU."""
    sp = port["spans"]
    assert len(sp["preintegration"]) == len(port["states"]) - 1
    assert len(sp["local inertial BA"]) == port["liba"]
    assert len(sp["full VI-BA"]) >= 1 and len(sp["try_initialize"]) >= 1
    assert len(sp.get("pose-inertial (last frame)", [])) + len(
        sp.get("pose-inertial (last keyframe)", [])) >= 1
    assert all(host >= 0.0 and dev is None for v in sp.values() for _, host, dev in v)
    rec = spans.Recorder(cuda=False)
    with rec:
        pass
    with spans.span("outside"):  # after the recorder's block: nothing kept
        pass
    assert rec.result() == {}


def test_keyframe_frame_takes_the_aligned_pose_c13():
    """Fault C13: the keyframe frame whose mapping pass initialized the IMU
    (a gravity and scale alignment of the map) takes its keyframe's pose
    after the pass, so the next frame is predicted in the aligned frame. A
    pass that moves nothing leaves the tracked pose."""
    ts, imgs, _, batches = scene.frames(5, T0)
    slam = _port_system()
    for k in range(5):  # two-view initialization on the 4th frame
        slam.track_monocular(imgs[k], float(ts[k]), imu_measurements=batches[k])
    tr = slam.tracker
    assert tr.state == TrackState.OK
    Rwg = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)

    def aligning_pass(slot, initial=False, preint=None):
        s = slam.store.state
        slam.store.state = s._replace(kf_R=s.kf_R @ torch.from_numpy(Rwg), kf_t=s.kf_t * 3.0)
        tr.apply_map_transform(Rwg, 3.0)

    for aligns in (False, True):
        slam.mapper.process_keyframe = (aligning_pass if aligns else
                                        lambda slot, initial=False, preint=None: None)
        last = tr.last_frame
        cur = fr_t.FrameData(features=last.features, timestamp=last.timestamp + 0.01,
                             frame_id=tr.frame_id, R=last.R.copy(), t=last.t.copy(),
                             mp_assoc=last.mp_assoc.copy())
        tracked = (cur.R.copy(), cur.t.copy())
        tr._create_keyframe(cur)
        slot = tr.last_kf_id
        if aligns:
            np.testing.assert_array_equal(cur.R, slam.store.state.kf_R[slot].numpy())
            np.testing.assert_array_equal(cur.t, slam.store.state.kf_t[slot].numpy())
            np.testing.assert_allclose(cur.t, 3.0 * tracked[1], atol=1e-6)
        else:
            np.testing.assert_array_equal(cur.t, tracked[1])
        tr.last_frame = cur


@pytest.mark.parametrize("imu_ready", [False, True])
def test_gap_over_one_second_resets_the_map(imu_ready):
    """An inertial frame more than 1 s after the last one reports
    "gap_init" (IMU initialized) or "gap_uninit"; the System (no multi-map
    atlas) resets the active map either way, as the reference's does without
    one. A visual tracker reports no gap."""
    ts, imgs, _, batches = scene.frames(5, T0)
    slam = _port_system()
    for k in range(4):  # two-view initialization on the 4th frame
        slam.track_monocular(imgs[k], float(ts[k]), imu_measurements=batches[k])
    assert slam.n_keyframes == 2
    seen = []
    reset = slam._on_timestamp_anomaly
    slam.tracker.anomaly_cb = lambda kind: (seen.append(kind), reset(kind))
    slam.tracker.imu_ready = imu_ready
    slam.track_monocular(imgs[4], float(ts[3]) + 1.5)
    assert seen == ["gap_init" if imu_ready else "gap_uninit"]
    assert slam.n_keyframes == 0 and not slam.tracker.imu_ready
    assert not slam.mapper.preints and not slam.mapper.imu_initialized
    mono = System(Sensor.MONOCULAR, CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(**ORB), device="cpu", Kmax=64, Pmax=8192)
    kinds = []
    mono.tracker.anomaly_cb = kinds.append
    mono.track_monocular(imgs[0], 0.0)
    mono.track_monocular(imgs[1], 2.0)
    assert kinds == []
    with pytest.raises(ValueError):
        mono.track_monocular(imgs[2], 2.1, imu_measurements=batches[2])


def test_imu_monocular_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """`System(IMU_MONOCULAR, imu_calib=...)` without a device takes the
    first CUDA card and raises where there is none; it needs a calibration,
    and so does IMU_STEREO, which takes the card as well; asked for the CPU,
    IMU_STEREO is built there with a stereo (fixed-scale) IMU initializer
    (its parity: `tests/test_torch_stereo_vi_system.py`)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_system(device=None)
    with pytest.raises(ValueError, match="imu_calib"):
        _port_system(calib=False)
    c = imu_t.ImuCalib.create(np.eye(3), np.zeros(3), **scene.NOISE, device="cpu")
    with pytest.raises(ValueError, match="imu_calib"):
        System(Sensor.IMU_STEREO, CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
               device="cpu", bf=30.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(Sensor.IMU_STEREO, CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
               bf=30.0, imu_calib=c)
    stereo = System(Sensor.IMU_STEREO, CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
                    device="cpu", bf=30.0, imu_calib=c)
    assert not stereo.mapper.imu_init.mono and stereo.tracker.is_stereo_like
    slam = _port_system()
    assert slam.mapper.imu_init is not None and slam.tracker.imu_calib is not None
    assert slam.mapper.imu_init.mono
    assert slam.tracker.imu_calib.cov.device.type == "cpu"


def test_inertial_loop_closer_matches_reference(monkeypatch):
    """`LoopCloser(inertial=True)` on the drift map of `tests/loop_scene.py`
    (8% scale, 0.06 rad, 0.19 m of drift along a 24-keyframe circle): the
    verification with the scale fixed accepts the same pair with s = 1 in
    both packages; from its Sim3, the 4-DoF essential graph, the point
    correction and SearchAndFuse give poses and points within 1e-4 and equal
    keyframe rows. The JAX side runs its graph with fault C22 repaired as
    the port's is (`test_torch_inertial_loop.repair_c22`: turned about the
    world's z axis; unrepaired, the graph turned no keyframe of this
    circle, whose cameras look sideways)."""
    import loop_scene as LS
    from test_torch_inertial_loop import repair_c22
    from test_torch_loop import _state_np, closers, jax_store, port_store

    repair_c22(monkeypatch)

    arrays, info = LS.make_loop_map()
    cur, loop = info["cur_kf"], info["loop_kf"]
    store_j = jax_store(arrays, info)
    store_t = port_store(store_j)
    lj, lt = closers(store_j, store_t, LS.PARAMS, LS.W, LS.H, 256, consecutive=1,
                     run_gba=False, inertial=True)
    S_j = lj._verify_sim3_impl(cur, loop)
    S_t = lt._verify_sim3_impl(cur, loop)
    assert S_j is not None and S_t is not None
    assert float(S_j[2]) == 1.0 and float(S_t[2]) == 1.0
    np.testing.assert_allclose(np.asarray(S_t[1]), np.asarray(S_j[1]), atol=0.02)
    lj._correct_loop(cur, loop, *S_j)
    lt._correct_loop(cur, loop, *S_j)
    a, b = _state_np(store_j), _state_np(store_t)
    for k in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(b["mp_valid"], a["mp_valid"])
    np.testing.assert_array_equal(b["kf_mp"], a["kf_mp"])
    K = info["n_kf"]
    assert np.abs(b["kf_t"][:K] - arrays["kf_t"][:K]).max() > 1e-3  # the graph moved them
    assert np.abs(b["kf_R"][:K] - arrays["kf_R"][:K]).max() > 1e-2  # and turned them (C22)
