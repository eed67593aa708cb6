"""Port parity: asynchronous mapping (`pipeline/async_mapping.py`), the
keyframe policy under a busy mapper, and the System's wiring of both, against
the JAX package on the CPU.

* the executor protocol of `tests/test_async_mapping.py`, run against both
  `AsyncMapper` classes: the same call log;
* an asynchronous monocular `System` of each package on the 16-frame scene of
  `tests/test_e2e_mono.py` (world seed 7, 400 features on 3 levels, Kmax 32,
  Pmax 4096): initialization within one frame, the same TrackState on every
  frame after both initialized, keyframe counts within 1 on every frame, the
  same number of completed passes, both Sim3 ATEs under 0.05 m and the
  aligned trajectories within 0.02 m RMS of each other. Point slot 0 stays
  empty and keypoint 0 invalid in both (fault C6, `test_torch_system.py`);
* a busy mapper: both trackers interrupt it, queue a stereo keyframe while
  fewer than 3 wait, and refuse a monocular one;
* `_attach_store` aborts the mapper and `_do_merge` flushes it first;
* fault C17: a tick whose pass closes a loop moves the last frame with its
  reference keyframe.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.pipeline.async_mapping import AsyncMapper as AsyncMapper_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import ate as ate_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.pipeline.async_mapping import AsyncMapper
from orbslam3_tpu_torch.pipeline.tracking import TrackState
from orbslam3_tpu_torch.system import Sensor, System
import test_e2e_mono as scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

N_FRAMES = 16
WORLD_SEED = 7  # tests/test_async_mapping.py's world
ORB = dict(n_features=400, n_levels=3)


def _protocol(cls):
    """`tests/test_async_mapping.py::test_executor_protocol` as a script:
    the calls the fake mapper saw and the passes handed downstream."""
    calls, done = [], []

    class FakeMapper:
        interrupt_ba = False

        def __init__(self):
            self.preints = {}

        def s0(self, k):
            calls.append(("s0", k, self.interrupt_ba))

        def s1(self, k):
            calls.append(("s1", k, self.interrupt_ba))

        STAGES = (s0, s1)

        def process_keyframe(self, k, initial=False, preint=None):
            calls.append(("init", k))

    m = FakeMapper()
    ex = cls(m, downstream=[lambda k: done.append(k)])
    log = [("idle", ex.idle())]
    ex.submit(3, preint="p3")
    log.append(("preint", m.preints.get(3)))
    ex.submit(4)
    log.append(("queue", ex.queue_len(), ex.idle()))
    ex.tick()
    ex.interrupt()
    ex.tick()
    log.append(("after interrupt", list(done), m.interrupt_ba))
    ex.tick()
    ex.flush()
    log.append(("flushed", list(done), ex.idle()))
    ex.submit(5)
    ex.submit(9, initial=True)
    log.append(("initial", list(done)))
    ex.submit(6)
    ex.tick()
    ex.abort()
    log.append(("aborted", ex.idle(), list(done), ex.n_completed, ex.n_interrupted))
    return calls, log


def test_executor_protocol_same_call_log():
    calls_j, log_j = _protocol(AsyncMapper_j)
    calls_t, log_t = _protocol(AsyncMapper)
    assert calls_t == calls_j and log_t == log_j
    assert calls_t[:3] == [("s0", 3, False), ("s1", 3, True), ("s0", 4, False)]
    assert log_t[-1] == ("aborted", True, [3, 4, 5, 9], 3, 1)  # the initial pass is not counted


def _frames():
    params = cam_j.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2)
    pts, shades = scene.make_world(np.random.default_rng(WORLD_SEED))
    poses = scene.camera_path(N_FRAMES)
    imgs = [scene.render(params, R, t, pts, shades) for R, t in poses]
    gt = np.stack([-R.T @ t for R, t in poses])
    return np.asarray(params), imgs, gt


def _drop_kp0(tracker, invalidate):
    extract = tracker._extract
    tracker._extract = lambda img: invalidate(extract(img))


def _drive(slam, imgs):
    states, n_kf = [], []
    for k, img in enumerate(imgs):
        slam.track_monocular(img, k * 0.1)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
    slam.shutdown()
    ts, pos = slam.get_trajectory()
    return dict(states=states, n_kf=n_kf, ts=ts, pos=pos,
                n_completed=slam.async_mapper.n_completed, idle=slam.async_mapper.idle())


@pytest.fixture(scope="module")
def runs():
    params, imgs, gt = _frames()
    sj = System_j(Sensor_j.MONOCULAR, cam_j.CameraModel.PINHOLE, params, (scene.W, scene.H),
                  orb_params=feat_j.OrbParams(**ORB), Kmax=32, Pmax=4096)
    sj.enable_async_mapping()
    sj.store.alloc_mps(1)
    _drop_kp0(sj.tracker, lambda f: f._replace(valid=f.valid.at[0].set(False)))
    st = System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, (scene.W, scene.H),
                orb_params=feat_t.OrbParams(**ORB), device="cpu", Kmax=32, Pmax=4096)
    st.enable_async_mapping()
    st.store.alloc_mps(1)

    def invalidate_t(f):
        valid = f.valid.clone()
        valid[0] = False
        return f._replace(valid=valid)

    _drop_kp0(st.tracker, invalidate_t)
    return dict(gt=gt, jax=_drive(sj, imgs), port=_drive(st, imgs))


def test_async_system_matches_jax(runs):
    j, p, gt = runs["jax"], runs["port"], runs["gt"]
    first_j, first_p = j["states"].index("OK"), p["states"].index("OK")
    assert abs(first_j - first_p) <= 1, (j["states"], p["states"])
    after = max(first_j, first_p)
    assert p["states"][after:] == j["states"][after:]
    assert max(abs(a - b) for a, b in zip(p["n_kf"], j["n_kf"])) <= 1, (p["n_kf"], j["n_kf"])
    assert p["n_completed"] == j["n_completed"] >= 1
    assert p["idle"] and j["idle"]
    gt_ts = np.arange(N_FRAMES) * 0.1
    ate_p = ate_t.ate_rmse(p["ts"], p["pos"], gt_ts, gt, with_scale=True)
    ate_j = ate_t.ate_rmse(j["ts"], j["pos"], gt_ts, gt, with_scale=True)
    assert ate_p < 0.05 and ate_j < 0.05, (ate_p, ate_j)
    a_p, a_j = _aligned(p["ts"], p["pos"], gt_ts, gt), _aligned(j["ts"], j["pos"], gt_ts, gt)
    common = sorted(set(a_p) & set(a_j))
    assert len(common) >= N_FRAMES - 2
    rms = np.sqrt(np.mean([np.sum((a_p[t] - a_j[t]) ** 2) for t in common]))
    assert rms < 0.02, rms


def _aligned(ts, pos, gt_ts, gt):
    ia, ib = ate_t.associate(ts, gt_ts, 0.01)
    s, R, t = ate_t.umeyama(pos[ia], gt[ib], True)
    return {round(float(ts[i]), 6): s * R @ pos[i] + t for i in ia}


def _busy_decisions(tracker, ref_matches_arg):
    """(decision, interrupts) for a busy mapper with 0..4 keyframes queued, on
    a frame that the frame and ratio gates pass (c1a and c2)."""
    tracker.ref_kf, tracker.last_kf_frame_id, tracker.last_kf_id = 0, 0, 0
    tracker.store.n_kf = 5
    out = []
    for q in range(5):
        hits = []
        tracker.mapper_idle_query = lambda: False
        tracker.mapping_queue_len = lambda q=q: q
        tracker.mapping_interrupt = lambda: hits.append(1)
        cur = SimpleNamespace(frame_id=100, timestamp=5.0, depth=None, mp_assoc=np.full(8, -1, np.int32))
        out.append((bool(tracker._need_new_keyframe(cur, 50, *ref_matches_arg)), len(hits)))
    return out


@pytest.mark.parametrize("sensor", ["MONOCULAR", "STEREO"])
def test_busy_mapper_interrupts_and_queues_as_jax(sensor):
    params, _, _ = _frames()
    bf = 0.0 if sensor == "MONOCULAR" else float(params[0]) * 0.1
    sj = System_j(getattr(Sensor_j, sensor), cam_j.CameraModel.PINHOLE, params,
                  (scene.W, scene.H), orb_params=feat_j.OrbParams(**ORB), bf=bf, Kmax=8,
                  Pmax=64)
    st = System(getattr(Sensor, sensor), CameraModel.PINHOLE, params, (scene.W, scene.H),
                orb_params=feat_t.OrbParams(**ORB), device="cpu", bf=bf, Kmax=8, Pmax=64)
    sj.tracker._ref_matches_cache = 100
    got_j = _busy_decisions(sj.tracker, ())
    got_t = _busy_decisions(st.tracker, (100,))
    assert got_t == got_j
    if sensor == "STEREO":
        assert got_t == [(True, 1), (True, 1), (True, 1), (False, 1), (False, 1)]
    else:
        assert got_t == [(False, 1)] * 5


def _async_port(device="cpu"):
    params, imgs, _ = _frames()
    slam = System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(**ORB), device=device, Kmax=32, Pmax=4096)
    slam.enable_async_mapping()
    return slam, imgs


def test_attach_store_aborts_and_merge_flushes():
    from orbslam3_tpu_torch.pipeline.multimap import MultiMapManager

    slam, _ = _async_port()
    am = slam.async_mapper
    am.queue.extend([3, 4])
    slam.reset_active_map()
    assert am.idle() and not am.queue
    calls = []

    class Stop(Exception):
        pass

    def flush():
        calls.append("flush")
        raise Stop

    am.flush = flush
    mm = MultiMapManager.__new__(MultiMapManager)
    mm.system = slam
    with pytest.raises(Stop):
        mm._do_merge(slam.store, slam.store, np.eye(3), np.zeros(3), 1.0)
    assert calls == ["flush"]


def test_tick_that_closes_a_loop_moves_the_last_frame_c17():
    """Fault C17: under asynchronous mapping a keyframe's pass, and the loop
    closing after it, completes in a later frame's tick. When that moved the
    map, the last frame takes its pose relative to its reference keyframe
    composed with the keyframe's new pose, so its trajectory entry and the
    next frame's prediction agree with the corrected map; when it did not, the
    tracked pose stays, as in the JAX package."""
    slam, imgs = _async_port()
    for k in range(4):
        slam.track_monocular(imgs[k], k * 0.1)
    assert slam.tracking_state == TrackState.OK
    slam.async_mapper.flush()
    tr = slam.tracker
    lc = SimpleNamespace(n_loops_closed=0, gba_async=None)
    slam.loop_closer = lc
    shift = np.array([0.05, -0.02, 0.01], np.float32)
    slam.mapper.STAGES = (lambda m, kf: None,)  # a pass of one empty stage

    def correct(slot):  # the loop correction moves the reference keyframe
        s = slam.store.state
        slam.store.state = s._replace(kf_t=s.kf_t.index_add(
            0, torch.tensor([tr.ref_kf]), torch.from_numpy(shift)[None]))
        lc.n_loops_closed += 1

    for closes in (False, True):
        slam._kf_downstream[:] = [correct] if closes else []
        last = tr.last_frame
        R0, t0 = last.R.copy(), last.t.copy()
        slam.async_mapper.submit(tr.last_kf_id)
        slam._tick_gba()
        assert slam.async_mapper.idle()
        if not closes:
            np.testing.assert_array_equal(last.t, t0)
            continue
        R_kf = slam.store.state.kf_R[tr.ref_kf].numpy()
        # the frame moved rigidly with its keyframe: by R_cr applied to the shift
        R_cr = R0 @ R_kf.T
        np.testing.assert_allclose(last.R, R0, atol=1e-6)
        np.testing.assert_allclose(last.t, t0 + R_cr @ shift, atol=1e-5)
        centre = tr.reconstructed_trajectory()[-1][2]
        np.testing.assert_allclose(centre, -last.R.T @ last.t, atol=1e-5)
