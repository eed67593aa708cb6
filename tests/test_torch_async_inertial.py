"""The inertial modes of the port's runner at its defaults on the CPU:
asynchronous mapping (one stage of a keyframe's pass per frame), place
recognition with the shipped `assets/ORBvoc_synth_100k.bin` and the Atlas,
against the JAX runner at the same flags and against a direct drive of an
asynchronous `System`.

Two scenes of `tests/test_torch_runner_modes.py`, written by its builders
(the rig's tests are in `tests/test_torch_async_inertial_rig.py`):

- `euroc_mono_vi`: `tests/vi_scene.py` from 3.5 s, grown from 28 to 33
  frames: under asynchronous mapping the pass that initializes the IMU
  completes about 5 frames after its keyframe, so the scene grows by the
  frames that pass needs, and a few pose-inertial frames follow it;
- `tumvi_stereo_vi_fisheye`: config 4's 16 frames (the 512x512 KB8 pair).
  Its IMU does not initialize within them, in either package.

Per scene, three runs, every one handed the same features call by call (the
JAX runner's extractions, ROADMAP C1) with map-point slot 0 empty and
keypoint 0 invalid (C6): the JAX runner (`scripts/run_sequence.py`, loaded by
path; faults C13, C14 and C20 repaired as the port repairs them), the port
runner (`run_sequence.main([..., "--device", "cpu"])`) and a direct drive
(`entry.drive_files`) of the scene's `System` with `enable_async_mapping`,
`enable_place_recognition` and `enable_multimap`, as the runner enables them.
The port's two-view initialization draws its minimal sets as the JAX
tracker's `PRNGKey(0)` does, so both start from the same map (C16).

Fault C20 under asynchronous mapping: the pass that initializes the IMU
completes in a tick frames after its keyframe. Both packages then hand the
tracker that keyframe's velocity, and their init-time VI-BA chains from it,
so the keyframes inserted since keep the inertial-only solve's velocities
(scaled twice, by the alignment's scale). The next frames predict from a
wrong velocity and their pose-inertial solves are refused. The port repairs
it (`LocalMapper._full_inertial_ba` from the newest keyframe,
`Tracker.update_frame_imu` after the tick); `_repair_c20` does the same to
the JAX runner for the comparison, which the unrepaired JAX runner fails
past the initialization by up to 0.03 m.

Gates. The runner equals the direct drive exactly: every frame's state,
keyframe count, IMU stages, pose, IMU prediction and tracked centre, and the
trajectory files byte for byte. Against the JAX runner, those of
`tests/test_torch_vi_system.py`: the same states after the map's
initialization, keyframe counts within 1 on every frame, the IMU initialized
within 2 keyframes of JAX's and on a frame within 2 of the frame whose tick
completed it there, VIBA1 where JAX ran it, the alignment's scale within 2%
and its gravity direction within 1e-2, and every trajectory row's camera
centre within 0.02 m. Fault C20's numbers (the IMU prediction against the
tracked camera centre on the frame after each IMU stage's tick, beside the
median of the other frames after the initialization) are printed for both.
"""

import contextlib
import importlib.util
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_runner_modes as modes
from orbslam3_tpu.ops import ransac as rs_j
from orbslam3_tpu.pipeline import inertial_support as is_j
from orbslam3_tpu.pipeline import local_mapping as lm_j
from orbslam3_tpu.pipeline import tracking as trk_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch import run_sequence
from orbslam3_tpu_torch.io import vocab_io
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.pipeline import tracking as trk_t
from orbslam3_tpu_torch.system import System
from test_torch_stereo_vi_system import _repair_c14
from test_torch_vi_system import _repair_c13

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

GROWN = {"euroc_mono_vi": modes.N_VI + 5, "tumvi_stereo_vi_fisheye": 16}
VOCAB = modes.REPO / "assets" / "ORBvoc_synth_100k.bin"


@contextlib.contextmanager
def _jax_watch(rows, transforms):
    """Record the JAX runner's frames as `entry.FrameRecord`s (the same
    fields as the port's `record_frames`) and its map transforms."""
    seen = {}
    mp = pytest.MonkeyPatch()

    def watching(fn):
        def track(self, *args, **kw):
            seen.clear()
            out = fn(self, *args, **kw)
            ini = self.mapper.imu_init
            rows.append(E.FrameRecord(
                self.tracking_state.name, self.store.n_kf, False, np.array(out.R),
                np.array(out.t), bool(self.mapper.imu_initialized),
                bool(ini is not None and ini.viba1_done), bool(ini is not None and ini.viba2_done),
                False, bool(seen.get("refined")), seen.get("pred"), seen.get("centre")))
            return out

        return track

    tick, body_to_cam = System_j._tick_gba, is_j.body_to_cam
    apply, refine = trk_j.Tracker.apply_map_transform, is_j.ImuInitializer.refine_scale

    def ticked(self):
        last = self.tracker.last_frame
        if last is not None and self.tracking_state.name == "OK":
            R, t = np.asarray(last.R, np.float64), np.asarray(last.t, np.float64)
            seen["centre"] = -R.T @ t
        return tick(self)

    def predicted(R_wb, p_wb, Rbc, tbc):
        if sys._getframe(1).f_code.co_filename.endswith("tracking.py"):  # the IMU prediction
            seen["pred"] = np.asarray(p_wb, np.float64) + np.asarray(R_wb) @ np.asarray(tbc)
        return body_to_cam(R_wb, p_wb, Rbc, tbc)

    def apply_map_transform(self, Rwg, s):
        transforms.append((np.array(Rwg), float(s)))
        return apply(self, Rwg, s)

    def refine_scale(self, *a, **kw):
        ok = refine(self, *a, **kw)
        seen["refined"] = seen.get("refined", False) or bool(ok)
        return ok

    for name in ("track_monocular", "track_stereo"):
        mp.setattr(System_j, name, watching(getattr(System_j, name)))
    mp.setattr(System_j, "_tick_gba", ticked)
    mp.setattr(is_j, "body_to_cam", predicted)
    mp.setattr(trk_j.Tracker, "apply_map_transform", apply_map_transform)
    mp.setattr(is_j.ImuInitializer, "refine_scale", refine_scale)
    try:
        yield
    finally:
        mp.undo()


def _port_transforms(transforms):
    apply = trk_t.Tracker.apply_map_transform

    def apply_map_transform(self, Rwg, s):
        transforms.append((np.array(Rwg), float(s)))
        return apply(self, Rwg, s)

    return apply_map_transform


def _repair_c20(mp):
    """C20 repaired in the JAX runner for this run as the port repairs it
    (`LocalMapper._full_inertial_ba`, `Tracker.update_frame_imu`): the full
    VI-BA chains from the map's newest keyframe, and a tick that completed an
    IMU stage (the initialization, VIBA1, VIBA2, an applied scale refinement)
    re-predicts the last frame's pose and velocity from its keyframe's state
    through the preintegration since that keyframe."""
    full, tick = lm_j.LocalMapper._full_inertial_ba, System_j._tick_gba
    refine, refined = is_j.ImuInitializer.refine_scale, [0]

    def full_inertial_ba(self, kf_id, **kw):
        ids = np.flatnonzero(np.asarray(self.store.state.kf_valid)[: self.store.n_kf])
        return full(self, int(ids[np.argmax(self.store.kf_ts[ids])]), **kw)

    def refine_scale(self, *a, **kw):
        ok = refine(self, *a, **kw)
        refined[0] += bool(ok)
        return ok

    def stages(slam):
        ini = slam.mapper.imu_init
        return (ini.initialized, ini.viba1_done, ini.viba2_done, refined[0])

    def _tick_gba(self):
        before = stages(self)
        out = tick(self)
        tr = self.tracker
        if stages(self) != before and tr.imu_ready and tr.last_frame is not None \
                and tr.last_kf_id >= 0:
            s, k = self.store.state, tr.last_kf_id
            R, t, v = (np.asarray(x[k], np.float64) for x in (s.kf_R, s.kf_t, s.kf_vel))
            bg, ba = np.asarray(s.kf_bias_g[k]), np.asarray(s.kf_bias_a[k])
            if tr.last_kf_frame_id != tr.last_frame.frame_id and tr.pre_from_kf is not None:
                R_wb, p_wb = is_j.cam_to_body(R, t, tr.Rbc, tr.tbc)
                R1, v, p1 = is_j.predict_state(R_wb, p_wb, v, bg, ba, tr.pre_from_kf)
                R, t = is_j.body_to_cam(R1, p1, tr.Rbc, tr.tbc)
            tr.last_frame.R, tr.last_frame.t = (np.asarray(x, np.float32) for x in (R, t))
            tr.body_vel = np.asarray(v, np.float32)
            tr.bias_g, tr.bias_a = np.asarray(bg, np.float32), np.asarray(ba, np.float32)
            tr.frame_prior = None
        return out

    mp.setattr(lm_j.LocalMapper, "_full_inertial_ba", full_inertial_ba)
    mp.setattr(is_j.ImuInitializer, "refine_scale", refine_scale)
    mp.setattr(System_j, "_tick_gba", _tick_gba)


def _jax_draws(mp):
    """The port's two-view initialization draws its minimal sets as the JAX
    tracker does (`PRNGKey(0)` over the valid matches): the same features
    then give the same initial map (ROADMAP C16)."""
    two_views = trk_t.ransac.reconstruct_two_views

    def drawn(p1, p2, valid, generator=None, **kw):
        logits = jnp.log(jnp.asarray(valid.numpy(), jnp.float32) + 1e-9)
        samples = jax.random.categorical(jax.random.PRNGKey(0), logits[None, None, :],
                                         shape=(rs_j.N_HYPOTHESES, rs_j.SAMPLE))
        return two_views(p1, p2, valid, samples=torch.from_numpy(np.array(samples)), **kw)

    mp.setattr(trk_t.ransac, "reconstruct_two_views", drawn)


def _leaving_slot_0(mp, cls):
    init = cls.__init__

    def __init__(self, *args, **kw):
        init(self, *args, **kw)
        self.store.alloc_mps(1)

    mp.setattr(cls, "__init__", __init__)


def _scene_runs(name, tmp):
    """The three runs of a scene (module docstring)."""
    root = tmp / "seq"
    root.mkdir()
    builder = {"euroc_mono_vi": modes._euroc_mono_vi,
               "tumvi_stereo_vi_fisheye": modes._tumvi_fisheye}[name]
    flags, slam, seq, imu = builder(root, GROWN[name])
    def argv(out):
        return [str(root / "settings.yaml"), str(root), "--out", str(tmp / f"{out}.txt"),
                "--kf-out", str(tmp / f"{out}_kf.txt")] + flags
    feats, jax_rows, jax_tf = [], [], []
    extract = trk_j.Tracker._extract

    def recording(self, img):
        f = extract(self, img)
        f = f._replace(valid=f.valid.at[0].set(False))
        feats.append(type(f)(*(np.array(x) for x in f)))
        return f

    with pytest.MonkeyPatch.context() as mp:
        _repair_c13(mp)
        _repair_c14(mp)
        _repair_c20(mp)
        mp.setattr(trk_j.Tracker, "_extract", recording)
        _leaving_slot_0(mp, System_j)
        spec = importlib.util.spec_from_file_location("jax_run_sequence",
                                                      modes.REPO / "scripts" / "run_sequence.py")
        runner = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(runner)
        mp.setattr(sys, "argv", ["run_sequence.py"] + argv("jax"))
        with _jax_watch(jax_rows, jax_tf), contextlib.redirect_stdout(io.StringIO()):
            runner.main()

    port_tf = []
    with pytest.MonkeyPatch.context() as mp:
        given = iter(feats)
        mp.setattr(trk_t.Tracker, "_extract",
                   lambda self, img: convert.to_torch(next(given), "cpu", feat.Features))
        mp.setattr(trk_t.Tracker, "apply_map_transform", _port_transforms(port_tf))
        _jax_draws(mp)
        _leaving_slot_0(mp, System)
        with E.record_frames() as port_rows, contextlib.redirect_stdout(io.StringIO()):
            res = run_sequence.main(argv("port") + ["--device", "cpu"])
        assert next(given, None) is None  # as many extractions as the JAX runner

        given = iter(feats)
        slam.store.alloc_mps(1)
        slam.enable_async_mapping()
        voc = vocab_io.load_binary_vocabulary(str(VOCAB), "cpu")
        slam.enable_place_recognition(voc)
        slam.enable_multimap(voc)
        with E.record_frames() as direct:
            E.drive_files(slam, flags[flags.index("--mode") + 1], seq, imu=imu)
        slam.shutdown()
        assert next(given, None) is None
    slam.save_trajectory_tum(str(tmp / "direct.txt"))
    slam.save_keyframe_trajectory_tum(str(tmp / "direct_kf.txt"))
    return dict(tmp=tmp, res=res, port=port_rows, direct=direct, jax=jax_rows,
                port_tf=port_tf, jax_tf=jax_tf, slam=slam)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _scene_runs(name, tmp_path_factory.mktemp(name))
        return cache[name]

    return get


KEEP = ("state", "n_kf", "keyframe", "imu_init", "viba1", "viba2", "pi_taken", "refined")


def check_direct_drive(run, name):
    """The runner at its defaults is a direct drive of an asynchronous
    `System` with place recognition and the Atlas, exactly."""
    rows, direct, tmp = run["port"], run["direct"], run["tmp"]
    assert len(rows) == len(direct) == GROWN[name]
    for k, (a, b) in enumerate(zip(rows, direct)):
        assert [getattr(a, f) for f in KEEP] == [getattr(b, f) for f in KEEP], (k, a, b)
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t), k
        for f in ("pred", "centre"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None) and (x is None or np.array_equal(x, y)), (k, f)
    assert run["res"]["mapping"] == "asynchronous" and run["res"]["mapper_idle"]
    assert run["res"]["n_kf"] == run["slam"].n_keyframes
    assert [k == "keyframe" for k in run["res"]["kinds"]] == [
        r.state == "OK" and r.keyframe for r in direct]
    assert "mapping stage" in run["res"]["kinds"]  # passes ran in later frames' ticks
    assert (tmp / "port.txt").read_bytes() == (tmp / "direct.txt").read_bytes()
    assert (tmp / "port_kf.txt").read_bytes() == (tmp / "direct_kf.txt").read_bytes()


def check_jax_runner(run, name):
    """The port runner against the JAX runner at the same defaults, with the
    same features (module docstring's gates)."""
    got, want = run["port"], run["jax"]
    assert len(got) == len(want) == GROWN[name]
    states_t, states_j = [r.state for r in got], [r.state for r in want]
    start = states_j.index("OK")
    assert states_t[start:] == states_j[start:] and all(s == "OK" for s in states_j[start:])
    assert all(abs(a.n_kf - b.n_kf) <= 1 for a, b in zip(got, want)), (
        [r.n_kf for r in got], [r.n_kf for r in want])
    st_t, st_j = E.imu_stage_frames(got), E.imu_stage_frames(want)
    c20_t, c20_j = E.imu_prediction_errors(got), E.imu_prediction_errors(want)
    print(f"{name}: IMU stages' frames port {st_t}, JAX {st_j}; C20, the IMU prediction's "
          f"distance (m) from the tracked centre on the frame after each stage's tick, port "
          f"{c20_t['after']}, JAX {c20_j['after']}; the other frames' median port "
          f"{c20_t['median']}, JAX {c20_j['median']}")
    assert ("imu_init" in st_t) == ("imu_init" in st_j)
    if "imu_init" in st_j:
        k_t, k_j = st_t["imu_init"], st_j["imu_init"]
        assert abs(got[k_t].n_kf - want[k_j].n_kf) <= 2 and abs(k_t - k_j) <= 2, (k_t, k_j)
        assert run["res"]["kinds"][k_t] != "tracked"  # a pass's stage ran in its tick
        (Rwg_t, s_t), (Rwg_j, s_j) = run["port_tf"][0], run["jax_tf"][0]
        assert abs(s_t / s_j - 1) < 0.02, (s_t, s_j)
        g = np.array([0.0, 0.0, -1.0])
        np.testing.assert_allclose(Rwg_t @ g, Rwg_j @ g, atol=1e-2)
        assert any(r.pi_taken for r in got[k_t + 1:])  # pose-inertial frames follow
    assert ("viba1" in st_t) == ("viba1" in st_j)
    load = lambda f: np.loadtxt(run["tmp"] / f, ndmin=2)  # noqa: E731
    for a, b in ((load("port.txt"), load("jax.txt")), (load("port_kf.txt"), load("jax_kf.txt"))):
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=0.02)


# The rig's scene runs in `test_torch_async_inertial_rig.py`: one scene a file,
# so the tier-1 run's workers take them in parallel.
@pytest.mark.parametrize("name", ["euroc_mono_vi"])
def test_async_inertial_runner_equals_a_direct_drive(name, runs):
    check_direct_drive(runs(name), name)


@pytest.mark.parametrize("name", ["euroc_mono_vi"])
def test_async_inertial_runner_agrees_with_the_jax_runner(name, runs):
    check_jax_runner(runs(name), name)


@pytest.mark.parametrize("sensor", ["IMU_MONOCULAR", "IMU_STEREO"])
def test_busy_mapper_in_the_inertial_modes_decides_as_jax(sensor):
    """`_need_new_keyframe` with a busy mapper after the IMU initialization,
    0 to 4 keyframes queued, on a frame 5 s after the last keyframe (its c3)
    with 50 inliers (mono-inertial's c4): the same decision and interrupt as
    the JAX tracker's. A monocular-inertial keyframe waits for the mapper; a
    stereo-inertial one queues while fewer than 3 wait."""
    from orbslam3_tpu.ops import cameras as cam_j
    from orbslam3_tpu.ops import features as feat_j
    from orbslam3_tpu.ops import imu as imu_j
    from orbslam3_tpu.system import Sensor as Sensor_j
    from orbslam3_tpu_torch.ops import imu as imu_t
    from orbslam3_tpu_torch.ops.cameras import CameraModel
    from orbslam3_tpu_torch.system import Sensor
    from test_torch_async_mapping import ORB, _busy_decisions, _frames

    params, _, _ = _frames()
    bf = 0.0 if sensor == "IMU_MONOCULAR" else float(params[0]) * 0.1
    noise = dict(noise_gyro=1.7e-4, noise_acc=2.0e-3, walk_gyro=1.9e-5, walk_acc=3.0e-3,
                 freq=200.0)
    sj = System_j(getattr(Sensor_j, sensor), cam_j.CameraModel.PINHOLE, params,
                  (modes.mono_scene.W, modes.mono_scene.H), orb_params=feat_j.OrbParams(**ORB),
                  bf=bf, Kmax=8, Pmax=64,
                  imu_calib=imu_j.ImuCalib.create(np.eye(3), np.zeros(3), **noise))
    st = System(getattr(Sensor, sensor), CameraModel.PINHOLE, params,
                (modes.mono_scene.W, modes.mono_scene.H), orb_params=feat.OrbParams(**ORB),
                device="cpu", bf=bf, Kmax=8, Pmax=64,
                imu_calib=imu_t.ImuCalib.create(np.eye(3), np.zeros(3), **noise, device="cpu"))
    for s in (sj, st):
        s.tracker.imu_ready = True
        s.store.kf_ts[0] = 0.0
    sj.tracker._ref_matches_cache = 100
    got_j = _busy_decisions(sj.tracker, ())
    got_t = _busy_decisions(st.tracker, (100,))
    assert got_t == got_j
    if sensor == "IMU_STEREO":
        assert got_t == [(True, 1), (True, 1), (True, 1), (False, 1), (False, 1)]
    else:
        assert got_t == [(False, 1)] * 5


def test_tick_that_completes_an_imu_stage_updates_the_last_frame_c20():
    """Fault C20, its asynchronous case: a pass's IMU stage (here one that, as
    the initialization does, writes every keyframe's velocity and hands the
    tracker the pass keyframe's, `LocalMapper._sync_tracker`) completes in
    the tick after a later frame. The tracker then holds that older
    keyframe's velocity, and the next frame's IMU prediction starts from it.
    As ORB-SLAM3's `UpdateFrameIMU`, the last frame's pose and velocity are
    re-predicted from its own keyframe's new state through the
    preintegration since that keyframe, or are that keyframe's on its own
    frame."""
    import vi_scene
    from orbslam3_tpu_torch.ops import imu as imu_t
    from orbslam3_tpu_torch.ops.cameras import CameraModel
    from orbslam3_tpu_torch.pipeline import inertial_support as isup
    from orbslam3_tpu_torch.system import Sensor

    ts, imgs, _, batches = vi_scene.frames(10, modes.VI_T0)
    calib = imu_t.ImuCalib.create(np.eye(3), np.zeros(3), **vi_scene.NOISE, device="cpu")
    slam = System(Sensor.IMU_MONOCULAR, CameraModel.PINHOLE, vi_scene.PARAMS,
                  (vi_scene.W, vi_scene.H), modes.ORB, device="cpu", Kmax=32, Pmax=4096,
                  fps=10.0, imu_calib=calib)
    slam.enable_async_mapping()
    tr, mapper = slam.tracker, slam.mapper
    seen_own = seen_later = False
    for k in range(len(ts)):
        slam.track_monocular(imgs[k], float(ts[k]), imu_measurements=batches[k])
        slam.async_mapper.flush()
        if tr.last_kf_id < 1 or slam.tracking_state.name != "OK":
            continue
        own = tr.last_kf_frame_id == tr.last_frame.frame_id
        kf, old = tr.last_kf_id, tr.last_kf_id - 1  # the pass's keyframe is an older one
        vel = torch.tensor([[0.3, -0.2, 0.1]]) * torch.arange(1, 33)[:, None]
        bg, ba = torch.tensor([1e-3, -2e-3, 3e-3]), torch.tensor([0.02, -0.01, 0.03])

        def imu_stage(m, kf_id, vel=vel):
            s = m.store.state
            m.store.state = s._replace(kf_vel=vel.clone(), kf_bias_g=bg.expand(32, 3).clone(),
                                       kf_bias_a=ba.expand(32, 3).clone())
            m._sync_tracker(kf_id)  # hands over keyframe `kf_id`'s velocity
            m.n_imu_stages = getattr(m, "n_imu_stages", 0) + 1

        tr.imu_ready = True
        stages = mapper.STAGES
        mapper.STAGES = (imu_stage,)
        slam.async_mapper.submit(old)
        try:
            slam._tick_gba()
        finally:
            mapper.STAGES = stages
            tr.imu_ready = False
        s = slam.store.state
        if own:
            want_R, want_t, want_v = s.kf_R[kf], s.kf_t[kf], vel[kf]
            seen_own = True
        else:
            R_wb, p_wb = isup.cam_to_body(s.kf_R[kf], s.kf_t[kf], calib.Rbc, calib.tbc)
            R1, want_v, p1 = isup.predict_state(R_wb, p_wb, vel[kf], bg, ba, tr.pre_from_kf)
            want_R, want_t = isup.body_to_cam(R1, p1, calib.Rbc, calib.tbc)
            seen_later = True
        assert not np.allclose(tr.body_vel, vel[old].numpy())
        np.testing.assert_allclose(tr.body_vel, want_v.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.last_frame.R, want_R.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.last_frame.t, want_t.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tr.bias_a, ba.numpy(), rtol=0, atol=0)
        assert tr.frame_prior is None
        # the state the stage wrote stays: restore the visual map's zeros
        slam.store.state = s._replace(kf_vel=torch.zeros_like(s.kf_vel),
                                      kf_bias_g=torch.zeros_like(s.kf_bias_g),
                                      kf_bias_a=torch.zeros_like(s.kf_bias_a))
        tr.body_vel = np.zeros(3, np.float32)
        tr.bias_g, tr.bias_a = np.zeros(3, np.float32), np.zeros(3, np.float32)
    assert seen_own and seen_later
