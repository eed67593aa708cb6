"""The port's runner (`run_sequence.main`) in every sensor mode and dataset
layout on the CPU, against a direct drive of the port's `System` on the same
decoded files.

Five directories, each written with the port's own writers (`io/datasets.py`,
`entry.write_euroc_sequence`):

- KITTI mono and TUM RGB-D: the scenes of `tests/test_runners.py` (10
  frames of `tests/test_e2e_mono.py`'s world, 320x240, 400 features on 3
  levels; the RGB-D depth painted square by square as there, at
  `DepthMapFactor` 5000);
- TUM-VI stereo-inertial fisheye: the 16 frames of `make_synth_euroc.py
  --fisheye` (config 4: the 512x512 KB8 pair, its settings, its IMU);
- EuRoC stereo: the 16 frames of `tests/stereo_scene.py` (bf 31.2), the
  scene of `test_torch_stereo_system.py`;
- EuRoC mono-inertial: `tests/vi_scene.py` from 3.5 s, 10 Hz with its 200 Hz
  IMU, past the IMU initialization.

Each runs through `run_sequence.main([..., "--device", "cpu",
"--sync-mapping", "--no-loop"])` (once per module, for both tests of the
scene) and through `entry.drive_files` on a
`System` built here from the scene's own constants (config 4's as
`entry.replay(..., "stereo_vi_fisheye")` builds it), its frames read by the
`datasets` loaders and its IMU samples, read back from the CSV, batched by
`entry.imu_batches`. `entry.record_frames` watches both: every frame's
state, keyframe count and pose must be equal, exactly, and so must the
trajectory files. The gates of the JAX runner's tests stay: the last frame
OK, KITTI's 12-column rows, the fisheye SE3 ATE under 0.05 m.

On KITTI mono, TUM RGB-D and EuRoC stereo the JAX runner
(`scripts/run_sequence.py`, loaded by path) also runs on the same directory
with the same flags, and the port runner, handed the JAX runner's features
as the `System` tests hand them (ROADMAP C1), is held to its states,
keyframe counts and trajectory files at those tests' tolerances
(`test_torch_system.py` for mono, `test_torch_stereo_system.py` for stereo
and RGB-D). The port's `System` in the inertial and fisheye modes is held
against the JAX `System` in `test_torch_vi_system.py` and
`test_torch_fisheye_system.py`.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import stereo_scene
import test_e2e_mono as mono_scene
import vi_scene
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch import run_sequence
from orbslam3_tpu_torch.ate import umeyama
from orbslam3_tpu_torch.io import datasets
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.system import Sensor, System
from test_runners import SETTINGS

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

REPO = Path(__file__).resolve().parents[1]
ORB = feat.OrbParams(n_features=400, n_levels=3)
PINHOLE = np.array([mono_scene.FOCAL, mono_scene.FOCAL, mono_scene.W / 2, mono_scene.H / 2,
                    0.0, 0.0, 0.0, 0.0], np.float32)
VI_T0 = 3.5  # s of the path: the IMU initializes at frame 25 with 10 keyframes
N_VI = 28


def _pinhole_yaml(fx, w, h, fps, extra=""):
    return (f"%YAML:1.0\nCamera.type: \"PinHole\"\nCamera.fx: {fx}\nCamera.fy: {fx}\n"
            f"Camera.cx: {w / 2}\nCamera.cy: {h / 2}\nCamera.width: {w}\nCamera.height: {h}\n"
            f"Camera.fps: {fps}\nORBextractor.nFeatures: 400\nORBextractor.scaleFactor: 1.2\n"
            f"ORBextractor.nLevels: 3\nORBextractor.iniThFAST: 20\n"
            f"ORBextractor.minThFAST: 7\n{extra}")


def _e2e_frames():
    """tests/test_runners.py's 10 frames (its `rng` fixture's seed 0): the
    uint8 images and, for RGB-D, the depth painted far to near."""
    params = cam_j.make_pinhole(mono_scene.FOCAL, mono_scene.FOCAL, mono_scene.W / 2,
                                mono_scene.H / 2)
    pts, shades = mono_scene.make_world(np.random.default_rng(0))
    imgs, depths = [], []
    for R, t in mono_scene.camera_path(10):
        imgs.append(np.asarray(mono_scene.render(params, R, t, pts, shades)).astype(np.uint8))
        depth = np.zeros((mono_scene.H, mono_scene.W), np.float32)
        Xc = (R @ pts.T).T + t
        uv = mono_scene.FOCAL * Xc[:, :2] / Xc[:, 2:] + [mono_scene.W / 2, mono_scene.H / 2]
        for i in np.argsort(-Xc[:, 2]):
            if Xc[i, 2] < 0.5:
                continue
            half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
            ui, vi = int(round(uv[i, 0])), int(round(uv[i, 1]))
            if 1 <= ui < mono_scene.W - 1 and 1 <= vi < mono_scene.H - 1:
                depth[max(vi - half, 0):vi + half, max(ui - half, 0):ui + half] = Xc[i, 2]
        depths.append(depth)
    return imgs, depths


def _kitti(root):
    imgs, _ = _e2e_frames()
    datasets.write_kitti(str(root), [k * 0.1 for k in range(len(imgs))], imgs)
    (root / "settings.yaml").write_text(SETTINGS)
    slam = System(Sensor.MONOCULAR, CameraModel.PINHOLE, PINHOLE, (mono_scene.W, mono_scene.H),
                  ORB, device="cpu", bf=13.0, Kmax=32, Pmax=4096, fps=10.0)
    return (["--dataset", "kitti", "--mode", "mono", "--kmax", "32", "--pmax", "4096",
             "--traj-format", "kitti"], slam, datasets.load_kitti(str(root)), None)


def _tum_rgbd(root):
    imgs, depths = _e2e_frames()
    assoc = datasets.write_tum_rgbd(str(root), [k * 0.1 for k in range(len(imgs))], imgs, depths)
    (root / "settings.yaml").write_text(SETTINGS)
    slam = System(Sensor.RGBD, CameraModel.PINHOLE, PINHOLE, (mono_scene.W, mono_scene.H), ORB,
                  device="cpu", bf=13.0, Kmax=32, Pmax=4096, fps=10.0)
    return (["--dataset", "tumrgbd", "--mode", "rgbd", "--assoc", assoc, "--kmax", "32",
             "--pmax", "4096"], slam, datasets.load_tum_rgbd(str(root), assoc), None)


def _tumvi_fisheye(root, n_frames=16):
    E.write_euroc_sequence(str(root), n_frames, 0, imu=True, fisheye=True)
    seq = datasets.load_tumvi_images(str(root))
    seq.paths_right = datasets.load_tumvi_images(str(root), cam="cam1").paths
    slam = E.make_system("cpu", "stereo_vi_fisheye", Kmax=32, Pmax=8192)
    return (["--dataset", "tumvi", "--mode", "stereo-vi", "--kmax", "32", "--pmax", "8192"],
            slam, seq, datasets.load_tumvi_imu(str(root)))


def _euroc_stereo(root):
    n = stereo_scene.N_FRAMES
    left, right, _, centres = stereo_scene.stereo_frames(n)
    ns = [E.START_NS + 100_000_000 * k for k in range(n)]
    quats = np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    u8 = [np.clip(np.round(x), 0, 255).astype(np.uint8) for x in (left, right)]
    datasets.write_euroc(str(root), ns, u8[0], _pinhole_yaml(
        stereo_scene.FOCAL, stereo_scene.W, stereo_scene.H, 10.0,
        f"Camera.bf: {stereo_scene.BF}\nThDepth: 35.0\n"), right=u8[1],
        groundtruth=(np.asarray(centres), quats))
    seq = datasets.load_euroc_images(str(root))
    seq.paths_right = datasets.load_euroc_images(str(root), cam="cam1").paths
    slam = System(Sensor.STEREO, CameraModel.PINHOLE, stereo_scene.PARAMS,
                  (stereo_scene.W, stereo_scene.H), ORB, device="cpu", bf=stereo_scene.BF,
                  Kmax=32, Pmax=4096, fps=10.0)
    return (["--dataset", "euroc", "--mode", "stereo", "--kmax", "32", "--pmax", "4096"], slam,
            seq, None)


def _euroc_mono_vi(root, n_frames=N_VI):
    ts, imgs, centres, _ = vi_scene.frames(n_frames, VI_T0)
    t_imu, acc, gyro = vi_scene.imu_stream(ts[-1] + 0.01)
    n = vi_scene.NOISE
    imu_yaml = ("Tbc: !!opencv-matrix\n   rows: 4\n   cols: 4\n   dt: f\n   data: [1.0, 0.0, 0.0, "
                "0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]\n"
                f"IMU.NoiseGyro: {n['noise_gyro']}\nIMU.NoiseAcc: {n['noise_acc']}\n"
                f"IMU.GyroWalk: {n['walk_gyro']}\nIMU.AccWalk: {n['walk_acc']}\n"
                f"IMU.Frequency: {int(n['freq'])}\n")
    to_ns = lambda t: [E.START_NS + int(round(x * 1e9)) for x in t]  # noqa: E731
    datasets.write_euroc(
        str(root), to_ns(ts), [np.clip(np.round(x), 0, 255).astype(np.uint8) for x in imgs],
        _pinhole_yaml(vi_scene.FOCAL, vi_scene.W, vi_scene.H, 10.0, imu_yaml),
        imu=(to_ns(t_imu), gyro, acc),
        groundtruth=(centres, np.tile([1.0, 0.0, 0.0, 0.0], (n_frames, 1))))
    calib = imu_ops.ImuCalib.create(np.eye(3), np.zeros(3), **n, device="cpu")
    slam = System(Sensor.IMU_MONOCULAR, CameraModel.PINHOLE, vi_scene.PARAMS,
                  (vi_scene.W, vi_scene.H), ORB, device="cpu", Kmax=32, Pmax=4096, fps=10.0,
                  imu_calib=calib)
    return (["--dataset", "euroc", "--mode", "mono-vi", "--kmax", "32", "--pmax", "4096"], slam,
            datasets.load_euroc_images(str(root)), datasets.load_euroc_imu(str(root)))


SCENES = {"kitti_mono": _kitti, "tum_rgbd": _tum_rgbd, "tumvi_stereo_vi_fisheye": _tumvi_fisheye,
          "euroc_stereo": _euroc_stereo, "euroc_mono_vi": _euroc_mono_vi}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per scene, on first use: its directory, the runner's result, stdout and
    recorded frames, and the direct drive's inputs (each test then takes
    one run, not two)."""
    cache = {}

    def get(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            root = tmp / "seq"
            root.mkdir()
            flags, slam, seq, imu = SCENES[name](root)
            out, kf_out = tmp / "traj.txt", tmp / "kf.txt"
            buf = io.StringIO()
            with E.record_frames() as frames, contextlib.redirect_stdout(buf):
                res = run_sequence.main([str(root / "settings.yaml"), str(root), "--device",
                                         "cpu", "--sync-mapping", "--no-loop", "--out", str(out),
                                         "--kf-out", str(kf_out)] + flags)
            cache[name] = dict(tmp=tmp, root=root, flags=flags, slam=slam, seq=seq, imu=imu, out=out,
                               kf_out=kf_out, res=res, text=buf.getvalue(), frames=frames)
        return cache[name]

    return get


def _fmt(run):
    return "kitti" if "kitti" in run["flags"] else "tum"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_runner_mode_keeps_the_jax_runner_gates(name, runs):
    """The gates of `tests/test_runners.py` on the port's runner."""
    run = runs(name)
    text, n = run["text"], len(run["seq"])
    assert re.search(rf"^\[{n - 1}/{n}\] state=OK ", text, re.M), text[-2000:]
    assert run["res"]["n"] == n and run["res"]["states"][-1] == "OK"
    rows = np.loadtxt(run["out"], ndmin=2)
    assert np.isfinite(rows).all() and rows.shape[1] == (12 if _fmt(run) == "kitti" else 8)
    if name == "tum_rgbd":
        assert len(rows) >= 5
    if name == "tumvi_stereo_vi_fisheye":
        ate = float(re.search(r"^ATE RMSE: ([0-9.]+) m$", text, re.M).group(1))
        assert ate < 0.05 and "scale vs GT: " in text
    if name == "euroc_mono_vi":
        sysm = run["res"]["system"]
        assert sysm.mapper.imu_initialized and "imu stages: init=True" in text
        assert sysm.tracker.imu_ready  # the last frames took the pose-inertial solve


@pytest.mark.parametrize("name", sorted(SCENES))
def test_runner_mode_equals_a_direct_drive(name, runs):
    """Frame by frame the runner's states, keyframe counts and poses are a
    direct drive's, exactly, and so are the trajectory files."""
    run = runs(name)
    slam, tmp = run["slam"], run["tmp"]
    mode = run["flags"][run["flags"].index("--mode") + 1]
    with E.record_frames() as direct:
        E.drive_files(slam, mode, run["seq"], imu=run["imu"])
    slam.shutdown()
    by_runner = run["frames"]
    assert len(by_runner) == len(direct) == len(run["seq"])
    for k, (a, b) in enumerate(zip(by_runner, direct)):
        keep = ("state", "n_kf", "keyframe", "imu_init", "viba1", "viba2", "pi_taken")
        assert [getattr(a, f) for f in keep] == [getattr(b, f) for f in keep], (k, a, b)
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t), k
    assert run["res"]["states"] == [r.state for r in direct]
    # fault C18: a keyframe in a freed slot leaves the slot count as it was
    assert [k == "keyframe" for k in run["res"]["kinds"]] == [
        r.state == "OK" and r.keyframe for r in direct]
    assert run["res"]["n_kf"] == slam.n_keyframes
    save = slam.save_trajectory_kitti if _fmt(run) == "kitti" else slam.save_trajectory_tum
    save(str(tmp / "direct.txt"))
    slam.save_keyframe_trajectory_tum(str(tmp / "direct_kf.txt"))
    assert run["out"].read_bytes() == (tmp / "direct.txt").read_bytes()
    assert run["kf_out"].read_bytes() == (tmp / "direct_kf.txt").read_bytes()


def _runner_argv(run, out, kf_out):
    return [str(run["root"] / "settings.yaml"), str(run["root"]), "--sync-mapping", "--no-loop",
            "--out", str(out), "--kf-out", str(kf_out)] + run["flags"]


def _same_features_runs(run, monkeypatch):
    """Both runners on the scene's directory with the port runner's flags, as
    the `System` tests run both systems: the JAX runner (loaded by path)
    first, every extraction recorded; then the port runner, its tracker
    handed those features call by call (ROADMAP C1: the pyramids differ by
    0-2 grey levels); both with map-point slot 0 empty and keypoint 0
    invalid (C6). Per runner: per frame (state, keyframe count), the
    trajectory rows and the keyframe rows."""
    from orbslam3_tpu.pipeline import tracking as trk_j
    from orbslam3_tpu.system import System as JaxSystem
    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch.pipeline import tracking as trk_t

    def leaving_slot_0(cls):
        init = cls.__init__

        def __init__(self, *args, **kw):
            init(self, *args, **kw)
            self.store.alloc_mps(1)

        monkeypatch.setattr(cls, "__init__", __init__)

    rows, feats = [], []
    extract = trk_j.Tracker._extract

    def recording(self, img):
        f = extract(self, img)
        f = f._replace(valid=f.valid.at[0].set(False))
        feats.append(type(f)(*(np.array(x) for x in f)))
        return f

    def watched(fn):
        def track(self, *args, **kw):
            out = fn(self, *args, **kw)
            rows.append((self.tracking_state.name, self.n_keyframes))
            return out

        return track

    monkeypatch.setattr(trk_j.Tracker, "_extract", recording)
    for name in ("track_monocular", "track_stereo", "track_rgbd"):
        monkeypatch.setattr(JaxSystem, name, watched(getattr(JaxSystem, name)))
    leaving_slot_0(JaxSystem)
    spec = importlib.util.spec_from_file_location("jax_run_sequence",
                                                  REPO / "scripts" / "run_sequence.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    tmp = run["tmp"]
    monkeypatch.setattr(sys, "argv", ["run_sequence.py"] + _runner_argv(
        run, tmp / "jax.txt", tmp / "jax_kf.txt"))
    with contextlib.redirect_stdout(io.StringIO()):
        runner.main()

    given = iter(feats)
    monkeypatch.setattr(trk_t.Tracker, "_extract",
                        lambda self, img: convert.to_torch(next(given), "cpu", feat.Features))
    leaving_slot_0(System)
    with E.record_frames() as port, contextlib.redirect_stdout(io.StringIO()):
        run_sequence.main(_runner_argv(run, tmp / "port.txt", tmp / "port_kf.txt")
                          + ["--device", "cpu"])
    assert next(given, None) is None  # as many extractions as the JAX runner
    load = lambda f: np.loadtxt(tmp / f, ndmin=2)  # noqa: E731
    return (([(r.state, r.n_kf) for r in port], load("port.txt"), load("port_kf.txt")),
            (rows, load("jax.txt"), load("jax_kf.txt")))


def _kitti_centres_aligned(rows):
    """The camera centres of a KITTI trajectory (3x4 Twc rows, the last
    frames of the scene), Sim3-aligned to the scene's ground truth."""
    gt = np.asarray([-R.T @ t for R, t in mono_scene.camera_path(10)], np.float64)[-len(rows):]
    pos = rows[:, [3, 7, 11]]
    s, R, t = umeyama(pos, gt, True)
    return (s * (R @ pos.T)).T + t, gt


JAX_POSE_TOL = {"euroc_stereo": 2e-3, "tum_rgbd": 1e-4, "kitti_mono": None}


@pytest.mark.parametrize("name", sorted(JAX_POSE_TOL))
def test_runner_mode_agrees_with_the_jax_runner(name, runs, monkeypatch):
    """The port runner against the JAX runner on the same directory with the
    same flags and the same features, at the `System` tests' tolerances.
    Stereo and RGB-D, as `test_torch_stereo_system.py`: the same state and
    keyframe count on every frame, the same trajectory and keyframe
    timestamps, the camera centres within 2e-3 m (stereo) or 1e-4 m
    (RGB-D). KITTI mono, as `test_torch_system.py` (the two-view
    initializations draw differently): the initialization within one frame
    and the same states after it, keyframe counts within one on every
    frame, and the trajectories (KITTI rows carry no time: the last frames
    of the scene), each Sim3-aligned to the ground truth, under 0.05 m ATE
    and within 0.02 m RMS of each other."""
    run = runs(name)
    (got, traj_t, kf_t), (want, traj_j, kf_j) = _same_features_runs(run, monkeypatch)
    assert len(got) == len(want) == len(run["seq"])
    tol = JAX_POSE_TOL[name]
    if tol is not None:
        assert got == want
        for a, b in ((traj_t, traj_j), (kf_t, kf_j)):
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(a[:, 1:4], b[:, 1:4], rtol=0, atol=tol)
        return
    states_t, states_j = [s for s, _ in got], [s for s, _ in want]
    init_t, init_j = states_t.index("OK"), states_j.index("OK")
    assert abs(init_t - init_j) <= 1, (states_t, states_j)
    start = max(init_t, init_j)
    assert states_t[start:] == states_j[start:]
    assert all(abs(a[1] - b[1]) <= 1 for a, b in zip(got, want)), (got, want)
    assert abs(len(kf_t) - len(kf_j)) <= 1
    m = min(len(traj_t), len(traj_j))
    assert m >= len(run["seq"]) - 2 and abs(len(traj_t) - len(traj_j)) <= 1
    (a_t, gt), (a_j, _) = _kitti_centres_aligned(traj_t[-m:]), _kitti_centres_aligned(traj_j[-m:])
    for a in (a_t, a_j):
        assert np.sqrt(np.mean(np.sum((a - gt) ** 2, axis=1))) < 0.05
    rms = np.sqrt(np.mean(np.sum((a_t - a_j) ** 2, axis=1)))
    assert rms < 0.02, rms


def test_runner_counts_a_keyframe_in_a_freed_slot_c18(tmp_path, monkeypatch):
    """Fault C18: the runner named a frame "keyframe" when the map's slot
    count grew, so a keyframe that took a culled keyframe's slot was counted
    as a tracked frame (its host syncs then broke the tracked frames' gate on
    the card). Here the third keyframe's allocation leaves the slot after it
    free, as a cull would, and the next keyframe takes it: every frame that
    inserted a keyframe is still of that kind."""
    from orbslam3_tpu_torch.atlas import store as st

    alloc, calls = st.MapStore.alloc_kf, []

    def alloc_leaving_a_free_slot(self):
        calls.append(self.n_kf)
        if len(calls) == 3:  # slot n_kf now, slot n_kf + 1 freed
            slot = self.n_kf
            self.n_kf += 2
            self.free_kf_slots.append(slot + 1)
            return slot
        return alloc(self)

    monkeypatch.setattr(st.MapStore, "alloc_kf", alloc_leaving_a_free_slot)
    root = tmp_path / "seq"
    root.mkdir()
    flags, _, _, _ = _kitti(root)
    with E.record_frames() as rows:
        res = run_sequence.main([str(root / "settings.yaml"), str(root), "--device", "cpu",
                                 "--sync-mapping", "--no-loop", "--out", str(tmp_path / "t.txt"),
                                 "--kf-out", str(tmp_path / "kf.txt")] + flags)
    reused = [k for k in range(1, len(rows)) if rows[k].keyframe and rows[k].n_kf == rows[k - 1].n_kf]
    assert reused, [(r.keyframe, r.n_kf) for r in rows]
    assert [k == "keyframe" for k in res["kinds"]] == [r.state == "OK" and r.keyframe
                                                        for r in rows]
