"""The port's `System` control surface around the Atlas, on the CPU: an
inertial gap after the IMU initialization ("gap_init") stores the map and
starts a new one with the Atlas, and resets without it, as the JAX
`System` does on the same state; no subsystem is left on an old map after
`_create_map`, `_do_merge`, `reset_active_map` and `load_atlas`;
localization mode (`test_system_control.py::test_localization_only_then_
reset` through the port); save, load and relocalize
(`test_atlas.py::test_system_save_load_relocalize` through the port, the
vocabulary built by the JAX package and carried over)."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import multimap_scene as MS  # noqa: E402
from test_e2e_mono import FOCAL, H, W, camera_path, make_world, render  # noqa: E402

from orbslam3_tpu_torch import convert  # noqa: E402
from orbslam3_tpu_torch.pipeline.tracking import TrackState  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

PARAMS = np.array([FOCAL, FOCAL, W / 2, H / 2, 0, 0, 0, 0], np.float32)


def _small_system(voc=None, **kw):
    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.system import Sensor, System

    slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, PARAMS, (W, H),
                  feat.OrbParams(n_features=400, n_levels=3), device="cpu", Kmax=32, Pmax=4096)
    if voc is not None:
        slam.enable_place_recognition(voc, **kw)
    return slam


def _jax_params():
    from orbslam3_tpu.ops import cameras as jcam

    return jcam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)


@pytest.mark.parametrize("atlas", [True, False])
def test_gap_init_stores_the_map_with_the_atlas(atlas):
    """A frame 2 s after the last one of an IMU-initialized tracker: with the
    Atlas the map (12 keyframes) is kept as a stored map and a fresh one is
    active; without it the active map is reset. The JAX `System` does the
    same on the same state."""
    from orbslam3_tpu.ops import cameras as jcam
    from orbslam3_tpu.ops import imu as jimu
    from orbslam3_tpu.system import Sensor as JSensor
    from orbslam3_tpu.system import System as JSystem

    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import imu
    from orbslam3_tpu_torch.pipeline import frame as fr
    from orbslam3_tpu_torch.system import Sensor, System

    calib_args = (np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    voc = MS_voc()
    port = System(Sensor.IMU_MONOCULAR, cam.CameraModel.PINHOLE, PARAMS, (W, H), device="cpu",
                  Kmax=32, Pmax=4096, imu_calib=imu.ImuCalib.create(*calib_args, device="cpu"))
    jax_ = JSystem(JSensor.IMU_MONOCULAR, jcam.CameraModel.PINHOLE, _jax_params(), (W, H),
                   Kmax=32, Pmax=4096, imu_calib=jimu.ImuCalib.create(*calib_args))
    if atlas:
        port.enable_multimap(convert.vocabulary(voc, "cpu"))
        jax_.enable_multimap(voc)
    outcome = {}
    for name, slam in (("port", port), ("jax", jax_)):
        old = slam.store
        old.n_kf = 12
        tr = slam.tracker
        tr.imu_ready = True
        tr.state = type(tr.state).OK
        tr.last_frame = fr.FrameData(features=None, timestamp=1.0, frame_id=0, R=np.eye(3),
                                     t=np.zeros(3), mp_assoc=None)
        slam.track_monocular(np.full((H, W), 35, np.uint8), 3.0)
        maps = slam.multimap.atlas.maps if atlas else [slam.store]
        outcome[name] = (len(maps), old in maps, slam.store is not old, slam.store.n_kf,
                         tr.state.name, tr.imu_ready)
    assert outcome["port"] == outcome["jax"]
    assert outcome["port"][:4] == ((2, True, True, 0) if atlas else (1, False, True, 0))


def MS_voc():
    """A small JAX vocabulary of the multi-map scene's features (the tests
    need a vocabulary, not a good one)."""
    import multimap_replay as MR

    return MR.Scene().make_vocabulary()


def _points_at(slam, store) -> list:
    """The subsystems of `slam` that still refer to `store`."""
    left = []
    if slam.store is store:
        left.append("system")
    if slam.tracker.store is store:
        left.append("tracker")
    if slam.mapper.store is store:
        left.append("mapper")
    lc = slam.loop_closer
    if lc is not None:
        if lc.store is store:
            left.append("loop closer")
        if lc.kfdb is not slam.tracker.kfdb:
            left.append("two keyframe databases")
        gba = lc.gba_async
        if gba is not None and gba.running and getattr(gba, "started_on", None) is store:
            left.append("AsyncGBA")
    mm = slam.multimap
    if mm is not None and store in mm.kfdbs and store not in mm.atlas.maps:
        left.append("multimap database")
    return left


def test_no_store_left_behind(tmp_path):
    """On the multi-map scene with place recognition and the Atlas on: after
    `_create_map` (sweep A's map stored by hand after its 14 frames), after
    `_do_merge` (sweep B merges back), after `reset_active_map` and after
    `load_atlas`, no subsystem refers to the map that was active before
    (the tracker, the mapper, the loop closer, the keyframe databases, the
    background GBA), and the loop closer's database is the tracker's."""
    slam = MS.make_system(convert.vocabulary(MS_voc(), "cpu"), place_recognition=True)
    mm = slam.multimap
    gba = slam.loop_closer.gba_async
    start = gba.start

    def started(store):  # the map of the running solve, for `_points_at`
        gba.started_on = store
        start(store)

    gba.start = started
    frames = MS.Scene().frames()
    for tag, img, ts, _ in frames:
        if tag == "A":
            slam.track_monocular(img, ts)
    assert slam.tracking_state == TrackState.OK and slam.n_keyframes > 5
    old, old_db = slam.store, slam.loop_closer.kfdb
    slam.loop_closer.gba_async.start(old)  # a background GBA of the old map
    mm._create_map()
    assert _points_at(slam, old) == [] and slam.loop_closer.kfdb is not old_db
    assert mm.atlas.n_maps == 2 and old in mm.atlas.maps
    assert not slam.loop_closer.gba_async.running
    merged_from = []
    do_merge = mm._do_merge

    def on_merge(act, target, R, t, s):
        do_merge(act, target, R, t, s)
        merged_from.append((act, _points_at(slam, act), mm.kfdbs.get(target)))

    mm._do_merge = on_merge
    for tag, img, ts, _ in frames:
        if tag == "B" and not merged_from:
            slam.track_monocular(img, ts)
    assert merged_from, "no merge"
    act, left, db = merged_from[0]
    assert left == [] and act not in mm.atlas.maps and act not in mm.kfdbs
    assert slam.loop_closer.kfdb is db is slam.tracker.kfdb
    assert slam.store is mm.atlas.active and mm.atlas.n_maps == 1
    assert slam.loop_closer.gba_async.running  # the post-merge GBA, on the merged map
    path = str(tmp_path / "atlas")
    slam.save_atlas(path)
    old = slam.store
    slam.reset_active_map()
    assert _points_at(slam, old) == [] and old not in mm.atlas.maps and old not in mm.kfdbs
    before = slam.store
    slam.load_atlas(path)
    assert _points_at(slam, before) == []
    assert slam.store is mm.atlas.active and set(mm.kfdbs) == set(mm.atlas.maps)
    assert slam.tracking_state == TrackState.LOST


def test_localization_only_then_reset(rng, tmp_path):
    """`test_system_control.py::test_localization_only_then_reset` through
    the port: localization mode tracks the last frames OK and inserts no
    keyframe; the five trajectory writers write a row per tracked frame or
    keyframe, which `load_tum` reads back; `reset_active_map` then `reset`
    clear the map and the trajectory."""
    from orbslam3_tpu_torch.io import trajectory as tio

    from orbslam3_tpu.ops import cameras as jcam

    params = jcam.make_pinhole(FOCAL, FOCAL, W / 2, H / 2)
    slam = _small_system()
    pts, shades = make_world(rng)
    poses = camera_path(12)
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)
    assert slam.tracking_state == TrackState.OK
    n_kf = slam.n_keyframes
    assert n_kf >= 2
    slam.activate_localization_mode()
    for k, (R, t) in enumerate(poses[-4:]):
        slam.track_monocular(render(params, R, t, pts, shades), 1.2 + 0.1 * k)
    assert slam.tracking_state == TrackState.OK
    assert slam.n_keyframes == n_kf, "localization mode must not insert keyframes"
    slam.deactivate_localization_mode()
    rows = {}
    for name in ("trajectory_tum", "trajectory_kitti", "trajectory_euroc",
                 "keyframe_trajectory_tum", "keyframe_trajectory_euroc"):
        path = tmp_path / f"{name}.txt"
        getattr(slam, f"save_{name}")(str(path))
        rows[name] = path.read_text().splitlines()
    n_frames = len(slam.tracker.trajectory)
    assert [len(rows[k]) for k in rows] == [n_frames] * 3 + [n_kf] * 2
    ts, pos, _ = tio.load_tum(str(tmp_path / "trajectory_tum.txt"))
    np.testing.assert_allclose(pos, slam.get_trajectory()[1], atol=1e-6)
    assert all(len(r.split()) == 12 for r in rows["trajectory_kitti"])
    slam.reset_active_map()
    assert slam.tracking_state == TrackState.NOT_INITIALIZED
    assert slam.n_keyframes == 0 and slam.n_map_points == 0
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), 2.0 + k * 0.1)
    assert slam.tracking_state == TrackState.OK and slam.n_keyframes >= 2
    slam.reset()
    assert slam.tracking_state == TrackState.NO_IMAGES_YET
    assert len(slam.tracker.trajectory) == 0


def test_system_save_load_relocalize(rng, tmp_path):
    """`test_atlas.py::test_system_save_load_relocalize` through the port:
    map 12 frames, save the Atlas, load it into a fresh `System`, and the
    mid-sequence frames relocalize into it with a post-load ATE under 8 cm;
    every loaded array equals the saved one."""
    from orbslam3_tpu.ops import bow as jbow
    from orbslam3_tpu.ops import features as jfeat

    from orbslam3_tpu_torch.ate import ate_rmse

    params = _jax_params()
    pts, shades = make_world(rng)
    poses = camera_path(12)
    orb = jfeat.OrbParams(n_features=400, n_levels=3)
    train = [np.asarray(f.desc)[np.asarray(f.valid)]
             for f in (jfeat.extract(jnp.asarray(render(params, R, t, pts, shades)), orb)
                       for R, t in poses[::4])]
    voc = convert.vocabulary(jbow.build_vocabulary(np.concatenate(train), k=8, depth=3, seed=0),
                             "cpu")
    slam = _small_system(voc, consecutive=1)
    for k, (R, t) in enumerate(poses):
        slam.track_monocular(render(params, R, t, pts, shades), k * 0.1)
    assert slam.tracking_state == TrackState.OK
    n_kf = slam.n_keyframes
    ckpt = str(tmp_path / "atlas_ckpt")
    slam.save_atlas(ckpt)
    slam2 = _small_system(voc, consecutive=1)
    slam2.load_atlas(ckpt)
    assert slam2.n_keyframes == n_kf and slam2.tracking_state == TrackState.LOST
    for a, b in zip(slam.store.state, slam2.store.state):
        assert a.dtype == b.dtype and torch.equal(a, b)
    est = []
    for k, (R, t) in list(enumerate(poses))[4:]:
        slam2.track_monocular(render(params, R, t, pts, shades), 100.0 + k * 0.1)
        if slam2.tracking_state == TrackState.OK:
            est.append((100.0 + k * 0.1, k))
    assert slam2.tracking_state == TrackState.OK, "never relocalized"
    assert len(est) >= 4
    ts_est, pos_est = slam2.get_trajectory()
    keep = ts_est >= 100.0
    gt = np.stack([-poses[k][0].T @ poses[k][1] for _, k in est])
    err = ate_rmse(ts_est[keep], pos_est[keep], np.asarray([t for t, _ in est]), gt,
                   with_scale=True, max_dt=0.01)
    assert err < 0.08, f"post-load ATE {err:.4f} m"
