"""Port parity: the stereo and RGB-D `System` end to end, against the JAX
package on the CPU, on the scene of `scripts/drive_slam_stereo.py`
(`tests/stereo_scene.py`: 320x240, 400 features on 3 levels, bf 31.2,
Kmax 32, Pmax 4096): 16 stereo frames, 10 RGB-D frames.

Both systems see the same features: the port's tracker is handed, call by
call, the features the reference extracted (its pyramid differs from the
reference's by 0-2 grey levels per level, ROADMAP C1, which
`tests/test_torch_features.py` covers). Everything after extraction is the
port's own: the scanline match or the depth lookup, initialization,
tracking with the stereo rows, the keyframe policy, the depth points and
the mapping pass. As in `tests/test_torch_system.py`, both keep map-point
slot 0 empty and keypoint 0 invalid (fault C6).

Tolerances: states, keyframe and map-point counts equal on every frame;
`kf_ur` rows within 1e-4 (-1 in the same places); `kf_mp` equal except
keyframe 0's row, where the port erases outlier observations that the
reference keeps (C6). Poses and points at the end of the run: within 1e-4
and 1e-3 for RGB-D, as `tests/test_torch_system.py` holds a frame and a
mapping pass from the same state. On the stereo run keyframe 0 loses 5
outlier observations to C6 in the port only, so the later local BAs solve
slightly different problems: keyframe poses and camera centres within
2e-3, the median point within 1e-3 m and 95% of them within 1e-2 m (the
far, weakly held points move most; all of it far inside that file's
0.02 m between whole trajectories). `local_ba` with the stereo rows is held
as `tests/test_torch_mapping.py` holds it, and `_create_depth_points` and
`_need_new_keyframe` from the reference's state at each call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.pipeline import local_mapping as lm_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.pipeline import frame as fr_t
from orbslam3_tpu_torch.pipeline import local_mapping as lm_t
from orbslam3_tpu_torch.system import Sensor, System
import stereo_scene as scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = dict(n_features=400, n_levels=3)
N_RGBD = 10


def _np_tuple(x):
    return type(x)(*(np.array(v) for v in x))


def _reference_run(sensor: str, n_frames: int):
    """The JAX System over the scene: per frame its state and counts, the
    features of every extraction in order, every keyframe decision's
    inputs and outcome, and the state around the first depth-point call."""
    left, right, depth, _ = scene.stereo_frames(n_frames)
    kind = Sensor_j.STEREO if sensor == "stereo" else Sensor_j.RGBD
    slam = System_j(kind, cam_j.CameraModel.PINHOLE, scene.PARAMS, (scene.W, scene.H),
                    orb_params=feat_j.OrbParams(**ORB), bf=scene.BF, Kmax=32, Pmax=4096)
    slam.store.alloc_mps(1)
    tr = slam.tracker
    feats, decisions, depth_pts = [], [], {}
    extract, need, create = tr._extract, tr._need_new_keyframe, tr._create_depth_points

    def _extract(img):
        f = extract(img)
        f = f._replace(valid=f.valid.at[0].set(False))
        feats.append(_np_tuple(f))
        return f

    def _need(cur, n_inl):
        out = need(cur, n_inl)
        decisions.append(dict(
            frame_id=cur.frame_id, depth=cur.depth.copy(), mp_assoc=cur.mp_assoc.copy(),
            n_inl=n_inl, ref_matches=tr._ref_matches_cache, ref_kf=tr.ref_kf,
            last_kf_frame_id=tr.last_kf_frame_id, last_reloc_frame_id=tr.last_reloc_frame_id,
            n_kf=slam.store.n_kf, free_kf=list(slam.store.free_kf_slots), out=out))
        return out

    def _create(cur, slot):
        first = not depth_pts
        if first:
            depth_pts["pre"] = (_store_snapshot(slam), slot, dict(
                features=_np_tuple(cur.features), timestamp=cur.timestamp,
                frame_id=cur.frame_id, R=cur.R.copy(), t=cur.t.copy(),
                mp_assoc=cur.mp_assoc.copy(), ur=cur.ur.copy(), depth=cur.depth.copy()))
        create(cur, slot)
        if first:
            depth_pts["post"] = (_store_snapshot(slam), cur.mp_assoc.copy())

    tr._extract, tr._need_new_keyframe, tr._create_depth_points = _extract, _need, _create
    states, n_kf, n_mp = [], [], []
    for k in range(n_frames):
        if sensor == "stereo":
            slam.track_stereo(left[k], right[k], k * 0.1)
        else:
            slam.track_rgbd(left[k], depth[k], k * 0.1)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
        n_mp.append(int(np.asarray(slam.store.state.mp_valid).sum()))
    ts, pos = slam.get_trajectory()
    return dict(states=states, n_kf=n_kf, n_mp=n_mp, feats=feats, decisions=decisions,
                depth_pts=depth_pts, final=_store_snapshot(slam), ts=ts, pos=pos,
                frames=(left, right, depth))


def _store_snapshot(slam):
    s = slam.store
    return dict(state=_np_tuple(s.state), n_kf=s.n_kf, n_mp=s.n_mp,
                free_mp=list(s.free_mp_slots), free_kf=list(s.free_kf_slots),
                kf_ts=s.kf_ts.copy(), change_index=s.change_index)


def _port_system(sensor: str, device="cpu"):
    return System(Sensor.STEREO if sensor == "stereo" else Sensor.RGBD, CameraModel.PINHOLE,
                  scene.PARAMS, (scene.W, scene.H), orb_params=feat_t.OrbParams(**ORB),
                  device=device, bf=scene.BF, Kmax=32, Pmax=4096)


def _port_run(sensor: str, ref):
    slam = _port_system(sensor)
    slam.store.alloc_mps(1)
    feats = iter(ref["feats"])
    slam.tracker._extract = lambda img: convert.to_torch(next(feats), "cpu", feat_t.Features)
    left, right, depth = ref["frames"]
    states, n_kf, n_mp = [], [], []
    for k in range(len(ref["states"])):
        if sensor == "stereo":
            slam.track_stereo(left[k], right[k], k * 0.1)
        else:
            slam.track_rgbd(left[k], depth[k], k * 0.1)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
        n_mp.append(slam.n_map_points)
    assert next(feats, None) is None  # as many extractions as the reference
    ts, pos = slam.get_trajectory()
    return dict(states=states, n_kf=n_kf, n_mp=n_mp, state=slam.store.state, ts=ts, pos=pos,
                slam=slam)


@pytest.fixture(scope="module")
def stereo_ref():
    return _reference_run("stereo", scene.N_FRAMES)


@pytest.fixture(scope="module")
def rgbd_ref():
    return _reference_run("rgbd", N_RGBD)


def _assert_runs_agree(got, ref, min_kf, pose_tol, point_tol, point_share):
    assert got["states"] == ref["states"] == ["OK"] * len(ref["states"])  # single-frame init
    assert got["n_kf"] == ref["n_kf"] and ref["n_kf"][-1] >= min_kf
    assert got["n_mp"] == ref["n_mp"]
    want, s = ref["final"]["state"], got["state"]
    kf = want.kf_valid
    np.testing.assert_array_equal(s.kf_valid.numpy(), kf)
    ur_t, ur_j = s.kf_ur.numpy()[kf], want.kf_ur[kf]
    np.testing.assert_array_equal(ur_t < 0, ur_j < 0)
    np.testing.assert_allclose(ur_t, ur_j, atol=1e-4, rtol=0)
    assert (ur_j >= 0).sum() > 100  # the keyframes carry stereo rows
    kf_mp = s.kf_mp.numpy()
    np.testing.assert_array_equal(kf_mp[1:], want.kf_mp[1:])
    differ = kf_mp[0] != want.kf_mp[0]
    assert (kf_mp[0][differ] == -1).all()  # keyframe 0: only the port's C6 erases
    np.testing.assert_array_equal(s.mp_valid.numpy(), want.mp_valid)
    np.testing.assert_allclose(s.kf_R.numpy()[kf], want.kf_R[kf], atol=pose_tol)
    np.testing.assert_allclose(s.kf_t.numpy()[kf], want.kf_t[kf], atol=pose_tol)
    v = want.mp_valid
    d_pt = np.abs(s.mp_pos.numpy()[v] - want.mp_pos[v]).max(axis=1)
    assert np.median(d_pt) <= 1e-3 and np.mean(d_pt <= point_tol) >= point_share, \
        np.sort(d_pt)[-10:]
    np.testing.assert_array_equal(got["ts"], ref["ts"])
    np.testing.assert_allclose(got["pos"], ref["pos"], atol=pose_tol)


def test_stereo_system_matches_reference(stereo_ref):
    """16 stereo frames: initialization on frame 0 from one frame, then
    tracking with the stereo rows, keyframes with depth points, mapping."""
    _assert_runs_agree(_port_run("stereo", stereo_ref), stereo_ref, min_kf=3, pose_tol=2e-3,
                       point_tol=1e-2, point_share=0.95)


def test_rgbd_system_matches_reference(rgbd_ref):
    """10 RGB-D frames: depth from the registered map (0 on the background)."""
    _assert_runs_agree(_port_run("rgbd", rgbd_ref), rgbd_ref, min_kf=2, pose_tol=1e-4,
                       point_tol=1e-3, point_share=1.0)


def test_create_depth_points_from_the_same_state(stereo_ref):
    """The first keyframe after initialization: the port's depth points from
    the reference's state and frame equal the reference's (points, rows,
    the frame's associations, the store's counts)."""
    (pre, slot, cur_np), (post, assoc) = (stereo_ref["depth_pts"]["pre"],
                                          stereo_ref["depth_pts"]["post"])
    slam = _port_system("stereo")
    _load_store(slam.store, pre)
    cur = fr_t.FrameData(**{**cur_np, "features": convert.to_torch(cur_np["features"], "cpu",
                                                                   feat_t.Features)})
    slam.tracker._create_depth_points(cur, slot)
    np.testing.assert_array_equal(cur.mp_assoc, assoc)
    assert (assoc >= 0).sum() > (cur_np["mp_assoc"] >= 0).sum() + 50
    s, want = slam.store.state, post["state"]
    np.testing.assert_array_equal(s.kf_mp.numpy(), want.kf_mp)
    np.testing.assert_array_equal(s.mp_valid.numpy(), want.mp_valid)
    v = want.mp_valid
    for k in ("mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(getattr(s, k).numpy()[v], getattr(want, k)[v], atol=1e-5)
    np.testing.assert_array_equal(s.mp_desc.numpy()[v], want.mp_desc[v])
    np.testing.assert_array_equal(s.mp_first_kf.numpy()[v], want.mp_first_kf[v])
    assert slam.store.n_mp == post["n_mp"]


def _load_store(store: st_t.MapStore, snap):
    store.state = convert.to_torch(snap["state"], store.device, st_t.MapState)
    store.n_kf, store.n_mp = snap["n_kf"], snap["n_mp"]
    store.free_mp_slots, store.free_kf_slots = list(snap["free_mp"]), list(snap["free_kf"])
    store.kf_ts = snap["kf_ts"].copy()
    store.change_index = snap["change_index"]


@pytest.mark.parametrize("mapper", ["idle", "busy, queue 0", "busy, queue 3"])
def test_need_new_keyframe_from_the_same_inputs(stereo_ref, mapper):
    """Every keyframe decision of the stereo run, and each again with every
    association dropped (the close-point census then asks for a keyframe):
    the port decides as the reference, with an idle mapper and with a busy
    one (a stereo-like sensor queues while fewer than 3 keyframes wait)."""
    from orbslam3_tpu.pipeline.tracking import Tracker as Tracker_j

    slam = _port_system("stereo")
    tr_t = slam.tracker
    tr_j = Tracker_j(cam_j.CameraModel.PINHOLE, jnp.asarray(scene.PARAMS), (scene.W, scene.H),
                     System_j(Sensor_j.STEREO, cam_j.CameraModel.PINHOLE, scene.PARAMS,
                              (scene.W, scene.H), bf=scene.BF, Kmax=32, Pmax=64).store,
                     feat_j.OrbParams(**ORB), bf=scene.BF)
    tr_j.is_stereo_like = True
    if mapper != "idle":
        q = int(mapper[-1])
        for tr in (tr_j, tr_t):
            tr.mapper_idle_query = lambda: False
            tr.mapping_queue_len = lambda q=q: q
    outs = []
    for d in stereo_ref["decisions"]:
        for drop in (False, True):
            assoc = np.full_like(d["mp_assoc"], -1) if drop else d["mp_assoc"]
            got = []
            for tr in (tr_j, tr_t):
                tr.store.n_kf, tr.store.free_kf_slots = d["n_kf"], list(d["free_kf"])
                tr.ref_kf, tr.last_kf_frame_id = d["ref_kf"], d["last_kf_frame_id"]
                tr.last_reloc_frame_id = d["last_reloc_frame_id"]
                cur = fr_t.FrameData(features=None, timestamp=0.0, frame_id=d["frame_id"],
                                     R=np.eye(3), t=np.zeros(3), mp_assoc=assoc, ur=None,
                                     depth=d["depth"])
                if tr is tr_j:
                    tr._ref_matches_cache = d["ref_matches"]
                    got.append(tr._need_new_keyframe(cur, d["n_inl"]))
                else:
                    got.append(tr._need_new_keyframe(cur, d["n_inl"], d["ref_matches"]))
            assert got[0] == got[1], (d["frame_id"], drop, got)
            if mapper == "idle" and not drop:
                assert got[0] == d["out"]
            outs.append(got[0])
    assert any(outs) and not all(outs) if mapper != "busy, queue 3" else not any(outs)


MAP_CFG = E.MappingConfig(Kmax=16, Pmax=2048, Nf=768, n_kf=12, n_mp=1500, n_nb=3, n_cand=256,
                          n_window=6, n_fixed=4, n_fixed_valid=3, iters=5)
BF_EUROC = E.EUROC_STEREO["bf"]


def _stereo_mapping_scene():
    """`tests/test_torch_mapping.py`'s map (`entry.make_mapping_scene`: a
    consistent map, keyframes moved 4 mm and points 1 cm) with stereo rows:
    4 of 5 observations carry the right u of the true geometry at the
    EuRoC bf, with 0.5 px of noise."""
    sc = E.make_mapping_scene(MAP_CFG)
    true = E._synth_map(np.random.default_rng(1), Kmax=MAP_CFG.Kmax, Pmax=MAP_CFG.Pmax,
                        Nf=MAP_CFG.Nf, n_kf=MAP_CFG.n_kf, n_mp=MAP_CFG.n_mp, consistent=True)
    rng = np.random.default_rng(2)
    kf_ur = np.full(true.kf_ur.shape, -1.0, np.float32)
    for k in range(MAP_CFG.n_kf):
        obs = np.flatnonzero((true.kf_mp[k] >= 0) & (rng.random(MAP_CFG.Nf) < 0.8))
        z = (true.mp_pos[true.kf_mp[k, obs]] @ true.kf_R[k].T + true.kf_t[k])[:, 2]
        kf_ur[k, obs] = true.kf_uv[k, obs, 0] - BF_EUROC / z + rng.normal(0, 0.5, len(obs))
    return sc._replace(state=sc.state._replace(kf_ur=kf_ur))


@pytest.mark.parametrize("obs_cap", [768, 500])
def test_local_ba_with_stereo_rows(obs_cap):
    """`local_ba(bf, obs_cap)` on a map with stereo rows, every observation
    kept (`obs_cap` = Nf, as the mapper calls it for a stereo-like sensor)
    and a 500-slot cap, against the reference's: the tolerances of
    `tests/test_torch_mapping.py` (cost within 1e-3 relative, poses within
    1e-4, points within 1e-3, `n_bad` equal, `kf_mp` equal except keyframe
    0's row, C6)."""
    sc = _stereo_mapping_scene()
    s_np = sc.state
    assert (s_np.kf_ur >= 0).sum() > 3000
    orb = feat_j.OrbParams(n_features=1024, n_levels=8)
    args = (sc.window_ids, sc.fixed_ids)
    new_j, cost_j, bad_j = lm_j.local_ba(
        cam_j.CameraModel.PINHOLE, cam_j.make_pinhole(458.654, 457.296, 376.0, 240.0),
        type(s_np)(*(jnp.asarray(x) for x in s_np)), *(jnp.asarray(a) for a in args),
        jnp.asarray(feat_j.sigma2(orb)), bf=BF_EUROC, iters=MAP_CFG.iters, obs_cap=obs_cap)
    c = E._consts(E.EUROC, "cpu")
    new_t, cost_t, bad_t = lm_t.local_ba(
        c.model, c.params, convert.to_torch(s_np, "cpu", st_t.MapState),
        *(torch.from_numpy(a) for a in args), c.sigma2, bf=BF_EUROC, iters=MAP_CFG.iters,
        obs_cap=obs_cap)
    new_j = type(s_np)(*(np.asarray(x) for x in new_j))
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-3)
    assert int(bad_t) == int(bad_j)
    np.testing.assert_array_equal(new_t.kf_mp.numpy()[1:], new_j.kf_mp[1:])
    np.testing.assert_allclose(new_t.kf_R.numpy(), new_j.kf_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(new_t.kf_t.numpy(), new_j.kf_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(new_t.mp_pos.numpy(), new_j.mp_pos, rtol=0, atol=1e-3)
    assert np.abs(new_j.kf_t - s_np.kf_t).max() > 1e-4  # the solve moved the window
    # The stereo rows take part: the same map without them solves differently.
    mono = lm_t.local_ba(
        c.model, c.params, convert.to_torch(s_np._replace(kf_ur=np.full_like(s_np.kf_ur, -1.0)),
                                            "cpu", st_t.MapState),
        *(torch.from_numpy(a) for a in args), c.sigma2, bf=BF_EUROC, iters=MAP_CFG.iters,
        obs_cap=obs_cap)[0]
    assert np.abs(mono.kf_t.numpy() - new_j.kf_t).max() > 1e-4


def test_stereo_and_rgbd_take_the_card_unless_asked_for_the_cpu(monkeypatch):
    """`System(STEREO)` and `System(RGBD)` without a device take the first
    CUDA card and raise where there is none, and so do a two-camera rig
    (`camera2`, a Kannala-Brandt 8 pair) and IMU_STEREO (the stereo-inertial
    parity: `tests/test_torch_stereo_vi_system.py`); asked for the CPU they
    are built there, the rig with its right camera's extrinsics; a rig is a
    stereo sensor; the CPU runs a frame when asked for."""
    from orbslam3_tpu_torch.ops.imu import ImuCalib

    left, right, depth, _ = scene.stereo_frames(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Tlr = np.eye(4)
    Tlr[0, 3] = 0.12
    kb8 = np.array([160.0, 160.0, 160.0, 120.0, 0.0035, 0.0007, -0.002, 0.0002], np.float32)
    calib = ImuCalib.create(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0,
                           device="cpu")
    rig = dict(camera2=(kb8, Tlr, None, (10.0, 300.0)))
    builds = [(Sensor.STEREO, CameraModel.KB8, rig), (Sensor.IMU_STEREO, CameraModel.PINHOLE,
                                                       dict(bf=scene.BF, imu_calib=calib)),
              (Sensor.IMU_STEREO, CameraModel.KB8, dict(rig, imu_calib=calib))]
    for sensor in ("stereo", "rgbd"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _port_system(sensor, device=None)
    for sensor, model, kw in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            System(sensor, model, kb8, (scene.W, scene.H), **kw)
        s = System(sensor, model, kb8, (scene.W, scene.H), device="cpu", **kw)
        assert s.device.type == "cpu" and s.tracker.is_stereo_like and s.mapper.stereo_like
        assert (s.tracker.camera2 is not None) == ("camera2" in kw)
    c2 = s.tracker.camera2
    assert c2["lap1"] == (0.0, scene.W - 1.0) and c2["lap2"] == (10.0, 300.0)
    np.testing.assert_allclose(c2["t_rl"].numpy(), [-0.12, 0.0, 0.0])
    assert c2["baseline"] == pytest.approx(0.12) and not s.mapper.imu_init.mono
    with pytest.raises(ValueError, match="stereo sensor"):
        System(Sensor.MONOCULAR, CameraModel.KB8, kb8, (scene.W, scene.H), device="cpu", **rig)
    slam = _port_system("stereo")
    with pytest.raises(ValueError):
        slam.track_rgbd(left[0], depth[0], 0.0)
    slam.track_stereo(left[0], right[0], 0.0)
    assert slam.device.type == "cpu" and slam.n_keyframes == 1 and slam.n_map_points > 100


@pytest.mark.parametrize("sensor", ["rgbd", "raw_stereo"])
def test_replay_on_the_cpu(sensor):
    """`entry.replay` of the synthetic EuRoC sequence at full width, 2
    frames (the rectified pair runs in the stereo test above): initialized
    on frame 0 from one frame, and the first step metric: within 1 cm of
    the true 23 mm (a monocular map has no scale to compare)."""
    rep = E.replay("cpu", sensor, 2)
    assert rep.states == ["OK", "OK"] and rep.n_kf == 1 and rep.n_mp > 500
    assert rep.syncs == [None, None] and rep.pos.shape == (2, 3)
    step, true = (np.linalg.norm(np.diff(x, axis=0)) for x in (rep.pos, rep.gt_pos))
    assert abs(step - true) < 0.01, (step, true)
