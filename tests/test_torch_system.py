"""Port parity: the monocular `System` end to end, against the JAX package on
the CPU, on the 12-frame scene of `tests/test_e2e_mono.py` (320x240, 400
features on 3 levels, Kmax 32, Pmax 4096).

One module-scoped JAX run serves every case; it also snapshots the map and
the tracker before frame 6 and around keyframe 4's mapping pass, so that
`Tracker._track` and `LocalMapper.process_keyframe` are compared from the
same state. After the 12 frames both systems take one more, frame 5 again
with a timestamp (0.35 s) before the last frame's: the reordered frame that
resets the active map (`tests/test_system_control.py`); every other case
reads its numbers before it.

Both systems run with map-point slot 0 left empty and keypoint 0 of every
frame marked invalid. That keeps ROADMAP fault C6 out of the comparison:
the reference drops a valid write into keypoint 0 or point 0 whenever a
padded row clips onto it, and the port does not
(`test_torch_store.py::test_replace_points_c6_point_zero` shows the
difference). The third form of C6 cannot be kept out: while the local BA's
fixed list is padded, the reference never erases an outlier observation of
keyframe 0 (`test_torch_mapping.py::test_c6_keyframe0_outlier_is_erased`).
Tolerances:

* `_track` and `process_keyframe` from the same state: `kf_mp` and
  `mp_valid` equal, the same keyframe decision; poses within 1e-4, points
  within 1e-3. After the mapping pass, `kf_mp` may differ only in keyframe
  0's row, where the port erased an outlier observation (C6);
* the whole slice: initialization within one frame of the reference's (the
  two samplers draw differently), the same TrackState on every frame after
  both initialized, keyframe counts within 1, both Sim3 ATEs under 0.05 m,
  and the two Sim3-aligned trajectories within 0.02 m RMS of each other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from orbslam3_tpu.eval import ate as ate_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.system import Sensor as Sensor_j
from orbslam3_tpu.system import System as System_j
from orbslam3_tpu_torch import ate as ate_t
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.pipeline import frame as fr_t
from orbslam3_tpu_torch.pipeline.tracking import TrackState
from orbslam3_tpu_torch.system import Sensor, System
import test_e2e_mono as scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

N_FRAMES = 12
TRACK_FRAME = 6  # `_track` is compared on this frame
MAP_KF = 4  # the keyframe whose mapping pass is compared (inserted by frame 6)
ORB = dict(n_features=400, n_levels=3)
REORDER = (5, 0.35)  # frame 5's image again, at a timestamp before frame 11's


def _frames():
    params = cam_j.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2)
    pts, shades = scene.make_world(np.random.default_rng(0))
    poses = scene.camera_path(N_FRAMES)
    imgs = [scene.render(params, R, t, pts, shades) for R, t in poses]
    gt = np.stack([-R.T @ t for R, t in poses])
    return np.asarray(params), imgs, gt


def _store_snapshot(slam):
    s = slam.store
    return dict(state=type(s.state)(*(np.array(x) for x in s.state)), n_kf=s.n_kf, n_mp=s.n_mp,
                free_mp=list(s.free_mp_slots), free_kf=list(s.free_kf_slots),
                kf_ts=s.kf_ts.copy(), change_index=s.change_index,
                recent_mp=[(b, x.copy()) for b, x in slam.mapper.recent_mp])


def _tracker_snapshot(tr):
    lf = tr.last_frame
    return dict(state=tr.state.name, ref_kf=tr.ref_kf, last_kf_id=tr.last_kf_id,
                velocity=tuple(np.array(v) for v in tr.velocity), frame_id=tr.frame_id,
                last_kf_frame_id=tr.last_kf_frame_id,
                last_reloc_frame_id=tr.last_reloc_frame_id,
                last=dict(features=type(lf.features)(*(np.array(x) for x in lf.features)),
                          timestamp=lf.timestamp, frame_id=lf.frame_id, R=np.array(lf.R),
                          t=np.array(lf.t), mp_assoc=np.array(lf.mp_assoc)))


@pytest.fixture(scope="module")
def ref():
    return _reference_run()


def _avoid_c6_j(slam):
    """Point slot 0 stays empty and keypoint 0 invalid (module docstring)."""
    slam.store.alloc_mps(1)
    extract = slam.tracker._extract

    def _extract(img):
        f = extract(img)
        return f._replace(valid=f.valid.at[0].set(False))

    slam.tracker._extract = _extract


def _avoid_c6_t(slam):
    slam.store.alloc_mps(1)
    extract = slam.tracker._extract

    def _extract(img):
        f = extract(img)
        valid = f.valid.clone()
        valid[0] = False
        return f._replace(valid=valid)

    slam.tracker._extract = _extract


def _reference_run():
    """The JAX System over the scene, with snapshots."""
    params, imgs, gt = _frames()
    slam = System_j(Sensor_j.MONOCULAR, cam_j.CameraModel.PINHOLE, params,
                    (scene.W, scene.H), orb_params=feat_j.OrbParams(**ORB), Kmax=32, Pmax=4096)
    _avoid_c6_j(slam)
    snaps = {}
    mapper_pass = slam.mapper.process_keyframe

    def process_keyframe(slot, initial=False, preint=None):
        if slot == MAP_KF and not initial:
            snaps["pre_map"] = _store_snapshot(slam)
        mapper_pass(slot, initial=initial, preint=preint)
        if slot == MAP_KF and not initial:
            snaps["post_map"] = _store_snapshot(slam)

    slam.mapper.process_keyframe = process_keyframe
    extract = slam.tracker._extract  # keypoint 0 already invalid
    states, n_kf = [], []
    for k, img in enumerate(imgs):
        if k == TRACK_FRAME:
            snaps["pre_track"] = (_store_snapshot(slam), _tracker_snapshot(slam.tracker))
            f = extract(img)
            snaps["features"] = type(f)(*(np.array(x) for x in f))
        slam.track_monocular(img, k * 0.1)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
    ts, pos = slam.get_trajectory()
    return dict(params=params, imgs=imgs, gt=gt, states=states, n_kf=n_kf, ts=ts, pos=pos,
                snaps=snaps, reorder=_reorder(slam, imgs))


def _reorder(slam, imgs):
    """Track the reordered frame; what the system looks like after it."""
    k, t = REORDER
    n_kf = slam.n_keyframes
    slam.track_monocular(imgs[k], t)
    return dict(n_kf_before=n_kf, n_kf=slam.n_keyframes, state=slam.tracking_state.name,
                n_traj=len(slam.get_trajectory()[0]))


def _port_system(params, device="cpu"):
    return System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(**ORB), device=device, Kmax=32, Pmax=4096)


@pytest.fixture(scope="module")
def port(ref):
    """The port's System over the same frames, then the reordered frame."""
    slam = _port_system(ref["params"])
    _avoid_c6_t(slam)
    states, n_kf = [], []
    for k, img in enumerate(ref["imgs"]):
        slam.track_monocular(img, k * 0.1)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
    ts, pos = slam.get_trajectory()
    return dict(states=states, n_kf=n_kf, ts=ts, pos=pos, n_mp=slam.n_map_points,
                reorder=_reorder(slam, ref["imgs"]))


def _load_store(store: st_t.MapStore, snap, mapper=None):
    store.state = convert.to_torch(snap["state"], store.device, st_t.MapState)
    store.n_kf, store.n_mp = snap["n_kf"], snap["n_mp"]
    store.free_mp_slots, store.free_kf_slots = list(snap["free_mp"]), list(snap["free_kf"])
    store.kf_ts = snap["kf_ts"].copy()
    store.change_index = snap["change_index"]
    if mapper is not None:
        mapper.recent_mp = [(b, x.copy()) for b, x in snap["recent_mp"]]


def _features_t(f_np):
    return convert.to_torch(f_np, "cpu", feat_t.Features)


def _assert_map_agrees(got: st_t.MapState, ref_np, kf0_erases: int = 0):
    """Equal maps; up to `kf0_erases` observations of keyframe 0 that the
    port erased as outliers and the reference kept (C6)."""
    kf_mp = got.kf_mp.numpy()
    differ = kf_mp != ref_np.kf_mp
    erased0 = differ[0] & (kf_mp[0] == -1)
    assert erased0.sum() <= kf0_erases
    differ[0] &= ~erased0
    assert not differ.any(), np.argwhere(differ)
    np.testing.assert_array_equal(got.mp_valid.numpy(), ref_np.mp_valid)
    np.testing.assert_array_equal(got.kf_valid.numpy(), ref_np.kf_valid)
    np.testing.assert_allclose(got.kf_R.numpy(), ref_np.kf_R, atol=1e-4)
    np.testing.assert_allclose(got.kf_t.numpy(), ref_np.kf_t, atol=1e-4)
    v = ref_np.mp_valid
    np.testing.assert_allclose(got.mp_pos.numpy()[v], ref_np.mp_pos[v], atol=1e-3)


def test_track_from_the_same_state(ref):
    """`Tracker._track` on frame 6 from the reference's state before it,
    with the reference's features of that frame: the same pose, the same
    associations and the same keyframe (slot 4, its mapping pass off)."""
    store_snap, tr_snap = ref["snaps"]["pre_track"]
    post = ref["snaps"]["pre_map"]["state"]  # the reference right after inserting keyframe 4
    slam = _port_system(ref["params"])
    _load_store(slam.store, store_snap)
    tr = slam.tracker
    tr.new_kf_callback = None
    tr.state = TrackState[tr_snap["state"]]
    for k in ("ref_kf", "last_kf_id", "velocity", "frame_id", "last_kf_frame_id",
              "last_reloc_frame_id"):
        setattr(tr, k, tr_snap[k])
    last = tr_snap["last"]
    tr.last_frame = fr_t.FrameData(**{**last, "features": _features_t(last["features"])})
    cur = fr_t.FrameData(features=_features_t(ref["snaps"]["features"]), timestamp=0.6,
                         frame_id=TRACK_FRAME, R=np.eye(3, dtype=np.float32),
                         t=np.zeros(3, np.float32), mp_assoc=np.full(400, -1, np.int32))
    assert tr._track(cur)
    assert tr.last_kf_id == MAP_KF and tr.last_kf_frame_id == TRACK_FRAME  # keyframe inserted
    assert slam.store.n_kf == MAP_KF + 1
    np.testing.assert_allclose(cur.R, post.kf_R[MAP_KF], atol=1e-4)
    np.testing.assert_allclose(cur.t, post.kf_t[MAP_KF], atol=1e-4)
    _assert_map_agrees(slam.store.state, post)
    np.testing.assert_array_equal(slam.store.state.mp_found.numpy(), post.mp_found)
    np.testing.assert_array_equal(slam.store.state.mp_visible.numpy(), post.mp_visible)


def test_process_keyframe_from_the_same_state(ref):
    """One whole mapping pass of keyframe 4 from the reference's state (map,
    store host fields, the mapper's recent points): the same map after it."""
    pre, post = ref["snaps"]["pre_map"], ref["snaps"]["post_map"]
    slam = _port_system(ref["params"])
    _load_store(slam.store, pre, slam.mapper)
    slam.mapper.tracker = None  # no trajectory here to re-root
    slam.mapper.process_keyframe(MAP_KF)
    _assert_map_agrees(slam.store.state, post["state"], kf0_erases=2)
    assert slam.store.free_mp_slots == post["free_mp"]
    assert slam.store.free_kf_slots == post["free_kf"]
    assert slam.store.n_mp == post["n_mp"]
    assert [(b, x.tolist()) for b, x in slam.mapper.recent_mp] == \
        [(b, x.tolist()) for b, x in post["recent_mp"]]
    assert slam.store.n_mp > pre["n_mp"]  # the pass triangulated new points


def _aligned(ts, pos, gt_ts, gt):
    ia, ib = ate_j.associate(ts, gt_ts, 0.01)
    s, R, t = ate_j.umeyama(pos[ia], gt[ib], True)
    return {round(float(ts[i]), 6): s * R @ pos[i] + t for i in ia}


def test_system_matches_reference(ref, port):
    """The port's System and the reference's on the whole scene. Both
    initialize on frame 1 (the reference frame is frame 0) on this scene."""
    states, n_kf = port["states"], port["n_kf"]
    init_p = states.index("OK")
    init_r = ref["states"].index("OK")
    assert abs(init_p - init_r) <= 1, (states, ref["states"])
    start = max(init_p, init_r)
    assert states[start:] == ref["states"][start:]
    assert all(abs(a - b) <= 1 for a, b in zip(n_kf, ref["n_kf"])), (n_kf, ref["n_kf"])
    gt_ts = np.arange(N_FRAMES) * 0.1
    ts, pos = port["ts"], port["pos"]
    assert np.isfinite(pos).all() and pos.shape == (len(ts), 3)
    err_p = ate_j.ate_rmse(ts, pos, gt_ts, ref["gt"], with_scale=True, max_dt=0.01)
    err_r = ate_j.ate_rmse(ref["ts"], ref["pos"], gt_ts, ref["gt"], with_scale=True, max_dt=0.01)
    assert err_p < 0.05 and err_r < 0.05, (err_p, err_r)
    a_p = _aligned(ts, pos, gt_ts, ref["gt"])
    a_r = _aligned(ref["ts"], ref["pos"], gt_ts, ref["gt"])
    common = sorted(set(a_p) & set(a_r))
    assert len(common) >= N_FRAMES - 2
    rms = np.sqrt(np.mean([np.sum((a_p[t] - a_r[t]) ** 2) for t in common]))
    assert rms < 0.02, rms
    assert port["n_mp"] > 50


def test_timestamp_reorder_resets_active_map(ref, port):
    """A frame whose timestamp goes back (frame 5 again at 0.35 s, after
    frame 11 at 1.1 s) resets the active map in both systems
    (`Tracking.cc:987-996`), and then goes on as the first frame of a new
    map: the same state after it, at most one keyframe, and the same
    trajectory length (the old map's entries are gone)."""
    got, want = port["reorder"], ref["reorder"]
    assert want["n_kf_before"] >= 2 and got["n_kf_before"] >= 2
    assert got["n_kf"] <= 1 and want["n_kf"] <= 1
    assert got["state"] == want["state"]
    assert got["n_traj"] == want["n_traj"]


def test_tracker_reports_a_reorder_exactly_when_time_goes_back():
    """`Tracker` calls `anomaly_cb("reorder")` for a frame older than the
    last one, never for a later or equal timestamp, and never before a
    first frame; the frame then goes on through the normal path."""
    params, imgs, _ = _frames()
    slam = _port_system(params)
    tr = slam.tracker
    calls, seen = [], []
    tr.anomaly_cb = calls.append
    tr._initialize_mono = lambda cur: seen.append(cur.timestamp)  # the normal path, stubbed
    f = tr._extract(imgs[0])
    for t in (0.5, 0.7, 0.7, 0.6, 0.65, 0.2, 1.0, 1.0 - 1e-9):
        n = len(calls)
        tr._process_with_features(f, t)
        back = tr.frame_id > 1 and t < prev
        assert calls[n:] == (["reorder"] if back else []), (t, calls)
        prev = t
    assert seen == [0.5, 0.7, 0.7, 0.6, 0.65, 0.2, 1.0, 1.0 - 1e-9]
    assert calls == ["reorder"] * 3


def test_ate_equals_reference():
    """The port's numpy ATE (`orbslam3_tpu_torch/ate.py`) equals the
    reference's on a noisy, scaled, rotated trajectory with gaps."""
    rng = np.random.default_rng(0)
    gt_ts = np.arange(50) * 0.05
    gt = np.stack([np.cos(gt_ts), np.sin(gt_ts), 0.1 * gt_ts], -1)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    ts = gt_ts[::2] + 0.001
    est = 0.4 * gt[::2] @ R.T + [1, 2, 3] + rng.normal(0, 0.01, (25, 3))
    for scale in (True, False):
        assert ate_t.ate_rmse(ts, est, gt_ts, gt, scale, 0.01) == \
            ate_j.ate_rmse(ts, est, gt_ts, gt, scale, 0.01)


def test_mono_replay_initializes_on_the_cpu():
    """The EuRoC replay's entry point on the CPU, 5 frames: it renders the
    script's frames, initializes and tracks (counts of syncs only on CUDA)."""
    rep = E.mono_replay("cpu", 5)
    assert rep.states[:3] == ["NOT_INITIALIZED"] * 3 and rep.states[3:] == ["OK", "OK"]
    assert rep.keyframe[3] and rep.syncs == [None] * 5
    assert rep.gt_pos.shape == (5, 3) and rep.pos.shape == (len(rep.ts), 3)
    assert rep.n_kf >= 2 and rep.n_mp > 200 and rep.ate < 0.05


def test_system_takes_the_card_unless_asked_for_the_cpu(monkeypatch):
    """`System` (and its `MapStore`) without a device take the first CUDA
    card and raise where there is none, never falling back to the CPU; with
    `device="cpu"` the System runs a frame on the CPU."""
    params, imgs, _ = _frames()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, (scene.W, scene.H),
               orb_params=feat_t.OrbParams(**ORB), Kmax=32, Pmax=4096)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st_t.MapStore(Kmax=8, Pmax=64, Nf=16)
    slam = _port_system(params, device="cpu")
    slam.track_monocular(imgs[0], 0.0)
    assert slam.device.type == "cpu" and slam.store.state.kf_R.device.type == "cpu"
    assert slam.tracking_state == TrackState.NOT_INITIALIZED


def test_port_imports_no_jax():
    """Importing the System, the entry points and the kernel bench (and
    loading the synthetic sequence's script) leaves JAX and the JAX package
    out of the process."""
    code = ("import sys, orbslam3_tpu_torch.system, orbslam3_tpu_torch.entry as E, "
            "orbslam3_tpu_torch.kernel_bench; "
            "E.synth_euroc(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'orbslam3_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=300)
