"""The port's inertial merge against the JAX package on the CPU: the Atlas's
IMU state across a map switch (`MultiMapManager._create_map` past the IMU
initialization), `_do_merge` as a whole on an IMU_MONOCULAR `System` whose
two maps are IMU-initialized (the preintegrations re-keyed, the trajectory
re-rooted, the last frame moved, the weld fuse, the 16-keyframe inertial
weld BA, the 4-DoF essential graph, the post-merge GBA), and `_try_merge`'s
IMU_STEREO branch (the scale fixed, the rotation gated to yaw).

Tolerances: keys, slots and integer tables exact; poses, velocities, biases
and points within 1e-4; the world Sim3 within 1e-4."""

from __future__ import annotations

import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from orbslam3_tpu.ops import bow as jbow  # noqa: E402
from orbslam3_tpu.ops import cameras as jcam  # noqa: E402
from orbslam3_tpu.ops import imu as jimu  # noqa: E402
from orbslam3_tpu.ops import lie as jlie  # noqa: E402
from orbslam3_tpu.system import Sensor as JSensor  # noqa: E402
from orbslam3_tpu.system import System as JSystem  # noqa: E402
from test_torch_atlas import _weld_pair, to_port  # noqa: E402

from orbslam3_tpu_torch import convert  # noqa: E402
from orbslam3_tpu_torch.ops import cameras as cam  # noqa: E402
from orbslam3_tpu_torch.ops import imu  # noqa: E402
from orbslam3_tpu_torch.system import Sensor, System  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

CALIB = (np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
PARAMS = [400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0]
WH = (640, 480)
FLOATS = ("kf_R", "kf_t", "kf_vel", "kf_bias_g", "kf_bias_a", "mp_pos")


def _voc():
    return jbow.build_vocabulary(np.random.default_rng(0).integers(0, 256, (64, 32), np.uint8),
                                 k=2, depth=2, seed=0)


def _systems(sensor: str, **kw):
    """(the JAX System, the port's on the CPU) of `sensor` ("IMU_MONOCULAR" or
    "IMU_STEREO") at the test's camera, with the Atlas on the same
    vocabulary."""
    voc = _voc()
    jsys = JSystem(getattr(JSensor, sensor), jcam.CameraModel.PINHOLE, np.float32(PARAMS), WH,
                   imu_calib=jimu.ImuCalib.create(*CALIB), **kw)
    psys = System(getattr(Sensor, sensor), cam.CameraModel.PINHOLE, PARAMS, WH, device="cpu",
                  imu_calib=imu.ImuCalib.create(*CALIB, device="cpu"), **kw)
    jsys.enable_multimap(voc)
    psys.enable_multimap(convert.vocabulary(voc, "cpu"))
    return jsys, psys


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_create_map_resets_the_imu_state_as_jax():
    """`_create_map` on an IMU_MONOCULAR System past its IMU initialization
    (VIBA1 done, a motion model, a preintegration from the last keyframe, a
    frame prior, stored preintegrations): the map is stored and the
    tracker's and the mapper's IMU state after the switch equal JAX's: IMU
    not ready, no velocity, no preintegration from a keyframe, no frame
    prior, no preintegrations, a fresh `ImuInitializer` (not initialized, no
    VIBA), the body velocity and biases carried as JAX carries them, the
    tracker NOT_INITIALIZED with no reference keyframe."""
    jsys, psys = _systems("IMU_MONOCULAR", Kmax=32, Pmax=1024)
    target, _, _, pres, _ = _weld_pair()
    out = {}
    for name, sysm in (("jax", jsys), ("port", psys)):
        port = name == "port"
        store = to_port(target) if port else target
        if port:
            sysm._point_at(store)
        else:
            sysm.store = sysm.tracker.store = sysm.mapper.store = store
        mm = sysm.multimap
        mm.atlas.maps = [store]
        tr, mp = sysm.tracker, sysm.mapper
        old_init = mp.imu_init
        old_init.initialized = old_init.viba1_done = True
        tr.imu_ready = True
        tr.velocity = (np.eye(3, dtype=np.float32), np.array([0.1, 0.0, 0.0], np.float32))
        tr.body_vel = np.array([0.3, -0.2, 0.1], np.float32)
        tr.bias_g = np.array([1e-3, 2e-3, -1e-3], np.float32)
        tr.bias_a = np.array([1e-2, 0.0, -2e-2], np.float32)
        pre = convert.preintegrated(pres[0], "cpu") if port else pres[0]
        tr.pre_from_kf = pre
        tr.frame_prior = object()
        tr.ref_kf = tr.last_kf_id = 11
        mp.preints = {k: pre for k in range(1, 12)}
        mm._create_map()
        out[name] = dict(
            n_maps=mm.atlas.n_maps, stored=mm.atlas.maps[0] is store,
            active=mm.atlas.maps.index(sysm.store), fresh=sysm.store is not store,
            n_kf=sysm.store.n_kf, same_store=(tr.store is sysm.store and mp.store is sysm.store),
            state=tr.state.name, ref_kf=tr.ref_kf, last_kf_id=tr.last_kf_id,
            imu_ready=tr.imu_ready, velocity=tr.velocity, pre_from_kf=tr.pre_from_kf,
            frame_prior=tr.frame_prior, preints=dict(mp.preints),
            new_init=mp.imu_init is not old_init,
            init=(mp.imu_init.initialized, mp.imu_init.viba1_done, mp.imu_init.viba2_done),
            body_vel=np.asarray(tr.body_vel), bias=(np.asarray(tr.bias_g), np.asarray(tr.bias_a)),
            bad_imu=mp.bad_imu, recent=list(mp.recent_mp))
    j, p = out["jax"], out["port"]
    assert j["n_maps"] == 2 and j["stored"] and j["fresh"] and j["new_init"]
    for key in ("n_maps", "stored", "active", "fresh", "n_kf", "same_store", "state", "ref_kf",
                "last_kf_id", "imu_ready", "velocity", "pre_from_kf", "frame_prior", "preints",
                "new_init", "init", "bad_imu", "recent"):
        assert p[key] == j[key], key
    np.testing.assert_array_equal(p["body_vel"], j["body_vel"])
    for a, b in zip(p["bias"], j["bias"]):
        np.testing.assert_array_equal(a, b)


def _merge_setup(sysm, target, source, pres, port: bool):
    """Point `sysm` at `source` as the active map with `target` stored: the
    tracker past its IMU initialization on the source's last keyframe, a
    trajectory over both maps and the current frame's entry, the mapper's
    preintegrations keyed by the source's slots (and one stale key)."""
    if port:
        sysm._point_at(source)
    else:
        sysm.store = sysm.tracker.store = sysm.mapper.store = source
    mm = sysm.multimap
    mm.atlas.maps = [target, source]
    mm.atlas.active_idx = 1
    mm.post_merge_gba = True
    # The keyframe databases of both maps hold their keyframes.
    for store in (target, source):
        s = store.state
        for k in range(store.n_kf):
            mm._kfdb(store).add(k, s.kf_desc[k], s.kf_feat_valid[k])
    tr, mp = sysm.tracker, sysm.mapper
    mp.imu_init.initialized = True
    tr.imu_ready = True
    pre = (lambda p: convert.preintegrated(p, "cpu")) if port else (lambda p: p)
    # Source slot i is keyframe 12 + i of the chain; its edge from 11 + i.
    mp.preints = {i: pre(pres[11 + i]) for i in range(1, 12)}
    mp.preints[20] = pre(pres[0])  # a key that is no source keyframe: dropped by the merge
    tr.ref_kf, tr.last_kf_id = 11, 10
    tr.velocity = (np.eye(3, dtype=np.float32), np.array([0.05, 0.0, 0.0], np.float32))
    tr.body_vel = np.array([0.4, 0.1, -0.05], np.float32)
    rng = np.random.default_rng(3)
    traj = []
    for n in range(8):  # entries of both maps, relative poses of small motions
        store, ref = (target, n) if n < 4 else (source, 4 + n)
        R_cr = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)))
        traj.append((0.1 * n, store, ref, R_cr, rng.normal(0, 0.1, 3).astype(np.float32)))
    s = source.state
    R_l, t_l = _np(s.kf_R[11]), _np(s.kf_t[11]) + np.float32([0.01, 0.0, -0.02])
    traj.append((5.0, source, 11, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)))
    tr.trajectory = traj
    tr.last_frame = types.SimpleNamespace(R=R_l.astype(np.float32), t=t_l.astype(np.float32),
                                          timestamp=5.0)


def test_do_merge_of_two_inertial_maps_matches_jax(monkeypatch):
    """`_do_merge` of an IMU-initialized source map into a stored target
    (`_weld_pair`'s two halves of a 24-keyframe body chain, its world Sim3)
    on an IMU_MONOCULAR System in both packages: the migrated keyframes'
    preintegrations re-keyed (the stale key dropped), the trajectory
    re-rooted on the target, the tracker's reference keyframes remapped, its
    velocity dropped, the last frame moved into the target's frame and its
    entry derived again; then the weld fuse, the weld's local inertial BA
    over 16 keyframes, the 4-DoF essential graph and the post-merge GBA:
    every pose, velocity, bias and point within 1e-4 of JAX's, `kf_mp` and
    the trajectory's keys equal. The JAX side's 4-DoF graph has fault C22
    repaired as the port's has (`test_torch_inertial_loop.repair_c22`)."""
    from test_torch_inertial_loop import repair_c22

    repair_c22(monkeypatch)
    jsys, psys = _systems("IMU_MONOCULAR", Kmax=32, Pmax=1024)
    target, source, (R, t, s), pres, _ = _weld_pair()
    stores = dict(port=(to_port(target), to_port(source)), jax=(target, source))
    pre_t = _np(stores["port"][0].state.kf_t).copy()
    pre_R = _np(stores["port"][0].state.kf_R).copy()
    out = {}
    for name, sysm in (("jax", jsys), ("port", psys)):  # JAX's merge writes into `target`
        port = name == "port"
        tgt, src = stores[name]
        _merge_setup(sysm, tgt, src, pres, port)
        sysm.multimap._do_merge(src, tgt, R, t, s)
        tr, mm = sysm.tracker, sysm.multimap
        out[name] = dict(
            store=sysm.store is tgt and tr.store is tgt and sysm.mapper.store is tgt,
            maps=len(mm.atlas.maps), active=mm.atlas.active_idx, n_kf=tgt.n_kf,
            preints=sorted(sysm.mapper.preints),
            preint_dT=[float(_np(sysm.mapper.preints[k].dT)) for k in sorted(sysm.mapper.preints)],
            ref=(tr.ref_kf, tr.last_kf_id), velocity=tr.velocity,
            body_vel=np.asarray(tr.body_vel, np.float32),
            traj=[(ts, st is tgt, ref, np.asarray(Rc), np.asarray(tc))
                  for ts, st, ref, Rc, tc in tr.trajectory],
            last=(np.asarray(tr.last_frame.R), np.asarray(tr.last_frame.t)),
            state={f: _np(getattr(tgt.state, f)) for f in FLOATS + ("kf_mp", "kf_valid",
                                                                      "mp_valid")},
            weld=dict(mm.last_weld) if port else None)
    j, p = out["jax"], out["port"]
    assert j["store"] and p["store"]
    assert p["weld"] == dict(ba="inertial", window=16, dof4=True)
    for key in ("maps", "active", "n_kf", "preints", "ref", "velocity"):
        assert p[key] == j[key], key
    assert p["preints"] == list(range(13, 24))  # source slots 1-11, migrated; key 20 dropped
    np.testing.assert_allclose(p["preint_dT"], j["preint_dT"], rtol=0, atol=1e-6)
    # Fault C20, repaired in the port only: the body velocity follows the merge's Sim3.
    np.testing.assert_allclose(p["body_vel"], s * np.asarray(R, np.float64) @ j["body_vel"],
                               rtol=0, atol=1e-6)
    assert [e[:3] for e in p["traj"]] == [e[:3] for e in j["traj"]]
    for a, b in zip(p["traj"], j["traj"]):
        np.testing.assert_allclose(a[3], b[3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a[4], b[4], rtol=0, atol=1e-4)
    for a, b in zip(p["last"], j["last"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for f in ("kf_mp", "kf_valid", "mp_valid"):
        np.testing.assert_array_equal(p["state"][f], j["state"][f], err_msg=f)
    kf, mp = j["state"]["kf_valid"], j["state"]["mp_valid"]
    moved = np.abs(j["state"]["kf_t"][:12] - pre_t[:12]).max()
    assert moved > 1e-3, moved  # the weld and the GBA moved the map
    turned = np.abs(p["state"]["kf_R"][:12] - pre_R[:12]).max()
    assert turned > 1e-3, turned  # and turned its keyframes
    for f in FLOATS:
        sel = mp if f == "mp_pos" else kf
        np.testing.assert_allclose(p["state"][f][sel], j["state"][f][sel], rtol=0, atol=1e-4,
                                   err_msg=f)


def test_do_merge_turns_the_body_velocity_c20():
    """Fault C20: `_do_merge` moves the last frame into the target map's frame
    but left the tracker's body velocity, a world vector, in the merged
    map's; the next frame's IMU prediction (`Tracker._imu_predict`) ran along
    it. A keyframe frame reloads its keyframe's velocity after its mapping
    pass, but a merge that completes in a later frame's tick (asynchronous
    mapping, the runner's default) does not pass through it. The velocity
    now turns and scales with the merge's Sim3: s R v."""
    _, psys = _systems("IMU_MONOCULAR", Kmax=32, Pmax=1024)
    target, source, _, pres, _ = _weld_pair()
    tgt, src = to_port(target), to_port(source)
    _merge_setup(psys, tgt, src, pres, port=True)
    psys.multimap.post_merge_gba = False
    v = psys.tracker.body_vel.copy()
    R = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 2.6], jnp.float32)))
    t, s = np.array([0.5, -1.0, 0.0], np.float32), 0.95
    psys.multimap._do_merge(src, tgt, R, t, s)
    got = psys.tracker.body_vel
    np.testing.assert_allclose(got, s * R @ v, rtol=0, atol=1e-6)
    assert got.dtype == np.float32 and np.abs(got - v).max() > 0.1


def _stereo_pair(seed: int = 11):
    """Two maps of one room for the IMU_STEREO merge: keyframe 2 of the target
    (4 keyframes) and keyframe 4 of the active map (5 keyframes) see the same
    80 points (the same descriptors, their projections plus 0.3 px); the
    active map's world is the target's turned by 0.5 rad of yaw and 0.03 rad
    of tilt and shifted, at scale 1 (stereo is metric). Every other keyframe
    sees 40 points of its own. Returns (target, active, the active map's
    world -> target's world (R, t)) as JAX stores."""
    from orbslam3_tpu.atlas import store as jst

    rng = np.random.default_rng(seed)
    Kmax, Pmax, Nf = 16, 512, 128
    f, cx, cy = PARAMS[0], PARAMS[2], PARAMS[3]
    Y = np.asarray(jlie.exp_so3(jnp.asarray([0.03, -0.02, 0.5], jnp.float32)), np.float64)
    shift = np.array([0.7, -0.3, 0.1])
    shared = np.stack([rng.uniform(-2, 2, 80), rng.uniform(-1.5, 1.5, 80),
                       rng.uniform(4, 7, 80)], -1)
    shared_desc = rng.integers(0, 256, (80, 32), dtype=np.uint8)

    def make(n_kf, seen_at, to_act):
        a = {k: np.array(v) for k, v in jst.empty_map(Kmax=Kmax, Pmax=Pmax, Nf=Nf)._asdict()
             .items()}
        store = jst.MapStore(Kmax=Kmax, Pmax=Pmax, Nf=Nf)
        n_mp = 0
        for i in range(n_kf):
            # Camera i at x = 0.2 i looking down +z (the target's world).
            Rcw, tcw = np.eye(3), np.array([-0.2 * (i - seen_at), 0.0, 0.0])
            if i == seen_at:
                pts, desc = shared, shared_desc
            else:
                pts = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-1.5, 1.5, 40),
                                rng.uniform(4, 7, 40)], -1) - tcw
                desc = rng.integers(0, 256, (40, 32), dtype=np.uint8)
            Xw = pts
            if to_act:  # x_a = Y^T (x_t - shift): Rcw' = Rcw Y, tcw' = tcw + Rcw Y Y^T shift
                Xw = (pts - shift) @ Y
                tcw = tcw + Rcw @ shift
                Rcw = Rcw @ Y
            a["kf_R"][i], a["kf_t"][i] = Rcw, tcw
            a["kf_valid"][i], a["kf_prev"][i] = True, i - 1
            store.kf_ts[i], store.kf_frame_id[i] = 0.25 * i, 5 * i
            for n in range(len(pts)):
                slot = n_mp
                n_mp += 1
                a["mp_pos"][slot], a["mp_desc"][slot] = Xw[n], desc[n]
                a["mp_valid"][slot], a["mp_first_kf"][slot] = True, i
                a["mp_max_dist"][slot], a["mp_normal"][slot, 2] = 100.0, 1.0
                x = Rcw @ Xw[n] + tcw
                a["kf_uv"][i, n] = f * x[:2] / x[2] + [cx, cy] + rng.normal(0, 0.3, 2)
                a["kf_desc"][i, n] = desc[n]
                a["kf_mp"][i, n] = slot
                a["kf_feat_valid"][i, n] = True
        store.state = jst.MapState(**{k: jnp.asarray(v) for k, v in a.items()})
        store.n_kf, store.n_mp = n_kf, n_mp
        return store

    return make(4, 2, False), make(5, 4, True), (Y, shift)


def test_try_merge_imu_stereo_matches_jax(monkeypatch):
    """`_try_merge` on an IMU_STEREO System (Sim3 with the scale fixed, and
    with the IMU ready the yaw-only gate) from the active map's keyframe 4:
    the stored map's database query, the verification with the JAX draws
    (the port's generator cannot reproduce `PRNGKey(kf_id + 7777)`), and the
    world Sim3 handed to `_do_merge`: the same keyframe pair and outcome in
    both packages, s = 1, the rotation yaw only (the tilt of the true one
    dropped) and R, t within 1e-4 of JAX's."""
    import jax

    from orbslam3_tpu.pipeline import multimap as jmm

    from orbslam3_tpu_torch.ops import lie, ransac
    from orbslam3_tpu_torch.pipeline import multimap as pmm

    jsys, psys = _systems("IMU_STEREO", bf=40.0, Kmax=16, Pmax=512)
    target, act, (Y, shift) = _stereo_pair()
    stores = dict(port=(to_port(target), to_port(act)), jax=(target, act))
    sim3_ransac = ransac.sim3_ransac

    def with_jax_samples(X1, X2, valid, *a, **kw):
        logits = jnp.log(jnp.asarray(valid.numpy()).astype(jnp.float32) + 1e-9)
        draw = jax.random.categorical(jax.random.PRNGKey(4 + 7777), logits[None, None, :],
                                      shape=(128, 3))
        return sim3_ransac(X1, X2, valid, *a, samples=torch.from_numpy(np.array(draw)), **kw)

    monkeypatch.setattr(ransac, "sim3_ransac", with_jax_samples)
    out = {}
    for name, sysm, mod in (("jax", jsys, jmm), ("port", psys, pmm)):
        port = name == "port"
        tgt, src = stores[name]
        if port:
            sysm._point_at(src)
        else:
            sysm.store = sysm.tracker.store = sysm.mapper.store = src
        mm = sysm.multimap
        mm.atlas.maps = [tgt, src]
        mm.atlas.active_idx = 1
        sysm.tracker.imu_ready = True
        for store in (tgt, src):
            s = store.state
            for k in range(store.n_kf):
                mm._kfdb(store).add(k, s.kf_desc[k], s.kf_feat_valid[k])
        pairs, merged = [], []
        verify = mm._verify_merge

        def on_verify(a_, t_, kf_id, cand, verify=verify, pairs=pairs):
            pairs.append((kf_id, cand))
            return verify(a_, t_, kf_id, cand)

        def on_merge(a_, t_, R, t, s, merged=merged):
            merged.append((np.asarray(R, np.float64), np.asarray(t, np.float64), float(s)))

        monkeypatch.setattr(mm, "_verify_merge", on_verify)
        monkeypatch.setattr(mm, "_do_merge", on_merge)
        mm._try_merge(4)
        out[name] = dict(pairs=pairs, merged=merged, n_merges=mm.n_merges)
    j, p = out["jax"], out["port"]
    assert j["merged"] and j["n_merges"] == 1 and j["pairs"][-1] == (4, 2)
    assert p["pairs"] == j["pairs"] and p["n_merges"] == j["n_merges"]
    (Rj, tj, sj), (Rp, tp, sp) = j["merged"][0], p["merged"][0]
    assert sp == sj == 1.0
    phi = lie.log_so3(torch.from_numpy(Rp.astype(np.float32))).numpy()
    assert abs(phi[0]) < 1e-6 and abs(phi[1]) < 1e-6 and abs(phi[2] - 0.5) < 0.02, phi
    np.testing.assert_allclose(Rp, Rj, rtol=0, atol=1e-4)
    np.testing.assert_allclose(tp, tj, rtol=0, atol=1e-4)
    # The ungated rotation was the true one, tilt included: the gate moved it.
    assert np.abs(Rp - Y).max() > 1e-2
