"""The port's Atlas pieces against the JAX package on the CPU: `transform_map`
and `merge_maps` (`pipeline/map_merging.py`), the inertial merge gate, the
`Atlas` (its maps, `remove_bad_maps`, and its files: an atlas saved by
either package loads in the other with every array equal), the trajectory
writers' numpy copy (the same bytes), `System.save_trajectory_euroc`, and
`tests/multimap_scene.py` (every frame of `scripts/multimap_replay.py`'s
schedule rendered equal).

Tolerances: integer tables exact, floats within 1e-5 (1e-2 px for the
projections the Sim3 leaves invariant), files byte for byte."""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from orbslam3_tpu.atlas import store as jst  # noqa: E402
from orbslam3_tpu.ops import lie as jlie  # noqa: E402

from orbslam3_tpu_torch import convert  # noqa: E402
from orbslam3_tpu_torch.atlas import store as st  # noqa: E402

CPU = torch.device("cpu")
INT_FIELDS = ("kf_valid", "kf_octave", "kf_desc", "kf_feat_valid", "kf_mp", "kf_prev",
              "mp_valid", "mp_desc", "mp_first_kf", "mp_found", "mp_visible")


def make_store(rng, n_kf=4, n_mp=50, offset=0.0):
    """`tests/test_merging.py::make_store` with random descriptors, uv,
    octaves and normals, and frame numbers: a JAX `MapStore` and its points."""
    store = jst.MapStore(Kmax=16, Pmax=256, Nf=32)
    pts = np.stack([rng.uniform(-2, 2, n_mp), rng.uniform(-2, 2, n_mp),
                    rng.uniform(3, 6, n_mp) + offset], -1).astype(np.float32)
    normals = rng.normal(size=(n_mp, 3)).astype(np.float32)
    slots = store.alloc_mps(n_mp)
    store.state = jst.add_points(
        store.state, jnp.asarray(slots), jnp.asarray(pts),
        jnp.asarray(rng.integers(0, 256, (n_mp, 32), dtype=np.uint8)), jnp.asarray(normals),
        jnp.full(n_mp, 0.5), jnp.full(n_mp, 100.0), jnp.asarray(np.arange(n_mp) % n_kf, np.int32),
        jnp.ones(n_mp, bool))
    prev = -1
    for k in range(n_kf):
        slot = store.alloc_kf()
        assoc = np.full(32, -1, np.int32)
        take = rng.choice(n_mp, min(16, n_mp), replace=False)
        assoc[rng.choice(32, len(take), replace=False)] = slots[take]
        R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32)))
        store.state = jst.add_keyframe(
            store.state, slot, jnp.asarray(R), jnp.asarray([0.1 * k, 0.02 * k, 0.0]),
            jnp.asarray(rng.uniform(0, 300, (32, 2)).astype(np.float32)), jnp.full(32, -1.0),
            jnp.asarray(rng.integers(0, 4, 32).astype(np.int32)),
            jnp.asarray(rng.uniform(0, 6, 32).astype(np.float32)),
            jnp.asarray(rng.integers(0, 256, (32, 32), dtype=np.uint8)), jnp.ones(32, bool),
            jnp.asarray(assoc), vel=jnp.asarray(rng.normal(size=3).astype(np.float32)),
            prev_kf=prev)
        store.kf_ts[slot] = float(k) + 0.25
        store.kf_frame_id[slot] = 10 * k + 3
        prev = slot
    return store, pts


def to_port(jstore) -> st.MapStore:
    """The JAX store as a port `MapStore` on the CPU (host bookkeeping too)."""
    s = jstore.state
    out = st.MapStore(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device=CPU)
    out.state = convert.to_torch(s, CPU, st.MapState)
    out.n_kf, out.n_mp = jstore.n_kf, jstore.n_mp
    out.kf_ts = jstore.kf_ts.copy()
    out.kf_frame_id = jstore.kf_frame_id.copy()
    out.free_mp_slots = list(jstore.free_mp_slots)
    out.free_kf_slots = list(jstore.free_kf_slots)
    out.change_index = jstore.change_index
    return out


def assert_states_equal(s_port, s_jax, atol: float):
    for name in st.MapState._fields:
        a = getattr(s_port, name).cpu().numpy()
        b = np.asarray(getattr(s_jax, name))
        if name in INT_FIELDS:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=name)


SIM3 = [([0.2, -0.1, 0.3], [1.0, -2.0, 0.5], 2.0), ([0.0, 0.3, 0.0], [2.0, 0.0, 1.0], 1.5),
        ([-0.4, 0.05, 1.2], [-0.3, 0.7, 0.0], 0.6)]


@pytest.mark.parametrize("case", range(len(SIM3)))
def test_transform_map_matches_jax(case):
    """`transform_map` within 1e-5 of the JAX function, and the projections of
    keyframe 1 unchanged by the Sim3 (`test_merging.py`'s case)."""
    from orbslam3_tpu.ops import cameras as jcam
    from orbslam3_tpu.pipeline import map_merging as jmm

    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import lie
    from orbslam3_tpu_torch.pipeline import map_merging as mm

    w, t, s = SIM3[case]
    jstore, _ = make_store(np.random.default_rng(case))
    R = np.array(jlie.exp_so3(jnp.asarray(w, jnp.float32)))
    t = np.array(t, np.float32)
    want = jmm.transform_map(jstore.state, jnp.asarray(R), jnp.asarray(t), s)
    s0 = convert.to_torch(jstore.state, CPU, st.MapState)
    got = mm.transform_map(s0, torch.from_numpy(R), torch.from_numpy(t), s)
    assert_states_equal(got, want, atol=1e-5)
    params = torch.tensor([300.0, 300.0, 160.0, 120.0, 0, 0, 0, 0])
    uv0 = cam.project(jcam.CameraModel.PINHOLE, params,
                      lie.se3_apply(s0.kf_R[1], s0.kf_t[1], s0.mp_pos[:50]))
    uv1 = cam.project(jcam.CameraModel.PINHOLE, params,
                      lie.se3_apply(got.kf_R[1], got.kf_t[1], got.mp_pos[:50]))
    np.testing.assert_allclose(uv1.numpy(), uv0.numpy(), atol=1e-2)


@pytest.mark.parametrize("free_slots", [False, True])
def test_merge_maps_matches_jax(free_slots):
    """`merge_maps` of `test_merging.py`'s pair: the remaps and every integer
    table of the target equal JAX's (`kf_mp`, `kf_prev`, `mp_first_kf`), its
    floats within 1e-5, the timestamps and frame numbers carried over. With
    `free_slots`, the target has recycled keyframe and point slots and the
    source an erased keyframe and erased points (links to them become -1)."""
    from orbslam3_tpu.pipeline import map_merging as jmm

    from orbslam3_tpu_torch.pipeline import map_merging as mm

    rng = np.random.default_rng(7)
    jt, _ = make_store(rng, n_kf=3, n_mp=40)
    js, src_pts = make_store(rng, n_kf=5, n_mp=30, offset=5.0)
    if free_slots:
        jt.free_kf_slots = [1]
        jt.free_mp_slots = [5, 9, 11]
        js.state = jst.erase_keyframe(js.state, 2)
        js.state = jst.erase_points(js.state, jnp.asarray([3, 4, 17], jnp.int32),
                                    jnp.ones(3, bool))
    pt, ps = to_port(jt), to_port(js)
    R = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.3, 0.0], jnp.float32)))
    t = np.array([2.0, 0.0, 1.0], np.float32)
    kf_j, mp_j = jmm.merge_maps(jt, js, R, t, 1.5)
    kf_p, mp_p = mm.merge_maps(pt, ps, R, t, 1.5)
    assert kf_p == kf_j and mp_p == mp_j
    assert (pt.n_kf, pt.n_mp, pt.free_kf_slots, pt.free_mp_slots) == (
        jt.n_kf, jt.n_mp, jt.free_kf_slots, jt.free_mp_slots)
    np.testing.assert_array_equal(pt.kf_ts, jt.kf_ts)
    np.testing.assert_array_equal(pt.kf_frame_id, jt.kf_frame_id)
    assert_states_equal(pt.state, jt.state, atol=1e-5)
    np.testing.assert_allclose(pt.state.mp_pos[mp_p[0]].numpy(),
                               1.5 * R @ src_pts[0] + t, atol=1e-4)


def test_inertial_merge_gates_match_jax():
    """`gate_inertial_sim3`, the cases of `test_merging.py::
    test_inertial_merge_gates`: the same verdicts as JAX's, the gated
    rotation within 1e-5 of JAX's, yaw only, world z kept."""
    from orbslam3_tpu.pipeline.multimap import gate_inertial_sim3 as jgate

    from orbslam3_tpu_torch.ops import lie
    from orbslam3_tpu_torch.pipeline.multimap import gate_inertial_sim3

    Rfull = np.asarray(jlie.exp_so3(jnp.asarray([0.05, -0.08, 0.6], jnp.float32)))
    for s, metric in ((1.7, False), (1.2, True), (0.85, True), (1.02, True), (0.95, True)):
        ok, R = gate_inertial_sim3(Rfull, s, imu_metric=metric)
        ok_j, R_j = jgate(Rfull, s, imu_metric=metric)
        assert ok == ok_j
        np.testing.assert_allclose(R, np.asarray(R_j), atol=1e-5)
    ok, R = gate_inertial_sim3(Rfull, 1.7, imu_metric=False)
    assert ok and np.array_equal(R, Rfull)
    ok, Ry = gate_inertial_sim3(Rfull, 1.02, imu_metric=True)
    phi = lie.log_so3(torch.from_numpy(np.asarray(Ry, np.float32))).numpy()
    assert ok and abs(phi[0]) < 1e-6 and abs(phi[1]) < 1e-6 and abs(phi[2] - 0.6) < 0.05
    z = np.array([0.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(Ry @ z, z, atol=1e-5)


def _atlas_pair(rng):
    """A port Atlas of two maps built from JAX stores (map 0 with free
    slots), the second active."""
    from orbslam3_tpu_torch.atlas.atlas import Atlas

    j0, _ = make_store(rng, n_kf=3, n_mp=40)
    j0.free_mp_slots = [4, 8]
    j1, _ = make_store(rng, n_kf=5, n_mp=60)
    j1.change_index = 9
    atlas = Atlas(Kmax=16, Pmax=256, Nf=32, device=CPU)
    atlas.maps = [to_port(j0), to_port(j1)]
    atlas.active_idx = 1
    atlas.imu_initialized = True
    return atlas


def _same_store(a, b, jax_b: bool = False):
    """Every array and every piece of host bookkeeping equal."""
    for name in st.MapState._fields:
        x = getattr(a.state, name).cpu().numpy()
        y = np.asarray(getattr(b.state, name)) if jax_b else getattr(b.state, name).cpu().numpy()
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.n_kf, a.n_mp, list(a.free_mp_slots), list(a.free_kf_slots), a.change_index) == (
        b.n_kf, b.n_mp, list(b.free_mp_slots), list(b.free_kf_slots), b.change_index)
    assert np.array_equal(a.kf_ts, b.kf_ts) and np.array_equal(a.kf_frame_id, b.kf_frame_id)


def test_atlas_multi_map_and_checkpoint(tmp_path):
    """`test_atlas.py::test_atlas_multi_map_and_checkpoint` through the port:
    two maps, the second active, saved and loaded back equal."""
    from orbslam3_tpu_torch.atlas.atlas import Atlas

    atlas = Atlas(Kmax=8, Pmax=64, Nf=16, device=CPU)
    Nf = 16
    r0 = torch.from_numpy(np.concatenate([np.arange(8), np.full(8, -1)]).astype(np.int32))

    def add(store):
        slot = store.alloc_kf()
        store.state = st.add_keyframe(
            store.state, slot, torch.eye(3), torch.zeros(3), torch.zeros((Nf, 2)),
            torch.full((Nf,), -1.0), torch.zeros(Nf, dtype=torch.int32), torch.zeros(Nf),
            torch.zeros((Nf, 32), dtype=torch.uint8), torch.ones(Nf, dtype=torch.bool), r0)

    add(atlas.active)
    atlas.active.kf_ts[0] = 12.5
    m2 = atlas.create_new_map()
    assert atlas.n_maps == 2 and atlas.active is m2 and m2.device == CPU
    add(m2)
    path = str(tmp_path / "ckpt")
    atlas.save(path)
    atlas2 = Atlas.load(path, CPU)
    assert atlas2.n_maps == 2 and atlas2.active_idx == 1
    assert atlas2.maps[0].kf_ts[0] == 12.5
    for a, b in zip(atlas.maps, atlas2.maps):
        _same_store(a, b)


def test_atlas_files_cross_load(tmp_path):
    """An atlas saved by the port loads in JAX, and one saved by JAX loads in
    the port, with every array, every slot list and the metadata equal."""
    from orbslam3_tpu.atlas.atlas import Atlas as JAtlas

    from orbslam3_tpu_torch.atlas.atlas import Atlas

    atlas = _atlas_pair(np.random.default_rng(3))
    atlas.save(str(tmp_path / "port"))
    j = JAtlas.load(str(tmp_path / "port"))
    assert (j.n_maps, j.active_idx, j.imu_initialized) == (2, 1, True)
    for a, b in zip(atlas.maps, j.maps):
        _same_store(a, b, jax_b=True)
    j.save(str(tmp_path / "jax"))
    back = Atlas.load(str(tmp_path / "jax"), CPU)
    assert (back.n_maps, back.active_idx, back.imu_initialized) == (2, 1, True)
    for a, b in zip(atlas.maps, back.maps):
        _same_store(b, a)


def test_remove_bad_maps():
    """`remove_bad_maps(min_kfs)` drops the thin stored maps and keeps the
    active one whatever its size, as JAX's does."""
    from orbslam3_tpu.atlas.atlas import Atlas as JAtlas

    from orbslam3_tpu_torch.atlas.atlas import Atlas

    sizes, active = [6, 2, 1, 5, 0], 2
    atlas = Atlas(Kmax=8, Pmax=64, Nf=16, device=CPU)
    j = JAtlas(Kmax=8, Pmax=64, Nf=16)
    for a in (atlas, j):
        a.maps = a.maps * 0
    for n in sizes:
        for a, mk in ((atlas, lambda: st.MapStore(8, 64, 16, device=CPU)),
                      (j, lambda: jst.MapStore(8, 64, 16))):
            m = mk()
            m.n_kf = n
            a.maps.append(m)
    atlas.active_idx = j.active_idx = active
    act = atlas.active
    atlas.remove_bad_maps(min_kfs=5)
    j.remove_bad_maps(min_kfs=5)
    assert [m.n_kf for m in atlas.maps] == [m.n_kf for m in j.maps] == [6, 1, 5]
    assert atlas.active is act and atlas.active_idx == j.active_idx == 1


def _poses(rng, n):
    Rs = [np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32)))
          for _ in range(n)]
    Rs[3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # w = 0: the largest-diagonal branch
    return Rs, [rng.normal(0, 1.0, 3) for _ in range(n)]


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_trajectory_writers_same_bytes(tmp_path, fmt):
    """The numpy copy of `io/trajectory.py` writes the same bytes as the
    original for TUM, EuRoC and KITTI rows, and `load_tum` reads back what
    `save_tum` wrote (`test_io.py::test_trajectory_roundtrip`)."""
    from orbslam3_tpu.io import trajectory as jtio

    from orbslam3_tpu_torch.io import trajectory as tio

    rng = np.random.default_rng(11)
    n = 20
    ts = np.arange(n) * 0.05 + 1403636579.763555
    Rs, tsl = _poses(rng, n)
    paths = [str(tmp_path / f"{who}.txt") for who in ("port", "jax")]
    for mod, path in zip((tio, jtio), paths):
        if fmt == "kitti":
            mod.save_kitti(path, Rs, tsl)
        else:
            getattr(mod, f"save_{fmt}")(path, ts, Rs, tsl)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and len(data[0].splitlines()) == n
    if fmt == "tum":
        ts2, pos, _ = tio.load_tum(paths[0])
        np.testing.assert_allclose(ts2, ts, atol=1e-6)
        np.testing.assert_allclose(pos, np.stack(tsl), atol=1e-6)


def test_save_trajectory_euroc():
    """`System.save_trajectory_euroc` (`test_io.py::test_save_trajectory_euroc`
    through the port): the largest map's frames only, re-rooted at its first
    keyframe, EuRoC rows."""
    import tempfile

    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.system import Sensor, System

    slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE,
                  [100.0, 100.0, 64.0, 48.0, 0, 0, 0, 0], (128, 96),
                  feat.OrbParams(n_features=64, n_levels=2), device="cpu", Kmax=8, Pmax=256)
    store = slam.store
    R0 = np.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
    t0 = np.asarray([1.0, 2.0, 3.0], np.float32)
    R1 = np.eye(3, dtype=np.float32)
    t1 = np.asarray([0.5, 0.0, 0.0], np.float32)
    s = store.state
    kf_R, kf_t, kf_valid = s.kf_R.clone(), s.kf_t.clone(), s.kf_valid.clone()
    kf_R[0], kf_R[1] = torch.from_numpy(R0), torch.from_numpy(R1)
    kf_t[0], kf_t[1] = torch.from_numpy(t0), torch.from_numpy(t1)
    kf_valid[:2] = True
    store.state = s._replace(kf_R=kf_R, kf_t=kf_t, kf_valid=kf_valid)
    store.n_kf = 2
    I3, z = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    slam.tracker.trajectory = [(0.0, store, 0, I3, z), (0.1, store, 1, I3, z),
                               (0.2, object(), 0, I3, z)]  # a foreign map's entry
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "euroc.txt")
        slam.save_trajectory_euroc(out)
        rows = [line.split() for line in open(out).read().splitlines()]
    assert len(rows) == 2 and all(len(r) == 8 for r in rows)
    v0 = np.asarray([float(x) for x in rows[0]])
    np.testing.assert_allclose(v0[1:7], 0.0, atol=1e-6)
    np.testing.assert_allclose(abs(v0[7]), 1.0, atol=1e-6)
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = R0, t0
    T1 = np.eye(4)
    T1[:3, :3], T1[:3, 3] = R1, t1
    Trel = np.linalg.inv(T1 @ np.linalg.inv(T0))
    v1 = np.asarray([float(x) for x in rows[1]])
    np.testing.assert_allclose(v1[1:4], Trel[:3, 3], atol=1e-5)


def test_multimap_scene_renders_equal():
    """`tests/multimap_scene.py` renders every frame of the schedule, and
    gives every pose, equal to `scripts/multimap_replay.py`'s Scene."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "scripts"))
    import multimap_replay as MR
    import multimap_scene as MS

    a, b = MR.Scene(), MS.Scene()
    assert [t for t, _ in a.schedule] == [t for t, _ in b.schedule]
    for (tag, pa), (_, pb) in zip(a.schedule, b.schedule):
        if tag == "blank":
            continue
        assert np.array_equal(pa[0], pb[0]) and np.array_equal(pa[1], pb[1])
        assert np.array_equal(a.render(*pa), b.render(*pb))
    assert np.array_equal(a.blank, b.blank)


def _weld_pair(seed: int = 5):
    """A 24-keyframe body chain of `tests/test_inertial.py::simulate_kf_chain`
    (cameras = bodies) cut in two JAX stores: keyframes 0-11 (the target) and
    12-23 (the source) in a frame turned by 0.3 rad of yaw and shifted by
    (1, -0.5, 0.2) m. Each keyframe makes 20 points 3-6 m ahead, seen by the
    keyframes within 6 of it in its own map (a baseline that fixes their
    depth), at their exact projections plus 0.5 px of noise. Returns
    (target, source, the source's Sim3 into the target's frame with an error
    of 0.01 rad of yaw (an inertial merge keeps only the yaw of its
    rotation) and 2 cm, the preintegrations of keyframe k's edge k-1 -> k,
    Nf)."""
    from orbslam3_tpu.ops import imu as jimu
    from tests.test_inertial import simulate_kf_chain
    from tests.test_torch_inertial_support import _stacked

    rng = np.random.default_rng(seed)
    n_kf, n_new, Nf, W, H, f = 24, 20, 288, 640.0, 480.0, 400.0
    kf_R, kf_p, kf_v, edges, _ = simulate_kf_chain(rng, n_kf=n_kf, samples_per_kf=45)
    pres = [jimu.Preintegrated(*(x[k] for x in _stacked(edges))) for k in range(n_kf - 1)]
    Rcw = [R.T for R in kf_R]
    tcw = [-R.T @ p for R, p in zip(kf_R, kf_p)]
    Xc = np.stack([rng.uniform(-1.5, 1.5, (n_kf, n_new)), rng.uniform(-1.0, 1.0, (n_kf, n_new)),
                   rng.uniform(3.0, 6.0, (n_kf, n_new))], -1)
    Xw = np.einsum("kij,knj->kni", kf_R, Xc) + kf_p[:, None]
    yaw = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.3], jnp.float32)), np.float64)
    shift = np.array([1.0, -0.5, 0.2])

    def half(kfs, to_src: bool):
        a = {k: np.array(v) for k, v in jst.empty_map(Kmax=32, Pmax=1024, Nf=Nf)._asdict().items()}
        store = jst.MapStore(Kmax=32, Pmax=1024, Nf=Nf)
        pts = {}
        for i, k in enumerate(kfs):
            R, t, v = Rcw[k].astype(np.float64), tcw[k], kf_v[k]
            if to_src:  # world x' = Y x + s: Rcw' = Rcw Y^T, tcw' = tcw - Rcw' s
                R = R @ yaw.T
                t = t - R @ shift
                v = yaw @ v
            a["kf_R"][i], a["kf_t"][i], a["kf_vel"][i] = R, t, v
            a["kf_valid"][i] = True
            a["kf_prev"][i] = i - 1
            store.kf_ts[i] = 45 * 0.005 * k
            store.kf_frame_id[i] = 10 * k
        for i, k in enumerate(kfs):
            for n in range(n_new):
                slot = len(pts)
                X = yaw @ Xw[k, n] + shift if to_src else Xw[k, n]
                pts[slot] = (X, i)
        a["mp_pos"][:len(pts)] = np.stack([p for p, _ in pts.values()])
        a["mp_valid"][:len(pts)] = True
        a["mp_first_kf"][:len(pts)] = [i for _, i in pts.values()]
        a["mp_max_dist"][:len(pts)] = 100.0
        a["mp_normal"][:len(pts), 2] = 1.0
        for i in range(len(kfs)):
            col = 0
            for slot, (X, first) in pts.items():
                if abs(first - i) > 6 or col == Nf:
                    continue
                x = a["kf_R"][i] @ X + a["kf_t"][i]
                uv = f * x[:2] / x[2] + [W / 2, H / 2]
                if x[2] > 0.5 and 0 <= uv[0] < W and 0 <= uv[1] < H:
                    a["kf_uv"][i, col] = uv + rng.normal(0, 0.5, 2)
                    a["kf_mp"][i, col] = slot
                    a["kf_feat_valid"][i, col] = True
                    col += 1
        store.state = jst.MapState(**{k: jnp.asarray(v) for k, v in a.items()})
        store.n_kf, store.n_mp = len(kfs), len(pts)
        return store

    target, source = half(range(12), False), half(range(12, 24), True)
    Rerr = np.asarray(jlie.exp_so3(jnp.asarray([0.0, 0.0, 0.01], jnp.float32)), np.float64)
    R = (Rerr @ yaw.T).astype(np.float32)
    t = (-(yaw.T @ shift) + [0.02, -0.01, 0.01]).astype(np.float32)
    return target, source, (R, t, 1.0), pres, Nf


def test_inertial_weld_matches_jax():
    """The inertial merge's seam refinement (`_weld_and_distribute` once the
    IMU is initialized: `_local_inertial_ba(center, window=16)` over the
    migrated keyframes' chain, then the 4-DoF essential graph with the welded
    window fixed and the points through their first keyframe) on the same
    merged map in both packages: every pose, velocity, bias and point within
    1e-4 of JAX's."""
    from orbslam3_tpu.ops import bow as jbow
    from orbslam3_tpu.ops import cameras as jcam
    from orbslam3_tpu.ops import imu as jimu
    from orbslam3_tpu.pipeline import map_merging as jmm
    from orbslam3_tpu.system import Sensor as JSensor
    from orbslam3_tpu.system import System as JSystem

    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import imu
    from orbslam3_tpu_torch.system import Sensor, System

    target, source, (R, t, s), pres, Nf = _weld_pair()
    kf_remap, _ = jmm.merge_maps(target, source, R, t, s)
    center = kf_remap[source.n_kf - 1]
    chain = list(range(12)) + [kf_remap[i] for i in range(12)]  # slot of keyframe k
    preints = {chain[k]: pres[k - 1] for k in range(1, 24) if k != 12}
    port_store = to_port(target)
    pre_t = np.array(target.state.kf_t)
    calib = (np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    params = [400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0]
    voc = jbow.build_vocabulary(np.random.default_rng(0).integers(0, 256, (64, 32), np.uint8),
                                k=2, depth=2, seed=0)
    jsys = JSystem(JSensor.IMU_MONOCULAR, jcam.CameraModel.PINHOLE, np.float32(params), (640, 480),
                   Kmax=32, Pmax=1024, imu_calib=jimu.ImuCalib.create(*calib))
    psys = System(Sensor.IMU_MONOCULAR, cam.CameraModel.PINHOLE, params, (640, 480),
                  device="cpu", Kmax=32, Pmax=1024, imu_calib=imu.ImuCalib.create(*calib, device="cpu"))
    out = {}
    for name, sysm, store, pre in (
            ("jax", jsys, target, preints),
            ("port", psys, port_store, {k: convert.preintegrated(p, "cpu")
                                        for k, p in preints.items()})):
        sysm.enable_multimap(voc if name == "jax" else convert.vocabulary(voc, "cpu"))
        sysm.store = sysm.tracker.store = sysm.mapper.store = store
        sysm.mapper.preints = pre
        sysm.mapper.imu_init.initialized = True
        sysm.multimap._weld_and_distribute(store, center)
        out[name] = store.state
    moved = np.abs(np.asarray(out["jax"].kf_t) - pre_t).max()
    assert moved > 1e-3, moved  # the weld moved the map
    for field in ("kf_R", "kf_t", "kf_vel", "kf_bias_g", "kf_bias_a", "mp_pos"):
        np.testing.assert_allclose(getattr(out["port"], field).numpy(),
                                   np.asarray(getattr(out["jax"], field)), rtol=0, atol=1e-4,
                                   err_msg=field)


def test_euroc_frames_blind():
    """`entry.euroc_frames(blind=(at, n))`: frames at ... at + n - 1 are a
    uniform grey 35 image, every other frame (and every timestamp and camera
    centre) is the one of the sequence without `blind`."""
    from orbslam3_tpu_torch import entry as E

    ts, imgs, pos = E.euroc_frames(5, t_loop=16.0)
    ts_b, imgs_b, pos_b = E.euroc_frames(5, t_loop=16.0, blind=(1, 2))
    assert np.array_equal(ts, ts_b) and np.array_equal(pos, pos_b)
    assert (imgs_b[1:3] == 35).all() and imgs_b.dtype == imgs.dtype
    assert np.array_equal(imgs_b[[0, 3, 4]], imgs[[0, 3, 4]])
