"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: without a CUDA device every test here skips (the kernels
have no CPU or interpreted mode). On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(`tests/conftest.py` imports JAX, which a machine with only the port lacks.)

Sizes cover the edges of each kernel's tiling: images smaller than one
64 x 32 tile and than its halo, and plateaus; key counts below one warp,
across several 1024-key tiles, and query counts that are no multiple of a
block.
"""

import numpy as np
import pytest
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch import kernel_bench
from orbslam3_tpu_torch.ops import _build, cuda_fast, cuda_match
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops.cameras import CameraModel
from orbslam3_tpu_torch.system import Sensor, System

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rand_img(rng, H, W):
    img = np.full((H, W), 40.0, np.float32)
    for _ in range(H * W // 600):
        y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
        s = rng.integers(3, 16)
        img[y : y + s, x : x + s] = rng.uniform(60, 250)
    return np.round(img + rng.normal(0, 2.0, (H, W))).astype(np.float32)


BLOCK_IMAGES = {"240x320": (240, 320), "2400x768": (2400, 768), "37x53": (37, 53)}


@pytest.mark.parametrize("case", list(BLOCK_IMAGES) + [name for name, _ in kernel_bench.b2_cases()])
def test_fast_nms_kernel_equals_plain(dev, case):
    """Bit-exact on every pixel, in one launch (both pad with zeros and sum
    in ring order): block images, and B2's cases (images smaller than a
    tile and its halo, non-integer values, plateaus of equal scores)."""
    if case in BLOCK_IMAGES:
        H, W = BLOCK_IMAGES[case]
        img = _rand_img(np.random.default_rng(H), H, W)
    else:
        img = dict(kernel_bench.b2_cases())[case]
    img = torch.from_numpy(img).to(dev)
    n0 = cuda_fast.LAUNCHES
    s_k, i_k = cuda_fast.fast_score_nms(img, 7.0, 20.0)
    assert cuda_fast.LAUNCHES == n0 + 1
    s_p, i_p = feat.fast_score_nms_plain(img, 7.0, 20.0)
    torch.cuda.synchronize()
    assert torch.equal(s_k, s_p)
    assert torch.equal(i_k, i_p)
    assert int((s_k > 0).sum()) > 0


@pytest.mark.parametrize("n,m,windowed", [
    (1, 5, False), (37, 31, False), (1000, 1024, False), (300, 1000, True),
    (16384, 1024, True), (33, 1024, True),
    (1000, 1500, False), (16384, 2000, True), (1024, 2048, True), (33, 4097, True),
])
def test_hamming_top2_kernel_equals_plain(dev, n, m, windowed):
    """d1, d2 and j1 exactly equal on every row (ties go to the lowest
    index on both sides)."""
    rng = np.random.default_rng(n + m)
    db = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    src = rng.integers(0, m, n)
    flips = (rng.random((n, 32, 8)) < 0.05).astype(np.uint8)
    da = db[src] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
    da[: n // 3] = rng.integers(0, 256, (n // 3, 32), dtype=np.uint8)
    # Duplicate keys make exact ties in d1.
    db[m // 2 :: 7] = db[m // 2]
    vb = rng.random(m) > 0.1
    T = lambda x: convert.tensor(x, dev)  # noqa: E731
    win = None
    if windowed:
        uvk = rng.uniform(0, 400, (m, 2)).astype(np.float32)
        octk = rng.integers(0, 8, m).astype(np.int32)
        lo = np.clip(octk[src] - 1, 0, None).astype(np.int32)
        win = cuda_match.MatchWindow(
            T((uvk[src] + rng.normal(0, 4, (n, 2))).astype(np.float32)), T(uvk),
            T(rng.uniform(3, 60, n).astype(np.float32)), T(octk), T(lo), T(lo + 2))
    args = (T(da), T(db), T(vb), win)
    n0 = cuda_match.LAUNCHES
    got = cuda_match.hamming_top2(*args)
    assert cuda_match.LAUNCHES == n0 + 1
    ref = cuda_match.hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", [name for name, _ in kernel_bench.b1_edge_cases()])
def test_hamming_top2_kernel_equals_plain_on_edge_cases(dev, case):
    """B1's edge cases (NaN and infinite positions, radius 0 and wider than
    the image, keys at exactly |du| = r, M = 1 and 2, all keys invalid,
    duplicate descriptors, odd query counts): d1, d2 and j1 exactly equal to
    the plain version on every row."""
    args = kernel_bench.b1_case_args(dict(kernel_bench.b1_edge_cases())[case], dev)
    n0 = cuda_match.LAUNCHES
    got = cuda_match.hamming_top2(*args)
    assert cuda_match.LAUNCHES == n0 + 1
    ref = cuda_match.hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", [name for name, _ in kernel_bench.b1_tile_cases()])
def test_hamming_top2_kernel_equals_plain_above_one_tile(dev, case):
    """More keys than one 1024-key tile (1025, 2000, 4097), and ties across
    the tile edge (query 0 is key 5 and key 1029: j1 = 5): d1, d2 and j1
    exactly equal to the plain version on every row, in one launch."""
    args = kernel_bench.b1_case_args(dict(kernel_bench.b1_tile_cases())[case], dev)
    n0 = cuda_match.LAUNCHES
    got = cuda_match.hamming_top2(*args)
    assert cuda_match.LAUNCHES == n0 + 1
    ref = cuda_match.hamming_top2_plain(*args)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if case.startswith("tile_tie"):
        assert int(got[2][0]) == 5 and float(got[0][0]) == 0.0


def test_hamming_top2_kernel_takes_one_radius_by_stride(dev):
    """A radius shared by all queries (0-d, or expanded with stride 0) is
    read in place and gives what the same radius per query gives."""
    args = kernel_bench.b1_case_args(kernel_bench.b1_edge_cases()[-1][1], dev)
    n = args[0].shape[0]
    r = torch.tensor(9.5, device=dev)
    outs = []
    for radius in (r, r.expand(n), r.repeat(n)):
        outs.append(cuda_match.hamming_top2(*args[:3], args[3]._replace(radius_q=radius)))
    torch.cuda.synchronize()
    for out in outs[:2]:
        for g, e in zip(out, outs[2]):
            assert torch.equal(g, e)
    assert int((outs[2][0] < 1e9).sum()) > 0


def test_slice_on_card_equals_cpu_port(dev):
    """The small slice on the card: through the kernels it equals the plain
    versions on the card (assoc equal, pose within 1e-4), and it tracks as
    the CPU port does (the pyramid matmuls sum in another order on the card,
    so a few level pixels and hence keypoints may differ: n_inl within 2%)."""
    cfg = E.EUROC._replace(H=240, W=320, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                           n_features=300, n_levels=3, Kmax=16, Pmax=2048, n_kf=12,
                           n_mp=1500, n_local=1024, n_back=150, first_id=1600, ref_kf=11)
    _, args_cpu = E.entry("cpu", cfg)
    args_dev = tuple(x.to(dev) if isinstance(x, torch.Tensor)
                     else type(x)(*(y.to(dev) for y in x)) for x in args_cpu)
    b_cpu = E.staged_pipeline("cpu", cfg)(*args_cpu)
    n0 = (cuda_fast.LAUNCHES, cuda_match.LAUNCHES)
    b_dev = E.staged_pipeline(dev, cfg)(*args_dev)
    assert cuda_fast.LAUNCHES > n0[0] and cuda_match.LAUNCHES > n0[1]
    with _build.force_plain():
        b_plain = E.staged_pipeline(dev, cfg)(*args_dev)
    np.testing.assert_array_equal(b_plain["assoc"], b_dev["assoc"])
    np.testing.assert_allclose(b_dev["R"], b_plain["R"], atol=1e-4)
    np.testing.assert_allclose(b_dev["t"], b_plain["t"], atol=1e-4)
    assert bool(b_dev["used_a"]) and bool(b_cpu["used_a"])
    assert abs(int(b_dev["n_inl"]) - int(b_cpu["n_inl"])) <= 0.02 * int(b_cpu["n_inl"])


def test_mapping_pass_on_card_equals_plain(dev):
    """The small mapping pass (the CPU parity test's size) on the card on its
    variant scene: through kernel B1 it equals the plain versions on the
    card (triangulation, fused rows, adds, conflicts and n_bad equal; poses
    within 1e-4: the segment sums are atomic adds in no fixed order), and
    the fuse found the planted keypoints."""
    cfg = E.MappingConfig(Kmax=16, Pmax=2048, Nf=768, n_kf=12, n_mp=1500, n_nb=3, n_cand=256,
                          n_window=6, n_fixed=4, n_fixed_valid=3, iters=5)
    run, _ = E.mapping_pass(dev, cfg)
    state = convert.to_torch(
        E.mapping_variant(E.make_mapping_scene(cfg), n_tri=60, n_fuse=40).state, dev)
    n0 = cuda_match.LAUNCHES
    got = E.fetch_mapping(run(state))
    assert cuda_match.LAUNCHES == n0 + cfg.n_nb
    with _build.force_plain():
        ref = E.fetch_mapping(run(state))
    for k in ("good", "idx", "rows", "adds", "conflict", "n_bad"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["kf_R"], ref["kf_R"], atol=1e-4)
    np.testing.assert_allclose(got["kf_t"], ref["kf_t"], atol=1e-4)
    assert (got["adds"] >= 20).all() and int(got["conflict"].sum()) >= 1


def _e2e_mono_frames(n_frames: int):
    """The scene of `tests/test_e2e_mono.py` (a wall of squares at 3-6 m, a
    slow lateral arc), rendered in numpy: that file imports JAX."""
    H, W, f = 240, 320, 260.0
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-3.0, 3.0, 130), rng.uniform(-2.2, 2.2, 130),
                    rng.uniform(3.0, 6.0, 130)], -1).astype(np.float32)
    shades = rng.uniform(120, 250, 130).astype(np.float32)
    imgs = []
    for k in range(n_frames):
        s = k / (n_frames - 1)
        yaw = 0.04 * np.sin(2 * np.pi * s)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]],
                     np.float32)
        centre = np.array([1.6 * s, 0.15 * np.sin(4 * s), 0.5 * s], np.float32)
        Xc = (pts - centre) @ R.T
        img = np.full((H, W), 35.0, np.float32)
        for i in np.argsort(-Xc[:, 2]):  # far first
            if Xc[i, 2] < 0.5:
                continue
            u, v = f * Xc[i, 0] / Xc[i, 2] + W / 2, f * Xc[i, 1] / Xc[i, 2] + H / 2
            half = max(2, int(round(12.0 / Xc[i, 2] * 2)))
            ui, vi = int(round(u)), int(round(v))
            if 1 <= ui < W - 1 and 1 <= vi < H - 1:
                img[max(vi - half, 0):min(vi + half, H), max(ui - half, 0):min(ui + half, W)] = \
                    shades[i]
        imgs.append(img)
    return [f, f, W / 2, H / 2, 0, 0, 0, 0], (W, H), imgs


def test_system_on_card_equals_plain(dev):
    """Ten frames of the `test_e2e_mono` scene through the monocular System
    on the card: through the kernels and through their plain versions the
    same states and keyframe counts, camera centres within 1e-3 (the
    kernels are exact; only the BA's atomic sums reorder)."""
    params, wh, imgs = _e2e_mono_frames(12)

    def run():
        slam = System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, wh,
                      feat.OrbParams(n_features=400, n_levels=3), device=dev, Kmax=32, Pmax=4096)
        states = []
        for k, img in enumerate(imgs[:10]):
            slam.track_monocular(img, k * 0.1)
            states.append((slam.tracking_state.name, slam.n_keyframes))
        return states, slam.get_trajectory()

    n0 = (cuda_fast.LAUNCHES, cuda_match.LAUNCHES)
    got, (ts, pos) = run()
    assert cuda_fast.LAUNCHES == n0[0] + 10 and cuda_match.LAUNCHES > n0[1]
    with _build.force_plain():
        ref, (ts_p, pos_p) = run()
    assert got == ref and got[-1][0] == "OK"
    np.testing.assert_array_equal(ts, ts_p)
    np.testing.assert_allclose(pos, pos_p, atol=1e-3)


def test_system_tracks_2000_features_on_card(dev):
    """A System at 2000 features (ORB-SLAM3's KITTI setting) on the card:
    its B1 calls hold 2000 keys, and the frames after initialization track."""
    calls = []
    wrapped = cuda_match.hamming_top2

    def recording(*args):
        calls.append(args[1].shape[0])
        return wrapped(*args)

    cuda_match.hamming_top2 = recording
    try:
        rep = E.mono_replay(dev, 6, orb=feat.OrbParams(n_features=2000))
    finally:
        cuda_match.hamming_top2 = wrapped
    assert "OK" in rep.states and rep.states[-1] == "OK"
    assert calls and max(calls) == 2000


# --- Place recognition on the card --------------------------------------


def test_bow_transform_on_card_equals_cpu(dev):
    """The 97k-word tree's descent on the card equals the CPU's, word for
    word, on random descriptors, on the tree's own nodes and on invalid
    rows (the per-level argmin takes the first child on ties in both)."""
    import os

    from orbslam3_tpu_torch.io.vocab_io import load_binary_vocabulary
    from orbslam3_tpu_torch.ops import bow

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                        "ORBvoc_synth_100k.bin")
    voc = load_binary_vocabulary(path, dev)
    voc_h = bow.to_device(voc, "cpu")
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.integers(0, 256, (1000, 32), dtype=np.uint8),
                        voc_h.node_desc[rng.integers(1, voc.node_desc.shape[0], 500)].numpy()])
    valid = rng.random(len(d)) > 0.1
    got = bow.transform(voc, torch.from_numpy(d).to(dev), torch.from_numpy(valid).to(dev))
    ref = bow.transform(voc_h, torch.from_numpy(d), torch.from_numpy(valid))
    assert torch.equal(got.cpu(), ref) and (ref[torch.from_numpy(valid)] >= 0).all()
    v_c, v_h = bow.bow_vector(voc, got), bow.bow_vector(voc_h, ref)
    assert float((v_c.cpu() - v_h).abs().max()) <= 1e-6


def test_pose_graph_on_card_equals_cpu(dev):
    """The essential graph at config 1's Kmax 256 (a 1792 x 1792 float32
    solve): a drifted 256-keyframe chain with 2-hop edges and a loop edge,
    on the card within 1e-4 of the CPU."""
    from orbslam3_tpu_torch.ops import lie
    from orbslam3_tpu_torch.optim import pose_graph as pg

    K = 256
    rng = np.random.default_rng(1)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    w = np.stack([np.zeros(K), ang, np.zeros(K)], -1).astype(np.float32)
    R_true = lie.exp_so3(torch.from_numpy(w)).numpy().transpose(0, 2, 1)
    c = np.stack([3 * np.sin(ang), np.zeros(K), 3 - 3 * np.cos(ang)], -1)
    t_true = -np.einsum("kij,kj->ki", R_true, c).astype(np.float32)
    drift = lie.exp_so3(torch.from_numpy(rng.normal(0, 2e-3, (K, 3)).astype(np.float32))).numpy()
    R_est = np.einsum("kij,kjl->kil", np.cumprod(np.ones(K))[:, None, None] * drift, R_true)
    t_est = (t_true + np.cumsum(rng.normal(0, 5e-3, (K, 3)), 0)).astype(np.float32)
    ei, ej = [], []
    for hop in (1, 2):
        ei += list(range(K - hop))
        ej += list(range(hop, K))
    ei, ej = np.asarray(ei + [K - 1]), np.asarray(ej + [0])
    Rba = np.einsum("eij,ekj->eik", R_est[ej], R_est[ei])
    tba = t_est[ej] - np.einsum("eij,ej->ei", Rba, t_est[ei])
    Rba[-1] = R_true[0] @ R_true[K - 1].T
    tba[-1] = t_true[0] - Rba[-1] @ t_true[K - 1]
    arrays = dict(R=R_est.astype(np.float32), t=t_est, s=np.ones(K, np.float32),
                  fixed=np.arange(K) == 0, edge_i=ei.astype(np.int32), edge_j=ej.astype(np.int32),
                  edge_R=Rba.astype(np.float32), edge_t=tba.astype(np.float32),
                  edge_s=np.ones(len(ei), np.float32), edge_valid=np.ones(len(ei), bool),
                  edge_weight=np.r_[np.ones(len(ei) - 1), 5.0].astype(np.float32))
    out = {}
    for where in (dev, torch.device("cpu")):
        g = pg.PoseGraph(**{k: torch.from_numpy(np.array(v)).to(where) for k, v in arrays.items()})
        out[where.type] = [x.cpu() for x in pg.solve_pose_graph(g, iters=12)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


def test_global_ba_256_cameras_on_card_equals_cpu(dev):
    """Global BA at config 1's Kmax 256: every camera in the dense reduced
    system (1536 x 1536), 256 x 256 observation rows, on the card within
    1e-4 of the CPU (`tests/loop_scene.py::make_ba_map`, stereo rows on
    every eighth keyframe fix the scale)."""
    import loop_scene as LS

    from orbslam3_tpu_torch.atlas import store as st
    from orbslam3_tpu_torch.optim import ba as ba_mod
    from orbslam3_tpu_torch.pipeline import gba

    K = 256
    arrays, info = LS.make_ba_map(K=K, Kmax=K, Pmax=2048, stereo=tuple(range(1, K, 8)))
    rng = np.random.default_rng(2)
    arrays["kf_t"][1:K] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    arrays["mp_pos"][1:info["n_mp"]] += rng.normal(0, 0.05, (info["n_mp"] - 1, 3)).astype(
        np.float32)
    assert ba_mod.auto_dense_schur(K, 16384)
    out = {}
    for where in (dev, torch.device("cpu")):
        store = st.MapStore(Kmax=K, Pmax=2048, Nf=256, device=where)
        store.state = st.MapState(**{k: torch.from_numpy(np.array(v)).to(where)
                                     for k, v in arrays.items()})
        store.n_kf, store.n_mp, store.kf_ts = K, info["n_mp"], info["kf_ts"]
        t0 = store.state.kf_t.clone()
        gba.global_ba(store, CameraModel.PINHOLE, torch.from_numpy(LS.PARAMS.copy()).to(where),
                      torch.from_numpy(feat.sigma2(feat.OrbParams(n_levels=4))).to(where), bf=30.0)
        out[where.type] = store.state
        assert float((store.state.kf_t - t0).abs().max()) > 1e-3
    for k in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(getattr(out["cuda"], k).cpu().numpy(),
                                   getattr(out["cpu"], k).numpy(), rtol=0, atol=1e-4, err_msg=k)


def test_camera_sums_on_card_repeat_and_equal_cpu(dev):
    """`optim/ba.py::CameraSums` on the card, the per-camera sums of both
    BAs (the one-hot product, set up once per solve): at the whole-map BA's
    shape (256 cameras x 1000 rows each, 42 values a row, rows of one
    camera spread over the array), two calls are equal bit for bit and
    within 1e-3 (float32 sums of 1000 rows) of the CPU's `index_add_`."""
    from orbslam3_tpu_torch.optim import ba as ba_mod

    rng = np.random.default_rng(5)
    C, per = 256, 1000
    oc = torch.from_numpy(rng.permutation(np.repeat(np.arange(C), per)))
    vals = torch.from_numpy(rng.normal(size=(C * per, 42)).astype(np.float32))
    ref = ba_mod.CameraSums(oc, C)(vals)
    sums = ba_mod.CameraSums(oc.to(dev), C)
    assert sums.onehot is not None and sums.onehot.shape == (C * per, C)
    a, b = sums(vals.to(dev)), sums(vals.to(dev))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)


def test_stereo_match_and_remap_on_card_equal_cpu(dev):
    """The scanline match on a rendered pair of the stereo test scene, from
    the same features, and the raw-stereo remap of one synthetic EuRoC pair:
    the card's results equal the CPU's (valid sets equal; `ur` and depth
    within 1e-4; the remap within 1e-4 grey levels)."""
    import stereo_scene as scene
    from orbslam3_tpu_torch.ops import stereo
    from orbslam3_tpu_torch.ops.rectify import StereoRectifier

    pts, shades = scene.make_world()
    R, t = scene.camera_path()[8]
    imgs = [scene.render(R, t - np.array([b, 0, 0], np.float32), pts, shades)
            for b in (0.0, scene.BASELINE)]
    orb = feat.OrbParams(n_features=400, n_levels=3)
    scale = feat.scale_factors(orb)
    il, ir = (convert.tensor(x, dev) for x in imgs)
    fl, fr_ = feat.extract(il, orb), feat.extract(ir, orb)
    got = stereo.match_stereo_rectified(fl, fr_, il, ir, scene.BF, convert.tensor(scale, dev))
    cpu = lambda f: type(f)(*(x.cpu() for x in f))  # noqa: E731 (the card's features)
    want = stereo.match_stereo_rectified(cpu(fl), cpu(fr_), torch.from_numpy(imgs[0]),
                                         torch.from_numpy(imgs[1]), scene.BF,
                                         torch.from_numpy(scale))
    np.testing.assert_array_equal(got.valid.cpu().numpy(), want.valid.numpy())
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4, rtol=0)
    assert int(want.valid.sum()) > 50
    _, raw, _ = E.euroc_frames(1, raw=True)
    rig = E.raw_stereo_rig()
    for a, b in zip(StereoRectifier(*rig, dev)(raw[0, 0], raw[0, 1]),
                    StereoRectifier(*rig, "cpu")(raw[0, 0], raw[0, 1])):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4, rtol=0)


def _vi_inputs(seed: int = 0):
    """numpy inputs of the inertial checks: 11 IMU samples of a frame gap, a
    keyframe body state, a frame 0.05 s on seen by 300 points (mono and
    stereo rows, 10% outliers), and a perturbed guess."""
    from orbslam3_tpu_torch.ops import lie

    rng = np.random.default_rng(seed)
    acc = (np.array([0, 0, 9.81]) + rng.normal(0, 0.5, (11, 3))).astype(np.float32)
    gyro = rng.normal(0, 0.2, (11, 3)).astype(np.float32)
    dt = np.full(11, 0.00455, np.float32)
    R = lie.exp_so3(torch.tensor([0.02, -0.01, 0.03])).numpy()
    p = np.array([0.02, -0.01, 0.01], np.float32)
    n = 300
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 6, n)],
                  -1).astype(np.float32)
    Xc = (Xw - p) @ R
    uv = 300.0 * Xc[:, :2] / Xc[:, 2:] + np.array([320.0, 240.0])
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random(n) < 0.1
    uv[out] += 40.0
    ur = np.where(rng.random(n) < 0.5, uv[:, 0] - 33.0 / Xc[:, 2], -1.0)
    return dict(acc=acc, gyro=gyro, dt=dt, R=R, p=p, Xw=Xw, uv=uv.astype(np.float32),
                ur=ur.astype(np.float32), sigma2=np.ones(n, np.float32),
                valid=np.ones(n, bool), v=np.array([0.3, -0.1, 0.05], np.float32))


def test_preintegration_and_pose_inertial_on_card_equal_cpu(dev):
    """The preintegration of a frame gap, and both pose-inertial solves
    (last keyframe, then last frame under the first's prior), on the card
    and on the CPU from the same inputs: the windows within 1e-5 of their
    largest entry; the same inliers; poses, velocity and biases within 1e-4;
    H within 1e-3 of its largest entry. Under `set_sync_debug_mode("warn")`
    neither solve makes a host sync (the prior's PSD clamp runs on the
    host copy)."""
    import warnings

    from orbslam3_tpu_torch.ops import imu as imu_t
    from orbslam3_tpu_torch.optim import pose_inertial as pi
    from orbslam3_tpu_torch.optim.pose_only import PoseObs

    d = _vi_inputs()
    out = {}
    for where in ("cpu", dev):
        card = str(where) != "cpu"
        T = lambda x: convert.tensor(x, where)  # noqa: E731
        calib = imu_t.ImuCalib.create(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0,
                                      device=where)
        z3 = torch.zeros(3, device=where)
        pre = imu_t.integrate(T(d["acc"]), T(d["gyro"]), T(d["dt"]), z3, z3, calib)
        obs = PoseObs(Xw=T(d["Xw"]), uv=T(d["uv"]), ur=T(d["ur"]), sigma2=T(d["sigma2"]),
                      valid=T(d["valid"]))
        params = torch.tensor([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0], device=where)
        eye = torch.eye(3, device=where)
        args = (CameraModel.PINHOLE, params, obs, eye, z3)
        if card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")  # its own notice comes before the record
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            r1 = pi.optimize_pose_inertial(*args, eye, z3, T(d["v"]), z3, z3, pre, T(d["R"]),
                                           T(d["p"]) + 0.02, T(d["v"]), bf=33.0)
            H_host = out["cpu"][0].H if card else r1.H.numpy()
            r2 = pi.optimize_pose_inertial_last_frame(
                *args, eye, z3, T(d["v"]), z3, z3, H_host, pre, T(d["R"]), T(d["p"]) - 0.01,
                T(d["v"]), bf=33.0)
        if card:
            torch.cuda.set_sync_debug_mode("default")
            assert not [w for w in caught if "synchroniz" in str(w.message)], caught
        out[str(where)] = (convert.to_numpy(r1), convert.to_numpy(r2), convert.to_numpy(pre))
    c, g = out["cpu"], out[str(dev)]
    for a, b in zip(c[2], g[2]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * max(np.abs(a).max(), 1e-30))
    for rc, rg in zip(c[:2], g[:2]):
        np.testing.assert_array_equal(rg.inlier, rc.inlier)
        for name in ("R_wb", "p_wb", "v", "bg", "ba", "Rcw", "tcw"):
            np.testing.assert_allclose(getattr(rg, name), getattr(rc, name), atol=1e-4)
        np.testing.assert_allclose(rg.H, rc.H, atol=1e-3 * np.abs(rc.H).max())


def _fisheye_features(where):
    """Features of config 4's first fisheye pair (512x512, 1000 features on
    8 levels) extracted on `where`, and the pair."""
    _, imgs, _ = E.euroc_frames(1, 0, fisheye=True)
    orb = E.EUROC_STEREO_VI_FISHEYE["orb"]
    pair = [torch.from_numpy(imgs[0, i].astype(np.float32)).to(where) for i in (0, 1)]
    return [feat.extract(im, orb) for im in pair], pair


def test_fisheye_kernels_equal_plain_on_card(dev):
    """Config 4's new call sites: B2 on the 512x512 fisheye atlas (left and
    right) and B1 at the fisheye match (unwindowed, both directions), each
    exactly equal to its plain version, one launch a call."""
    orb = E.EUROC_STEREO_VI_FISHEYE["orb"]
    (fl, fr_), pair = _fisheye_features(dev)
    for img in pair:
        atlas = feat.build_atlas(img, orb)
        n0 = cuda_fast.LAUNCHES
        got = cuda_fast.fast_score_nms(atlas, orb.min_th, orb.ini_th)
        assert cuda_fast.LAUNCHES == n0 + 1
        ref = feat.fast_score_nms_plain(atlas, orb.min_th, orb.ini_th)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert int(got[1].sum()) > 500
    for a, b, vb in ((fl.desc, fr_.desc, fr_.valid), (fr_.desc, fl.desc, fl.valid)):
        n0 = cuda_match.LAUNCHES
        got = cuda_match.hamming_top2(a, b, vb)
        assert cuda_match.LAUNCHES == n0 + 1
        with _build.force_plain():
            ref = cuda_match.hamming_top2(a, b, vb)
        for k_, p_ in zip(got, ref):
            assert torch.equal(k_, p_)


def test_match_stereo_fisheye_on_card_equals_cpu(dev):
    """`match_stereo_fisheye` on config 4's first pair from the same
    features: indices and the valid set equal on the card and the CPU, depth
    and points within 1e-4 m; most left keypoints matched."""
    from orbslam3_tpu_torch.ops import stereo

    cfg = E.EUROC_STEREO_VI_FISHEYE
    (fl, fr_), _ = _fisheye_features("cpu")
    params2, Tlr, lap1, lap2 = cfg["camera2"]
    R_rl = Tlr[:3, :3].T.astype(np.float32)
    t_rl = (-R_rl @ Tlr[:3, 3]).astype(np.float32)
    out = {}
    for where in ("cpu", dev):
        T = lambda x: convert.tensor(np.asarray(x, np.float32), where)  # noqa: E731
        mv = lambda f: feat.Features(*(x.to(where) for x in f))  # noqa: E731
        s2 = T(feat.sigma2(cfg["orb"]))
        res = stereo.match_stereo_fisheye(CameraModel.KB8, T(cfg["camera"]), T(params2), mv(fl),
                                          mv(fr_), T(R_rl), T(t_rl), s2, lap_l=lap1, lap_r=lap2)
        out[str(where)] = convert.to_numpy(res)
    c, g = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(g.valid, c.valid)
    np.testing.assert_array_equal(g.right_idx, c.right_idx)
    np.testing.assert_allclose(g.depth, c.depth, atol=1e-4, rtol=0)
    np.testing.assert_allclose(g.Xl[c.valid], c.Xl[c.valid], atol=1e-4, rtol=0)
    assert c.valid.sum() > 300


def test_rig_pose_solve_on_card_without_sync(dev):
    """The tracker's pose solve with a rig's right-camera rows
    (`_pose_opt_from_assoc(rig=...)`, KB8 pair) makes no host sync on the
    card (`set_sync_debug_mode("warn")`), and equals the CPU's: the same
    inliers, the pose within 1e-4."""
    import warnings

    from orbslam3_tpu_torch.ops import lie
    from orbslam3_tpu_torch.ops.cameras import kb8_project
    from orbslam3_tpu_torch.pipeline import tracking as trk

    cfg = E.EUROC_STEREO_VI_FISHEYE
    params2, Tlr, _, _ = cfg["camera2"]
    rng = np.random.default_rng(5)
    n, P = 1000, 4096
    Xw = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n), rng.uniform(1, 5, n)],
                  -1).astype(np.float32)
    R_rl = Tlr[:3, :3].T.astype(np.float32)
    t_rl = (-R_rl @ Tlr[:3, 3]).astype(np.float32)
    pl, pr = (torch.tensor(np.asarray(p, np.float32)) for p in (cfg["camera"], params2))
    uv_l = kb8_project(pl, torch.from_numpy(Xw)).numpy() + rng.normal(0, 0.5, (n, 2))
    uv_r = kb8_project(pr, torch.from_numpy(Xw @ R_rl.T + t_rl)).numpy() + rng.normal(0, 0.5, (n, 2))
    mp_pos = np.zeros((P, 3), np.float32)
    mp_pos[1:n + 1] = Xw
    assoc = np.arange(1, n + 1, dtype=np.int32)
    assoc[rng.uniform(size=n) < 0.2] = -1
    has_r = rng.uniform(size=n) < 0.6
    s2 = feat.sigma2(cfg["orb"])
    octave = rng.integers(0, 4, n).astype(np.int32)
    out = {}
    for where in ("cpu", dev):
        T = lambda x: convert.tensor(np.asarray(x), where)  # noqa: E731
        f = feat.Features(uv=T(uv_l.astype(np.float32)), response=T(np.ones(n, np.float32)),
                          octave=T(octave), angle=T(np.zeros(n, np.float32)),
                          desc=T(np.zeros((n, 32), np.uint8)), valid=T(np.ones(n, bool)))
        mp_valid = T(np.arange(P) <= n)
        R0, t0 = lie.exp_se3(T(np.array([0.02, -0.01, 0.03, 0.01, 0.02, -0.01], np.float32)))
        rig = (T(pr.numpy()), T(R_rl), T(t_rl), T(uv_r.astype(np.float32)),
               T(s2[octave]), T(has_r))
        if str(where) != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = trk._pose_opt_from_assoc(CameraModel.KB8, T(pl.numpy()), R0, t0, T(assoc), f,
                                           T(mp_pos), mp_valid, T(s2), rig=rig)
        if str(where) != "cpu":
            torch.cuda.set_sync_debug_mode("default")
            assert not [w for w in caught if "synchroniz" in str(w.message)], caught
        out[str(where)] = convert.to_numpy(res)
    c, g = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(g.inlier, c.inlier)
    np.testing.assert_allclose(g.R, c.R, atol=1e-4)
    np.testing.assert_allclose(g.t, c.t, atol=1e-4)
    assert c.inlier.sum() > 0.7 * n and np.abs(c.t).max() < 1e-2  # back to the true pose

