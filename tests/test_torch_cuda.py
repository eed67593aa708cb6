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
