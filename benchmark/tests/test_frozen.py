"""The frozen copies against the port: the generator (`benchmark/synth.py`)
gives `entry.euroc_frames`' first frames, camera centres and IMU stream for
seed 0 on the 60 s lap and the 8 s lap, and its rectified pair, kidnap
and blind interval, from its views as ray-cast or as read back from the
cache; the bounds (`benchmark/bounds.py`) are `kernel_bench`'s; the
alignment is `ate.py`'s; the reference's extraction and Hamming top-2 equal
the port's plain paths on the CPU."""

import numpy as np
import pytest

from benchmark import synth


@pytest.mark.parametrize("t_loop", [None, 8.0])
def test_copy_equals_euroc_frames(t_loop):
    from orbslam3_tpu_torch import entry

    ts, imgs, centres, (t_imu, acc, gyro) = entry.euroc_frames(3, seed=0, t_loop=t_loop,
                                                                imu=True)
    rec = synth.record(0, 3, t_loop=t_loop or synth.T_LOOP, imu=True)
    assert np.array_equal(rec.ts, ts)
    assert np.array_equal(rec.imgs, imgs)
    assert np.array_equal(rec.centres, centres)
    assert np.array_equal(rec.imu[0], t_imu)
    assert np.array_equal(rec.imu[1], acc)
    assert np.array_equal(rec.imu[2], gyro)


@pytest.mark.parametrize("events", [dict(kidnap=(2, 0)), dict(blind=(1, 2)),
                                    dict(stereo=True, kidnap=(1, 0))])
def test_events_equal_euroc_frames(events, tmp_path):
    from orbslam3_tpu_torch import entry

    ts, imgs, centres = entry.euroc_frames(4, seed=0, t_loop=8.0, **events)
    kw = dict(kidnap=events.get("kidnap"), blind=events.get("blind"),
              baseline=0.11 if events.get("stereo") else None)
    for _ in range(2):  # ray-cast and kept, then read back
        rec = synth.record(0, 4, t_loop=8.0, cache_dir=tmp_path, **kw)
        assert np.array_equal(rec.imgs, imgs)
        assert np.array_equal(rec.centres, centres)
        assert np.array_equal(rec.ts, ts)
    assert len(list(tmp_path.glob("views-*.npy"))) == 1


def test_seed_moves_the_noise_not_the_room(tmp_path):
    small = dict(wh=(64, 48), intr=(40.0, 40.0, 32.0, 24.0), cache_dir=tmp_path)
    a, b = synth.record(1, 2, **small), synth.record(2, 2, **small)
    assert not np.array_equal(a.imgs, b.imgs)
    assert np.abs(a.imgs.astype(float) - b.imgs).mean() < 3.0  # noise of 1.5 grey levels
    assert len(list(tmp_path.glob("views-*.npy"))) == 1


def test_batches_cover_the_stream_once():
    rec = synth.record(5, 4, imu=True, wh=(64, 48), intr=(40.0, 40.0, 32.0, 24.0))
    batches = synth.imu_batches(rec.ts, rec.imu)
    assert sum(len(b) for b in batches) == len(rec.imu[0])
    for t, b in zip(rec.ts, batches):
        assert all(s[0] <= t for s in b)


def test_large_seed_is_accepted():
    a = synth.record(2**31 + 7, 2, wh=(64, 48), intr=(40.0, 40.0, 32.0, 24.0))
    b = synth.record(2**31 + 7, 2, wh=(64, 48), intr=(40.0, 40.0, 32.0, 24.0))
    assert np.array_equal(a.imgs, b.imgs)


def test_bounds_equal_kernel_bench():
    import torch

    from benchmark import bounds
    from orbslam3_tpu_torch import kernel_bench
    from orbslam3_tpu_torch.ops.cuda_match import MatchWindow

    g = torch.Generator().manual_seed(1)
    n, m = 300, 200
    a = torch.randint(0, 256, (n, 32), dtype=torch.uint8, generator=g)
    b = torch.randint(0, 256, (m, 32), dtype=torch.uint8, generator=g)
    valid = torch.rand(m, generator=g) > 0.3
    w = MatchWindow(torch.rand(n, 2, generator=g) * 100, torch.rand(m, 2, generator=g) * 100,
                    torch.full((n,), 15.0), torch.randint(0, 8, (m,), dtype=torch.int32,
                                                          generator=g),
                    torch.zeros(n, dtype=torch.int32), torch.full((n,), 3, dtype=torch.int32))
    for valid_b, win in ((None, None), (valid, None), (valid, w)):
        ref = kernel_bench.b1_bound(a, b, valid_b, win)
        got = bounds.b1_bound(n, m, valid_b, None if win is None else tuple(win))
        assert got["bytes"] == ref["bytes"] and got["ops"] == ref["ops"]
        assert abs(got["bound_us"] - ref["bound_us"]) < 1e-12
    atlas = torch.zeros(2400, 768)
    assert bounds.b2_bound(2400, 768)["bound_us"] == kernel_bench.b2_bound(atlas)["bound_us"]


def test_alignment_equals_the_ports():
    from benchmark.reference import trajectory
    from orbslam3_tpu_torch import ate

    rng = np.random.default_rng(3)
    gt = rng.normal(size=(50, 3))
    est = 0.7 * gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + 0.3
    est += rng.normal(scale=0.01, size=est.shape)
    ts = np.arange(50) / 20
    for scale in (True, False):
        assert abs(trajectory.ate(est, gt, scale)[0]
                   - ate.ate_rmse(ts, est, ts, gt, with_scale=scale)) < 1e-12


def test_reference_extraction_equals_the_ports_plain_path():
    import torch

    from benchmark.reference import orb
    from orbslam3_tpu_torch.ops import features

    img = torch.from_numpy(synth.record(4, 1).imgs[0]).to(torch.float32)
    got, ref = orb.extract(img), features.extract(img)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_reference_top2_equals_the_ports_plain_path():
    import torch

    from benchmark.reference import match
    from orbslam3_tpu_torch.ops import cuda_match

    g = torch.Generator().manual_seed(2)
    n, m = 700, 300
    a = torch.randint(0, 256, (n, 32), dtype=torch.uint8, generator=g)
    b = torch.randint(0, 256, (m, 32), dtype=torch.uint8, generator=g)
    valid = torch.rand(m, generator=g) > 0.2
    w = cuda_match.MatchWindow(torch.rand(n, 2, generator=g) * 100,
                               torch.rand(m, 2, generator=g) * 100, torch.full((n,), 20.0),
                               torch.randint(0, 8, (m,), dtype=torch.int32, generator=g),
                               torch.zeros(n, dtype=torch.int32),
                               torch.full((n,), 4, dtype=torch.int32))
    for win in (None, w):
        port = cuda_match.hamming_top2(a, b, valid, win)
        ref = match.top2(a, b, valid, None if win is None else tuple(win))
        for x, y in zip(port, ref):
            assert torch.equal(x, y)
