"""Port parity: the rectified scanline match and the RGB-D depth lookup
(`orbslam3_tpu_torch/ops/stereo.py`) against `orbslam3_tpu/ops/stereo.py` on
the CPU, both fed the same features (the JAX package's) and the same
images.

Tolerances: the valid sets equal; `ur` and depth within 1e-4 (the SADs are
exact integers on both sides; only the float32 parabola and the division
bf / disparity can round differently); `depth_to_ur` exactly.

The median-SAD cut (ROADMAP C11) is held on hand-made pairs whose SADs are
set by a contrast gain per keypoint: every row matched (the cut acts), one
row unmatched (the reference's NaN median turns the cut off), and an even
count where the reference's midpoint median keeps a row that
`torch.nanmedian`'s lower middle value would cut.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import stereo as stereo_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import stereo as stereo_t
import stereo_scene as scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = dict(n_features=400, n_levels=3)


def _run_both(fl, fr_, img_l, img_r, bf, scale):
    """(JAX result, port result) as numpy, from numpy Features."""
    got_j = stereo_j.match_stereo_rectified(
        feat_j.Features(*(jnp.asarray(x) for x in fl)),
        feat_j.Features(*(jnp.asarray(x) for x in fr_)),
        jnp.asarray(img_l, jnp.float32), jnp.asarray(img_r, jnp.float32), bf, jnp.asarray(scale))
    got_t = stereo_t.match_stereo_rectified(
        convert.to_torch(fl, "cpu", feat_t.Features), convert.to_torch(fr_, "cpu", feat_t.Features),
        torch.from_numpy(np.asarray(img_l, np.float32)),
        torch.from_numpy(np.asarray(img_r, np.float32)), bf, torch.from_numpy(scale))
    return ([np.asarray(x) for x in got_j], [x.numpy() for x in got_t])


def _assert_equal(got_j, got_t):
    (ur_j, d_j, v_j), (ur_t, d_t, v_t) = got_j, got_t
    np.testing.assert_array_equal(v_t, v_j)
    np.testing.assert_allclose(ur_t, ur_j, atol=1e-4, rtol=0)
    np.testing.assert_allclose(d_t, d_j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("frame", [0, 8, 15])
def test_match_stereo_rectified_on_a_rendered_pair(frame):
    """The drive scene's pair (320x240, 400 features on 3 levels): the same
    valid set, `ur` and depth as the reference, most depths near the truth."""
    pts, shades = scene.make_world()
    R, t = scene.camera_path()[frame]
    img_l = scene.render(R, t, pts, shades)
    img_r = scene.render(R, t - np.array([scene.BASELINE, 0, 0], np.float32), pts, shades)
    orb = feat_j.OrbParams(**ORB)
    fl, fr_ = (type(f)(*(np.asarray(x) for x in f))
               for f in (feat_j.extract(jnp.asarray(img), orb) for img in (img_l, img_r)))
    got_j, got_t = _run_both(fl, fr_, img_l, img_r, scene.BF, feat_j.scale_factors(orb))
    _assert_equal(got_j, got_t)
    ok = got_t[2]
    assert ok.sum() > 50
    d = got_t[1][ok]  # the squares lie at 3-6 m
    assert 3.0 < np.median(d) < 6.0 and np.mean((d > 2.5) & (d < 7.5)) > 0.9


def _gain_pair(gains, unmatched: int = 0, seed: int = 11):
    """Hand-made features and images: keypoint i at (100, 8 + 12 i) with its
    right partner 10 px left (the same descriptor; every other pair is
    > 75 bits apart), one 11x41 texture block around every keypoint, the
    right image the left shifted by 10 px with the contrast around
    keypoint i scaled by gains[i], so its SAD at the true shift is
    |gains[i] - 1| times the block's. `unmatched` more left keypoints have
    no partner. Returns (fl, fr, img_l, img_r, the true-shift SADs)."""
    rng = np.random.default_rng(seed)
    n = len(gains) + unmatched
    H, W, u, d = 16 + 12 * n, 200, 100, 10
    block = rng.integers(40, 216, (11, 41)).astype(np.float32)
    img_l = np.full((H, W), 128.0, np.float32)
    rows = 8 + 12 * np.arange(n)
    for v in rows:
        img_l[v - 5:v + 6, u - 20:u + 21] = block
    img_r = np.roll(img_l, -d, axis=1)
    for v, g in zip(rows, gains):
        reg = img_r[v - 5:v + 6, u - d - 20:u - d + 21]
        img_r[v - 5:v + 6, u - d - 20:u - d + 21] = np.clip(np.round(128 + g * (reg - 128)), 0, 255)
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)

    def feats(uv, dsc):
        m = len(uv)
        return feat_j.Features(uv=np.asarray(uv, np.float32), response=np.ones(m, np.float32),
                               octave=np.zeros(m, np.int32), angle=np.zeros(m, np.float32),
                               desc=dsc, valid=np.ones(m, bool))

    fl = feats([(u, v) for v in rows], desc)
    fr_ = feats([(u - d, v) for v in rows[:len(gains)]], desc[:len(gains)])

    def centred(img, x, y):
        p = img[y - 5:y + 6, x - 5:x + 6]
        return p - p[5, 5]

    sads = np.array([np.abs(centred(img_r, u - d, v) - centred(img_l, u, v)).sum()
                     for v in rows[:len(gains)]])
    return fl, fr_, img_l, img_r, sads


def test_c11_median_cut_acts_when_every_row_matches():
    """Every left row matched: the median exists and the cut removes the
    high-contrast row (SAD above 2.1 x the median), in both packages."""
    gains = [1.0, 1.02, 1.05, 1.05, 1.08, 1.1, 1.1, 1.6]
    fl, fr_, img_l, img_r, sads = _gain_pair(gains)
    assert sads[-1] > 2.1 * np.median(sads)
    got_j, got_t = _run_both(fl, fr_, img_l, img_r, 40.0, np.ones(1, np.float32))
    _assert_equal(got_j, got_t)
    assert got_t[2].tolist() == [True] * 7 + [False]
    np.testing.assert_allclose(fl.uv[:7, 0] - got_t[0][:7], 10.0, atol=0.5)


def test_c11_median_cut_is_off_when_a_row_is_unmatched():
    """One left row without a partner: the reference's median is NaN, read
    as +inf, so the high-contrast row stays; the port keeps it too (a NaN-
    skipping median would cut it)."""
    gains = [1.0, 1.02, 1.05, 1.05, 1.08, 1.1, 1.1, 1.6]
    fl, fr_, img_l, img_r, sads = _gain_pair(gains, unmatched=1)
    assert sads[-1] > 2.1 * float(torch.from_numpy(sads).float().nanmedian())
    got_j, got_t = _run_both(fl, fr_, img_l, img_r, 40.0, np.ones(1, np.float32))
    _assert_equal(got_j, got_t)
    assert got_t[2].tolist() == [True] * 8 + [False]


def test_c11_even_count_uses_the_midpoint_median():
    """Four matched rows: the largest SAD lies between 2.1 x the lower
    middle value (`torch.nanmedian`'s median, which would cut it) and 2.1 x
    the midpoint (the reference's, which keeps it). Both packages keep it."""
    fl, fr_, img_l, img_r, sads = _gain_pair([1.1, 1.2, 1.4, 1.5])
    s = np.sort(sads)
    lower = float(torch.from_numpy(sads).float().nanmedian())
    assert lower == s[1] and 2.1 * lower < sads[3] <= 2.1 * (s[1] + s[2]) / 2
    got_j, got_t = _run_both(fl, fr_, img_l, img_r, 40.0, np.ones(1, np.float32))
    _assert_equal(got_j, got_t)
    assert got_t[2].tolist() == [True] * 4


@pytest.mark.parametrize("vals,ok", [
    ([1.0, 2.0, 3.0, 4.0], [True] * 4),
    ([5.0, 1.0, 3.0], [True] * 3),
    ([1.0, 2.0, 3.0, 4.0], [True, True, False, True]),
    ([7.0, 7.0, 2.0, 9.0, 4.0, 4.0], [True] * 6),
])
def test_median_like_reference(vals, ok):
    """`jnp.median` over the ok rows with NaN elsewhere, NaN read as +inf."""
    x, m = np.asarray(vals, np.float32), np.asarray(ok)
    want = float(jnp.median(jnp.where(jnp.asarray(m), jnp.asarray(x), jnp.nan)))
    want = np.inf if np.isnan(want) else want
    assert float(stereo_t._median_like_reference(torch.from_numpy(x), torch.from_numpy(m))) == want


def test_depth_to_ur_is_exact():
    """Keypoints on half pixels (rounded half to even on both sides), at the
    borders and beyond, on a depth map with holes: ur, depth and validity
    equal exactly."""
    rng = np.random.default_rng(3)
    H, W = 48, 64
    depth = rng.uniform(0.3, 8.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    uv = np.concatenate([rng.uniform(-3, W + 3, (200, 2)),
                         np.floor(rng.uniform(0, 40, (50, 2))) + 0.5]).astype(np.float32)
    valid = rng.random(len(uv)) > 0.1
    got_j = stereo_j.depth_to_ur(jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(depth), 50.38)
    got_t = stereo_t.depth_to_ur(torch.from_numpy(uv), torch.from_numpy(valid),
                                 torch.from_numpy(depth), 50.38)
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got_t.valid.sum() > 100
