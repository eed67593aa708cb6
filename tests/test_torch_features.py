"""Port parity: ORB extraction (`orbslam3_tpu_torch.ops.features`) and the
plain version of kernel B2 against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import pallas_fast
from orbslam3_tpu_torch import kernel_bench
from orbslam3_tpu_torch.ops import _build, cuda_fast
from orbslam3_tpu_torch.ops import features as feat_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

SMALL = dict(n_features=300, n_levels=3)


def _render(rng, H=240, W=320):
    """Blocks on a flat background plus noise, rounded to grey levels like a
    pyramid level (the atlas holds integers)."""
    img = np.full((H, W), 40.0, np.float32)
    for _ in range(120):
        y, x = rng.integers(5, H - 20), rng.integers(5, W - 20)
        s = rng.integers(4, 16)
        img[y : y + s, x : x + s] = rng.uniform(60, 250)
    return np.round(img + rng.normal(0, 1.0, (H, W))).astype(np.float32)


def _reference_atlas(image: np.ndarray, params) -> np.ndarray:
    """The atlas the reference's `extract` builds (features.py:404-411)."""
    H, W = image.shape
    offs, sizes, HA, WA = feat_j._atlas_layout(H, W, params)
    atlas = jnp.zeros((HA, WA), jnp.float32)
    img = jnp.asarray(image)
    for lvl, ((h, w), o) in enumerate(zip(sizes, offs)):
        lvl_img = img if lvl == 0 else jax.image.resize(img, (h, w), method="bilinear")
        atlas = jax.lax.dynamic_update_slice(atlas, jnp.round(lvl_img), (o, 0))
    return np.array(atlas)  # writable: torch.from_numpy takes it


@pytest.mark.parametrize("H,W,n_levels", [(480, 752, 8), (240, 320, 3)])
def test_pyramid_differs_by_at_most_two_pixels_per_level(H, W, n_levels):
    """Resize weights are rebuilt in numpy and applied as two float32
    matmuls in another summation order than XLA's einsum: a level value
    that lands within rounding error of .5 can round the other way. At
    most 2 pixels per level, each by exactly 1 grey level."""
    rng = np.random.default_rng(H)
    image = rng.uniform(0, 255, (H, W)).astype(np.float32)
    params = feat_t.OrbParams(n_features=1000, n_levels=n_levels)
    ref = _reference_atlas(image, feat_j.OrbParams(n_features=1000, n_levels=n_levels))
    got = feat_t.build_atlas(torch.from_numpy(image), params).numpy()
    offs, sizes, _, _ = feat_t._atlas_layout(H, W, params)
    for (h, w), o in zip(sizes, offs):
        diff = np.abs(got[o : o + h, :w] - ref[o : o + h, :w])
        assert int((diff > 0).sum()) <= 2, (h, w, int((diff > 0).sum()))
        assert diff.max() <= 1.0
    np.testing.assert_array_equal(got == 0, ref == 0)  # gaps and padding


def test_fast_plain_equals_xla_and_pallas_on_interior():
    """Exact: on an integer-valued image every ring difference, threshold
    test and score sum is exact in float32, whatever the order. Pixels
    within 4 of the border differ by design (the reference wraps with
    jnp.roll, the port pads with zeros; the extractor masks 19 px)."""
    img = _render(np.random.default_rng(0))
    score_x, ini_x = feat_j.fast_score(jnp.asarray(img), 7.0, 20.0)
    score_x = np.asarray(feat_j._nms3(score_x))
    score_p, ini_p = pallas_fast.fast_score_nms_pallas(jnp.asarray(img), 7.0, 20.0,
                                                        interpret=True)
    score_t, ini_t = feat_t.fast_score_nms_plain(torch.from_numpy(img), 7.0, 20.0)
    b = 4
    inner = (slice(b, -b), slice(b, -b))
    np.testing.assert_array_equal(score_t.numpy()[inner], score_x[inner])
    np.testing.assert_array_equal(ini_t.numpy()[inner], np.asarray(ini_x)[inner])
    np.testing.assert_array_equal(score_t.numpy()[inner], np.asarray(score_p)[inner])
    np.testing.assert_array_equal(ini_t.numpy()[inner], np.asarray(ini_p)[inner])
    assert (score_x[inner] > 0).sum() > 50  # the scene produced corners
    # The wrapper takes the plain version on a CPU tensor, without a launch.
    n0 = cuda_fast.LAUNCHES
    s_w, i_w = cuda_fast.fast_score_nms(torch.from_numpy(img), 7.0, 20.0)
    assert cuda_fast.LAUNCHES == n0
    np.testing.assert_array_equal(s_w.numpy(), score_t.numpy())
    np.testing.assert_array_equal(i_w.numpy(), ini_t.numpy())


B2_CASES = dict(kernel_bench.b2_cases())


@pytest.mark.parametrize("name", ["plateau", "7x7", "5x300"])
def test_fast_plain_equals_xla_on_plateau_and_small_images(name):
    """The plain version equals the reference's XLA path (`fast_score` +
    `_nms3`) on kernel B2's plateau image (equal scores side by side, all
    kept) and on images smaller than its 4-px halo. The reference wraps at
    the border (`jnp.roll`); given the image inside a 4-px zero margin, its
    taps read the zeros the port pads with, so the two agree on every pixel
    whose 3x3 NMS window lies in the image, and on pass_ini everywhere."""
    img = B2_CASES[name]
    score_t, ini_t = feat_t.fast_score_nms_plain(torch.from_numpy(img), 7.0, 20.0)
    padded = jnp.pad(jnp.asarray(img), 4)
    score_x, ini_x = feat_j.fast_score(padded, 7.0, 20.0)
    inside = (slice(4, -4), slice(4, -4))
    score_x = np.asarray(feat_j._nms3(score_x))[inside]
    np.testing.assert_array_equal(ini_t.numpy(), np.asarray(ini_x)[inside])
    inner = (slice(1, -1), slice(1, -1))
    np.testing.assert_array_equal(score_t.numpy()[inner], score_x[inner])
    s = score_t.numpy()
    assert (s[inner] > 0).sum() > 0
    if name == "plateau":  # equal neighbours that both survive the NMS
        assert (((s[:, 1:] == s[:, :-1]) & (s[:, 1:] > 0)).sum()
                + ((s[1:] == s[:-1]) & (s[1:] > 0)).sum()) > 100


@pytest.mark.parametrize("img,ok", [
    (torch.zeros((32, 16), device="meta").t(), False),
    (torch.zeros((2, 16, 16), device="meta"), False),
    (torch.zeros(16, device="meta"), False),
    (torch.zeros((16, 16), dtype=torch.float64, device="meta"), False),
    (torch.zeros((16, 16), dtype=torch.uint8, device="meta"), False),
    (torch.zeros((16, 16), device="meta"), True),
], ids=["strided", "3d", "1d", "f64", "u8", "taken"])
def test_fast_wrapper_refuses_what_it_would_misread(img, ok, monkeypatch):
    """On a non-CPU tensor the B2 wrapper converts and copies nothing: a
    non-contiguous, non-2-D or non-float32 image raises ValueError before
    anything launches; a contiguous 2-D float32 one goes to the launch."""

    def no_build():
        raise AssertionError("reached the launch")

    monkeypatch.setattr(_build, "library", no_build)
    n0 = cuda_fast.LAUNCHES
    with pytest.raises(AssertionError if ok else ValueError,
                       match="reached the launch" if ok else "fast_score_nms"):
        cuda_fast.fast_score_nms(img, 7.0, 20.0)
    assert cuda_fast.LAUNCHES == n0


@pytest.mark.parametrize("scene", ["blocks", "uniform"])
def test_extract_on_reference_atlas_matches(scene):
    """Fed the reference's own atlas: keypoint selection is integer work on
    identical score maps, so uv, octave, valid and response are equal. The
    angle is atan2 of identical integer moments (1e-4: the two libraries'
    atan2). Descriptor bits may flip where a steered pattern offset rounds
    at .5 under a 1-ulp cos/sin difference: at most 0.5% of bits."""
    rng = np.random.default_rng(11)
    if scene == "blocks":
        image = _render(rng)
    else:
        image = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    pj, pt = feat_j.OrbParams(**SMALL), feat_t.OrbParams(**SMALL)
    ref = feat_j.extract(jnp.asarray(image), pj)
    atlas = torch.from_numpy(_reference_atlas(image, pj))
    got = feat_t.extract_from_atlas(atlas, 240, 320, pt)
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(ref.uv))
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.response.numpy(), np.asarray(ref.response))
    v = np.asarray(ref.valid)
    assert v.sum() > 100
    np.testing.assert_allclose(got.angle.numpy()[v], np.asarray(ref.angle)[v], rtol=0, atol=1e-4)
    bits_t = np.unpackbits(got.desc.numpy()[v], axis=1)
    bits_j = np.unpackbits(np.asarray(ref.desc)[v], axis=1)
    n_diff = int((bits_t != bits_j).sum())
    assert n_diff <= 0.005 * bits_j.size, (n_diff, bits_j.size)


def test_extract_from_raw_image_close():
    """The whole extractor from the raw image: the pyramid may round a few
    pixels differently (see above), which can move a handful of keypoints."""
    rng = np.random.default_rng(12)
    image = _render(rng)
    ref = feat_j.extract(jnp.asarray(image), feat_j.OrbParams(**SMALL))
    got = feat_t.extract(torch.from_numpy(image), feat_t.OrbParams(**SMALL))
    same = np.all(got.uv.numpy() == np.asarray(ref.uv), axis=1)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
