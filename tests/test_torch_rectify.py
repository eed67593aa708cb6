"""Port parity: raw-stereo rectification (`orbslam3_tpu_torch/ops/rectify.py`)
against `orbslam3_tpu/ops/rectify.py` on the CPU.

Tolerances: `build_rectify_map` (the port's own numpy copy) bit-equal;
`remap_bilinear` and `StereoRectifier` within 1e-4 grey levels (float32
bilinear weights on both sides). The synthetic sequence's raw rig
(`entry.raw_stereo_rig`) equals what the JAX package parses from the
script's `raw_stereo_yaml`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu import config as cfg_j
from orbslam3_tpu.ops import rectify as rect_j
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.ops import rectify as rect_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

W, H = 320, 240
K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])


def _pitch(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


CASES = {
    "radtan4_pitch2_P34": (K, (-0.28, 0.07, 2e-4, 1.8e-5), _pitch(2.0),
                           np.array([[290.0, 0, 158.0, -33.0], [0, 290.0, 121.0, 0],
                                     [0, 0, 1, 0]])),
    "radtan5_yaw_P33": (K, (-0.3, 0.1, -1e-3, 5e-4, -0.02), _pitch(-1.0)[[1, 0, 2]][:, [1, 0, 2]],
                        K * [[1.05], [1.05], [1.0]]),
    "identity": (K, np.zeros(4), np.eye(3), K),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_rectify_map_is_bit_equal(name):
    K_, D, R, P = CASES[name]
    for got, want in zip(rect_t.build_rectify_map(K_, D, R, P, (W, H)),
                         rect_j.build_rectify_map(K_, D, R, P, (W, H))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_remap_bilinear(name):
    """A random image through each case's grid (samples outside the image
    read 0) and through half-pixel and out-of-range grids."""
    rng = np.random.default_rng(len(name))
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    mx, my = rect_t.build_rectify_map(*CASES[name], (W, H))
    grids = [(mx, my), (mx + 0.5, my - 0.5), (rng.uniform(-3, W + 2, (H, W)).astype(np.float32),
                                              rng.uniform(-3, H + 2, (H, W)).astype(np.float32))]
    for gx, gy in grids:
        want = np.asarray(rect_j.remap_bilinear(jnp.asarray(img), jnp.asarray(gx), jnp.asarray(gy)))
        got = rect_t.remap_bilinear(torch.from_numpy(img), torch.from_numpy(gx),
                                    torch.from_numpy(gy)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        assert (got == 0).sum() == (want == 0).sum()


def test_raw_rig_equals_the_scripts_yaml(tmp_path):
    """`entry.raw_stereo_rig()` holds the K, D, R and P blocks that the JAX
    package parses from `make_synth_euroc.raw_stereo_yaml()`."""
    p = tmp_path / "raw.yaml"
    p.write_text(E.synth_euroc().raw_stereo_yaml())
    st = cfg_j.load_settings(str(p))
    for got, want in zip(E.raw_stereo_rig(), (st.rect_left, st.rect_right)):
        for k in ("K", "D", "R", "P"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k), rtol=1e-9, atol=1e-12)
        assert (got.width, got.height) == (want.width, want.height)


def test_stereo_rectifier_on_a_raw_pair():
    """One raw pair of the synthetic sequence (`euroc_frames(raw=True)`)
    through both packages' rectifiers built from the same rig."""
    _, imgs, _ = E.euroc_frames(1, raw=True)
    rig = E.raw_stereo_rig()
    got = rect_t.StereoRectifier(*rig, "cpu")(imgs[0, 0], imgs[0, 1])
    want = rect_j.StereoRectifier(*rig)(imgs[0, 0], imgs[0, 1])
    for g, w in zip(got, want):
        assert g.shape == (480, 752) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
