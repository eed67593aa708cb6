"""Port parity: monocular two-view initialization (`ops/ransac.py`'s H/F
part), the rotation-consistency filter and the initialization matcher,
against the JAX package on the CPU.

The port gets the reference's own minimal sets (`samples`, drawn here
exactly as `reconstruct_two_views` draws them with `jax.random`).
Tolerances: `success` and `used_homography` equal; `R` and `t` within
1e-4 (singular-vector signs differ between the two SVDs: the same motion
must come out, with no flipped `t`); the good points equal as sets up to a
few borderline ones and within 1e-3 |X|. `rotation_consistency` and
`_match_for_initialization` are integer results: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import matching as mt_j
from orbslam3_tpu.ops import ransac as rs_j
from orbslam3_tpu.pipeline import tracking as trk_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import matching as mt_t
from orbslam3_tpu_torch.ops import ransac as rs_t
from orbslam3_tpu_torch.pipeline import tracking as trk_t
from test_ransac import two_view_scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _jax_samples(key, valid):
    """The reference's 200x8 draws (`reconstruct_two_views`'s sampling)."""
    logits = jnp.log(jnp.asarray(valid, jnp.float32) + 1e-9)
    return np.array(jax.random.categorical(
        key, logits[None, None, :], shape=(rs_j.N_HYPOTHESES, rs_j.SAMPLE)))


def _degenerate_scene(rng, n=200):
    """Pure rotation (the case of `test_ransac.test_two_view_degenerate_fails`)."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 8, n)], -1)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pc2 = pts @ R.T
    return (pts[:, :2] / pts[:, 2:3]).astype(np.float32), (pc2[:, :2] / pc2[:, 2:3]).astype(np.float32)


@pytest.mark.parametrize("case", ["general", "planar", "degenerate"])
def test_reconstruct_two_views_matches_reference(case):
    rng = np.random.default_rng(0)
    if case == "degenerate":
        p1, p2 = _degenerate_scene(rng)
        key = jax.random.PRNGKey(1)
    else:
        p1, p2, _, _, _ = two_view_scene(rng, planar=case == "planar")
        p1, p2 = np.array(p1), np.array(p2)
        key = jax.random.PRNGKey(0)
    valid = np.ones(len(p1), bool)
    ref = rs_j.reconstruct_two_views(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), key)
    got = rs_t.reconstruct_two_views(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid),
        samples=torch.from_numpy(_jax_samples(key, valid)))
    assert bool(got.success) == bool(ref.success)
    assert bool(got.used_homography) == bool(ref.used_homography)
    if case == "degenerate":
        assert not bool(got.success)
        return
    assert bool(got.success)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    g_ref, g_got = np.asarray(ref.is_good), got.is_good.numpy()
    assert (g_ref != g_got).sum() <= 2, (g_ref != g_got).sum()
    both = g_ref & g_got
    X_ref, X_got = np.asarray(ref.points)[both], got.points.numpy()[both]
    assert (np.linalg.norm(X_got - X_ref, axis=1) <= 1e-3 * np.linalg.norm(X_ref, axis=1)).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reconstruct_two_views_own_sampler(seed):
    """With its own draws (a seeded generator) the port recovers the true
    motion: F chosen, rotation within 0.01 rad, translation direction
    within 0.997. (The reference's test asks 0.999 of its one draw; over
    seeds 0-5 the port's draws land at 0.9980-0.9999: the refit F moves
    with the minimal set that won.)"""
    p1, p2, R_true, t_true, _ = two_view_scene(np.random.default_rng(0), planar=False)
    p1, p2 = np.array(p1), np.array(p2)
    g = torch.Generator().manual_seed(seed)
    got = rs_t.reconstruct_two_views(torch.from_numpy(p1), torch.from_numpy(p2),
                                     torch.ones(len(p1), dtype=torch.bool), generator=g)
    assert bool(got.success) and not bool(got.used_homography)
    R = got.R.numpy().astype(np.float64)
    cos = np.clip((np.trace(R_true.T @ R) - 1.0) / 2.0, -1.0, 1.0)
    assert np.arccos(cos) < 0.01
    assert float(got.t.numpy() @ (t_true / np.linalg.norm(t_true))) > 0.997
    assert int(got.is_good.sum()) > 200


def _match_inputs(rng, n=300, m=280):
    """Two keypoint sets with shared descriptors (some bits flipped),
    angles with a common rotation plus outliers, and ties."""
    desc_b = rng.integers(0, 256, (m, 32), dtype=np.uint8)
    src = rng.integers(0, m, n)
    flips = (rng.random((n, 32, 8)) < 0.03).astype(np.uint8)
    desc_a = desc_b[src] ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]
    desc_a[: n // 5] = rng.integers(0, 256, (n // 5, 32), dtype=np.uint8)
    desc_b[m // 2 :: 9] = desc_b[m // 2]  # exact ties
    uv_b = rng.uniform(0, 320, (m, 2)).astype(np.float32)
    uv_a = (uv_b[src] + rng.normal(0, 30, (n, 2))).astype(np.float32)
    ang_b = rng.uniform(0, 2 * np.pi, m).astype(np.float32)
    ang_a = (ang_b[src] + 0.3 + rng.normal(0, 0.05, n)).astype(np.float32) % np.float32(2 * np.pi)
    ang_a[: n // 4] = rng.uniform(0, 2 * np.pi, n // 4)
    va, vb = rng.random(n) > 0.05, rng.random(m) > 0.05
    return (uv_a, ang_a, desc_a, va), (uv_b, ang_b, desc_b, vb)


def _features(uv, ang, desc, valid, module, asarray):
    n = len(uv)
    return module.Features(uv=asarray(uv), response=asarray(np.zeros(n, np.float32)),
                           octave=asarray(np.zeros(n, np.int32)), angle=asarray(ang),
                           desc=asarray(desc), valid=asarray(valid))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotation_consistency_exact(seed):
    (uv_a, ang_a, da, va), (uv_b, ang_b, db, vb) = _match_inputs(np.random.default_rng(seed))
    m_j = mt_j.match_nn(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb),
                        max_dist=100, ratio=1.0, cross_check=False)
    ref = mt_j.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b), m_j)
    m_t = mt_t.Matches(idx=convert.tensor(np.asarray(m_j.idx), "cpu"),
                       dist=convert.tensor(np.asarray(m_j.dist), "cpu"),
                       valid=convert.tensor(np.asarray(m_j.valid), "cpu"))
    got = mt_t.rotation_consistency(torch.from_numpy(ang_a), torch.from_numpy(ang_b), m_t)
    assert int(m_t.valid.sum()) > int(got.valid.sum()) > 0  # the filter removed some
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))


def test_rotation_consistency_ties_go_to_the_lower_bin():
    """Four bins with equal counts: the three lowest are kept (C2)."""
    ang_b = np.zeros(8, np.float32)
    ang_a = np.repeat(np.deg2rad([130.0, 10.0, 250.0, 70.0]), 2).astype(np.float32)
    m = mt_t.Matches(idx=torch.arange(8, dtype=torch.int32), dist=torch.zeros(8),
                     valid=torch.ones(8, dtype=torch.bool))
    got = mt_t.rotation_consistency(torch.from_numpy(ang_a), torch.from_numpy(ang_b), m)
    ref = mt_j.rotation_consistency(jnp.asarray(ang_a), jnp.asarray(ang_b),
                                    mt_j.Matches(jnp.arange(8), jnp.zeros(8), jnp.ones(8, bool)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert got.valid.numpy().tolist() == [True, True, True, True, False, False, True, True]


@pytest.mark.parametrize("seed", [3, 4])
def test_match_for_initialization_exact(seed):
    a, b = _match_inputs(np.random.default_rng(seed))
    ref = trk_j._match_for_initialization(_features(*a, feat_j, jnp.asarray),
                                          _features(*b, feat_j, jnp.asarray))
    got = trk_t._match_for_initialization(_features(*a, feat_t, torch.from_numpy),
                                          _features(*b, feat_t, torch.from_numpy))
    assert int(got.valid.sum()) > 20
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(ref.dist))
