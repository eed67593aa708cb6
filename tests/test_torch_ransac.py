"""Port parity: monocular two-view initialization (`ops/ransac.py`'s H/F
part), PnP RANSAC and Horn's Sim3 with its RANSAC, the rotation-consistency
filter and the initialization matcher, against the JAX package on the CPU.

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
from orbslam3_tpu.ops import lie as lie_j
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


def _t(x):
    return torch.from_numpy(np.array(x))


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


def test_lap_initialization_pair_matches_jax(monkeypatch):
    """Fault C16: on phase 10's 8 s lap the JAX `System` initializes on
    frame 1, the port's on frame 21. Both trackers hand
    `reconstruct_two_views` the same matches of frames 0 and 1, and fed the
    reference's draws of `PRNGKey(k)` the port's outcome is JAX's for every
    k < 20 (6 of them succeed), key 0's motion and points as in
    `test_reconstruct_two_views_matches_reference` (t within 5e-4). The pair is marginal
    (JAX's key 0 passes the clear-winner rule by half a point: 253 < 0.75 x
    338), so the frame the map starts on is the draws', not a fault of the
    port's reconstruction (`tests/init_pair_draws.py` prints the counts)."""
    from init_pair_draws import lap_pair_inputs

    j, t = lap_pair_inputs(monkeypatch)
    assert j["success"]  # the JAX System initialized on frame 1
    valid = j["valid"]
    np.testing.assert_array_equal(t["valid"], valid)
    np.testing.assert_array_equal(t["p1"], j["p1"])
    np.testing.assert_array_equal(t["p2"][valid], j["p2"][valid])
    assert t["sigma_norm"] == j["sigma_norm"]
    outcomes = []
    for k in range(20):
        key = jax.random.PRNGKey(k)
        ref = rs_j.reconstruct_two_views(jnp.asarray(j["p1"]), jnp.asarray(j["p2"]),
                                         jnp.asarray(valid), key, sigma_norm=j["sigma_norm"])
        got = rs_t.reconstruct_two_views(
            torch.from_numpy(j["p1"]), torch.from_numpy(j["p2"]), torch.from_numpy(valid),
            samples=torch.from_numpy(_jax_samples(key, valid)), sigma_norm=j["sigma_norm"])
        assert bool(got.success) == bool(ref.success), k
        assert bool(got.used_homography) == bool(ref.used_homography), k
        outcomes.append(bool(got.success))
        if k == 0:
            # The unit t of a two-frame baseline comes out of the refit H's
            # SVD: the two H agree within 4e-7, their t within 1.5e-4.
            np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
            np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-4)
            g_ref, g_got = np.asarray(ref.is_good), got.is_good.numpy()
            assert (g_ref != g_got).sum() <= 2, (g_ref != g_got).sum()
            both = g_ref & g_got
            X_ref, X_got = np.asarray(ref.points)[both], got.points.numpy()[both]
            assert (np.linalg.norm(X_got - X_ref, axis=1)
                    <= 1e-3 * np.linalg.norm(X_ref, axis=1)).all()
    assert outcomes[0] and 0 < sum(outcomes) < 20


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


# --- PnP and Sim3 (relocalization, loop closing) ---------------------------
# The port gets the reference's own draws (`samples`, as `jax.random.
# categorical` draws them from the key): the outcome (ok, inlier set) must
# be equal and the pose within 1e-4.


def _categorical(key, valid, shape):
    logits = jnp.log(jnp.asarray(valid, jnp.float32) + 1e-9)
    return np.array(jax.random.categorical(key, logits[None, None, :], shape=shape))


def _pnp_scene(seed, n=200, out_frac=0.25):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
                   -1).astype(np.float32)
    R = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.2, 3), jnp.float32)))
    t = rng.normal(0, 0.4, 3).astype(np.float32)
    Xw = ((pts - t) @ R).astype(np.float32)
    rays = pts[:, :2] / pts[:, 2:3] + rng.normal(0, 1.0 / 450, (n, 2))
    bad = rng.choice(n, int(n * out_frac), replace=False)
    rays[bad] += rng.uniform(0.05, 0.2, (len(bad), 2)) * np.sign(rng.normal(size=(len(bad), 2)))
    valid = rng.random(n) > 0.1
    return Xw, rays.astype(np.float32), valid, R, t, bad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pnp_ransac_matches_reference(seed):
    Xw, rays, valid, R, t, bad = _pnp_scene(seed)
    key = jax.random.PRNGKey(seed + 3)
    ok_j, R_j, t_j, inl_j = rs_j.pnp_ransac(jnp.asarray(Xw), jnp.asarray(rays), jnp.asarray(valid),
                                            key, sigma_norm=1.0 / 450)
    samples = torch.from_numpy(_categorical(key, valid, (256, 6)))
    ok_t, R_t, t_t, inl_t = rs_t.pnp_ransac(_t(Xw), _t(rays), _t(valid), sigma_norm=1.0 / 450,
                                            samples=samples)
    assert bool(ok_t) == bool(ok_j) is True
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-4)
    assert np.abs(R_t.numpy() - R).max() < 0.02 and inl_t.numpy()[bad].mean() < 0.2


def test_pnp_ransac_own_sampler_and_failure():
    """With its own generator the port finds the pose; on pure outliers it
    fails, as the reference does."""
    Xw, rays, valid, R, t, _ = _pnp_scene(4)
    gen = torch.Generator().manual_seed(0)
    ok, R_t, t_t, _ = rs_t.pnp_ransac(_t(Xw), _t(rays), _t(valid), 1.0 / 450, generator=gen)
    assert bool(ok) and np.abs(R_t.numpy() - R).max() < 0.02
    noise = np.random.default_rng(5).uniform(-0.5, 0.5, rays.shape).astype(np.float32)
    ok_t = rs_t.pnp_ransac(_t(Xw), _t(noise), _t(valid), 1.0 / 450, generator=gen)[0]
    ok_j = rs_j.pnp_ransac(jnp.asarray(Xw), jnp.asarray(noise), jnp.asarray(valid),
                           jax.random.PRNGKey(0), sigma_norm=1.0 / 450)[0]
    assert not bool(ok_t) and not bool(ok_j)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches(fix_scale):
    rng = np.random.default_rng(9)
    P1 = rng.normal(size=(40, 3)).astype(np.float32)
    R = np.asarray(lie_j.exp_so3(jnp.asarray([0.3, -0.5, 0.2], jnp.float32)))
    P2 = (1.7 * P1 @ R.T + [0.3, 1.0, -2.0] + rng.normal(0, 0.01, P1.shape)).astype(np.float32)
    for sl in (slice(0, 3), slice(0, 40)):
        got = rs_t.horn_sim3(_t(P1[sl]), _t(P2[sl]), fix_scale)
        ref = rs_j.horn_sim3(jnp.asarray(P1[sl]), jnp.asarray(P2[sl]), fix_scale)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    got = rs_t.horn_sim3(_t(P1[None, :5]), _t(P2[None, :5]), fix_scale)  # batched
    ref = rs_j.horn_sim3(jnp.asarray(P1[:5]), jnp.asarray(P2[:5]), fix_scale)
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(ref[0]), rtol=0, atol=1e-5)


def _sim3_scene(seed, n=150, n_out=40):
    rng = np.random.default_rng(seed)
    params = np.asarray([400.0, 400.0, 320.0, 240.0, 0, 0, 0, 0], np.float32)
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 9, n)],
                  -1).astype(np.float32)
    R = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.1, 3), jnp.float32)))
    X2 = (1.2 * X1 @ R.T + [0.2, -0.1, 0.3]).astype(np.float32)
    X2[:n_out] += rng.normal(0, 0.5, (n_out, 3)).astype(np.float32)

    def proj(X):
        return np.stack([400 * X[:, 0] / X[:, 2] + 320, 400 * X[:, 1] / X[:, 2] + 240], -1)

    uv1 = (proj(X1) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    uv2 = (proj(1.2 * X1 @ R.T + [0.2, -0.1, 0.3]) + rng.normal(0, 0.3, (n, 2))).astype(np.float32)
    valid = rng.random(n) > 0.05
    err = np.full(n, 9.21 * 1.44, np.float32)
    return params, X1, X2, uv1, uv2, valid, err, R, n_out


@pytest.mark.parametrize("seed", [0, 1])
def test_sim3_ransac_matches_reference(seed):
    from orbslam3_tpu.ops import cameras as cam_j
    from orbslam3_tpu_torch.ops import cameras as cam_t

    params, X1, X2, uv1, uv2, valid, err, R, n_out = _sim3_scene(seed)
    key = jax.random.PRNGKey(seed)
    pj = jnp.asarray(params)
    proj_j = lambda X: cam_j.project(cam_j.CameraModel.PINHOLE, pj, X)  # noqa: E731
    proj_t = lambda X: cam_t.project(cam_t.CameraModel.PINHOLE, _t(params), X)  # noqa: E731
    out_j = rs_j.sim3_ransac(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), key,
                             jnp.asarray(err), jnp.asarray(err), proj_j, proj_j,
                             jnp.asarray(uv1), jnp.asarray(uv2))
    out_t = rs_t.sim3_ransac(_t(X1), _t(X2), _t(valid), _t(err), _t(err), proj_t, proj_t,
                             _t(uv1), _t(uv2),
                             samples=torch.from_numpy(_categorical(key, valid, (128, 3))))
    assert bool(out_t[0]) == bool(out_j[0]) is True
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    for a, b in zip(out_t[1:4], out_j[1:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    assert abs(float(out_t[3]) - 1.2) < 0.01 and out_t[4].numpy()[:n_out].mean() < 0.1
