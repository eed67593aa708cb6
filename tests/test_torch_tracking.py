"""Port parity: the tracking slice as a whole (extraction -> `_track_step`)
against the JAX package on the CPU, at a small size: 320x240, 3 levels,
300 features, Kmax 16, Pmax 2048. The scene is `entry.make_scene`, built
with numpy from a seed, so both packages get the same map and image."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.pipeline import frame as fr_j
from orbslam3_tpu.pipeline import tracking as trk_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.pipeline import frame as fr_t
from orbslam3_tpu_torch.pipeline import tracking as trk_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

CFG = E.EUROC._replace(H=240, W=320, fx=230.0, fy=230.0, cx=160.0, cy=120.0,
                       n_features=300, n_levels=3, Kmax=16, Pmax=2048, n_kf=12,
                       n_mp=1500, n_local=1024, n_back=150, first_id=1600, ref_kf=11)


def _jax_extract_np(img):
    f = feat_j.extract(jnp.asarray(img), feat_j.OrbParams(n_features=CFG.n_features,
                                                         n_levels=CFG.n_levels))
    return feat_j.Features(*(np.asarray(x) for x in f))


@pytest.fixture(scope="module")
def scene():
    sc = E.make_scene(CFG, _jax_extract_np)
    # make_scene's normals face the camera, so no point passes the frustum
    # test there; point them along the viewing rays instead, so the
    # local-map stage has visible points to search.
    sc.state.mp_normal[:, 2] = 1.0
    # Let a few keyframes observe the back-projected points, two of them
    # equally often, so the local-keyframe top-k has real shares and a tie.
    # The last 50 are hidden from the motion model (not in the last frame)
    # and can only come back through keyframe 7 in the local-map stage.
    kf_mp = sc.state.kf_mp
    ids = sc.last_mp[sc.last_mp >= 0]
    assert len(ids) == CFG.n_back
    kf_mp[3, :100] = ids[:100]
    kf_mp[5, :100] = ids[:100]
    kf_mp[7, :60] = np.concatenate([ids[100:150], ids[:10]])
    sc.last_mp[np.isin(sc.last_mp, ids[100:150])] = -1
    return sc


def _jax_inputs(sc):
    state = st_j.MapState(*(jnp.asarray(x) for x in sc.state))
    f = feat_j.extract(jnp.asarray(sc.img), feat_j.OrbParams(n_features=CFG.n_features,
                                                             n_levels=CFG.n_levels))
    return state, f


def _consts_j():
    orb = feat_j.OrbParams(n_features=CFG.n_features, n_levels=CFG.n_levels)
    return dict(model=cam_j.CameraModel.PINHOLE,
                params=cam_j.make_pinhole(CFG.fx, CFG.fy, CFG.cx, CFG.cy),
                scale=jnp.asarray(feat_j.scale_factors(orb)),
                sigma2=jnp.asarray(feat_j.sigma2(orb)),
                img_wh=jnp.asarray([float(CFG.W), float(CFG.H)], jnp.float32))


def _run_jax(sc, state, f, have_pred):
    c = _consts_j()
    R, t = jnp.asarray(sc.R_pred), jnp.asarray(sc.t_pred)
    bundle, _ = trk_j._track_step(
        c["model"], c["params"], state, f, R, t, jnp.asarray(have_pred),
        jnp.asarray(sc.last_mp), jnp.asarray(sc.last_octave), jnp.asarray(CFG.ref_kf),
        R, t, c["scale"], c["sigma2"], c["img_wh"], jnp.asarray(3, jnp.int32),
        obs_count=trk_j.compute_obs_count(state), n_levels=CFG.n_levels,
    )
    return {k: np.asarray(v) for k, v in bundle.items()}


def _run_port(sc, state, f, have_pred):
    c = E._consts(CFG, "cpu")
    R, t = convert.tensor(sc.R_pred, "cpu"), convert.tensor(sc.t_pred, "cpu")
    bundle, _ = trk_t._track_step(
        c.model, c.params, state, f, R, t, torch.tensor(have_pred),
        convert.tensor(sc.last_mp, "cpu"), convert.tensor(sc.last_octave, "cpu"),
        torch.tensor(CFG.ref_kf, dtype=torch.int32), R, t, c.scale_f, c.sigma2, c.img_wh,
        torch.tensor(3, dtype=torch.int32), obs_count=trk_t.compute_obs_count(state),
        n_levels=CFG.n_levels,
    )
    return trk_t.fetch_bundle(bundle)


def _assert_bundles_agree(got, ref):
    """assoc equal except at index 0 (fault C6: the reference can drop a
    valid scatter into slot 0), n_inl within 2, R and t within 1e-4
    (float32 pose solves summed in another order), the rest equal."""
    np.testing.assert_array_equal(got["assoc"][1:], ref["assoc"][1:])
    assert abs(int(got["n_inl"]) - int(ref["n_inl"])) <= 2
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=1e-4)
    for k in ("top_kfs", "ref_matches", "used_a", "ok1", "n_a", "n_b"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("have_pred", [True, False])
def test_track_step_same_features(scene, have_pred):
    """The same Features through both `_track_step`s. With no prediction the
    reference-keyframe fallback (cross-checked match + third solve) runs."""
    state_j, f_j = _jax_inputs(scene)
    ref = _run_jax(scene, state_j, f_j, have_pred)
    f_t = convert.to_torch(feat_j.Features(*(np.asarray(x) for x in f_j)), "cpu",
                           feat_t.Features)
    state_t = convert.to_torch(scene.state, "cpu", st_t.MapState)
    got = _run_port(scene, state_t, f_t, have_pred)
    _assert_bundles_agree(got, ref)
    assert bool(ref["used_a"]) == have_pred
    if have_pred:
        assert int(ref["n_inl"]) >= 100
        assert np.sum(ref["top_kfs"] >= 0) == 3
        assert list(ref["top_kfs"][:3]) == [3, 5, 7]  # the tie goes to the lower index
        # the local-map stage brought back points the motion model never saw
        assert int((got["assoc"] >= 0).sum()) >= int(got["n_a"]) + 25


def test_frustum_octave_flips_are_rare(scene):
    """`ceil(log(ratio)/log(1.2))` can land on the other side of an integer
    in the two libraries. Counted, not forbidden: at most 0.5% of points."""
    R = np.asarray(scene.R_pred)
    t = np.asarray(scene.t_pred)
    s = scene.state
    args = (s.mp_pos, s.mp_valid, s.mp_normal, s.mp_min_dist, s.mp_max_dist)
    wh = np.asarray([CFG.W, CFG.H], np.float32)
    ref = fr_j.frustum_and_scale(cam_j.CameraModel.PINHOLE,
                                 cam_j.make_pinhole(CFG.fx, CFG.fy, CFG.cx, CFG.cy),
                                 jnp.asarray(R), jnp.asarray(t),
                                 *(jnp.asarray(a) for a in args), jnp.asarray(wh), n_levels=3)
    got = fr_t.frustum_and_scale(cam_t.CameraModel.PINHOLE,
                                 cam_t.make_pinhole(CFG.fx, CFG.fy, CFG.cx, CFG.cy),
                                 torch.from_numpy(R), torch.from_numpy(t),
                                 *(torch.from_numpy(np.array(a)) for a in args),
                                 torch.from_numpy(wh), n_levels=3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    flips = int((got[2].numpy() != np.asarray(ref[2])).sum())
    assert flips <= 0.005 * CFG.Pmax, flips
    r_t = fr_t.search_radius(got[3], got[2]).numpy()
    r_j = np.asarray(fr_j.search_radius(ref[3], ref[2]))
    same = got[2].numpy() == np.asarray(ref[2])
    np.testing.assert_allclose(r_t[same], r_j[same], rtol=1e-6)


def test_full_chain_port_extract(scene):
    """Port extraction -> port `_track_step` against the JAX chain: the
    pyramid can round a few pixels differently, so the final inlier count
    is held within 2%."""
    state_j, f_j = _jax_inputs(scene)
    ref = _run_jax(scene, state_j, f_j, True)
    f_t = feat_t.extract(convert.tensor(scene.img, "cpu"), CFG.orb)
    got = _run_port(scene, convert.to_torch(scene.state, "cpu", st_t.MapState), f_t, True)
    assert abs(int(got["n_inl"]) - int(ref["n_inl"])) <= 0.02 * int(ref["n_inl"])
    assert bool(got["used_a"]) and bool(got["ok1"])
    np.testing.assert_allclose(got["R"], ref["R"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["t"], ref["t"], rtol=0, atol=1e-3)


def test_entry_points_run_and_track():
    """The port's `entry()` and `staged_pipeline()` at the small size: the
    motion model tracks the back-projected keypoints."""
    step, args = E.entry("cpu", CFG)
    R, t, n_inl = step(*args)
    assert torch.isfinite(R).all() and torch.isfinite(t).all()
    assert int(n_inl) >= 100
    bundle = E.staged_pipeline("cpu", CFG)(*args)
    assert bool(bundle["used_a"]) and int(bundle["n_inl"]) >= 100
    assert bundle["assoc"].shape == (CFG.n_features,) and bundle["assoc"].dtype == np.int32
    np.testing.assert_allclose(bundle["R"], R.numpy(), atol=1e-4)


def test_found_visible_and_obs_count_match(scene):
    state_j = st_j.MapState(*(jnp.asarray(x) for x in scene.state))
    state_t = convert.to_torch(scene.state, "cpu", st_t.MapState)
    np.testing.assert_array_equal(trk_t.compute_obs_count(state_t).numpy(),
                                  np.asarray(trk_j.compute_obs_count(state_j)))
    rng = np.random.default_rng(5)
    visible = rng.random(CFG.Pmax) > 0.5
    assoc = np.where(rng.random(CFG.n_features) > 0.3,
                     rng.integers(0, CFG.Pmax, CFG.n_features), -1).astype(np.int32)
    ref = st_j.bump_found_visible_arrays(state_j, jnp.asarray(visible), jnp.asarray(assoc))
    got = st_t.bump_found_visible_arrays(state_t, torch.from_numpy(visible),
                                         torch.from_numpy(assoc))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
