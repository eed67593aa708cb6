"""Port parity: the per-keyframe mapping pass (triangulate -> fuse -> local
BA) against the JAX package on the CPU, at a small size: Kmax 16, Pmax 2048,
Nf 768, 12 keyframes, 3 neighbours, 256 fuse candidates, a window of 6 and a
fixed bucket of 4 (3 valid, one -1 pad). The scene is
`entry.make_mapping_scene` (the reference's draws, built with numpy) and its
`mapping_variant`, where triangulation and fuse find planted points.

Tolerances: triangulation `good` and `idx` equal, `Xw` within 1e-4 |Xw|;
fuse rows, adds and conflicts equal except at keypoint slot 0 (fault C6);
local BA cost within 1e-3 relative, poses within 1e-4, points within 1e-3,
`n_bad` equal, `kf_mp` equal except keyframe 0's row (C6).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.pipeline import local_mapping as lm_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch import entry as E
from orbslam3_tpu_torch.pipeline import local_mapping as lm_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

CFG = E.MappingConfig(Kmax=16, Pmax=2048, Nf=768, n_kf=12, n_mp=1500, n_nb=3, n_cand=256,
                      n_window=6, n_fixed=4, n_fixed_valid=3, iters=5)
N_TRI, N_FUSE = 60, 40  # planted in the variant at this size


@functools.lru_cache(maxsize=None)
def _scene(name):
    sc = E.make_mapping_scene(CFG)
    return E.mapping_variant(sc, n_tri=N_TRI, n_fuse=N_FUSE) if name == "variant" else sc


def _consts_j():
    orb = feat_j.OrbParams(n_features=1024, n_levels=8)
    return dict(model=cam_j.CameraModel.PINHOLE,
                params=cam_j.make_pinhole(458.654, 457.296, 376.0, 240.0),
                sigma2=jnp.asarray(feat_j.sigma2(orb)),
                scale=jnp.asarray(feat_j.scale_factors(orb)),
                img_wh=jnp.asarray([752.0, 480.0], jnp.float32))


def _run_jax(sc):
    """The reference's `mapping_pass` programs on the scene (numpy out)."""
    c = _consts_j()
    s = st_j.MapState(*(jnp.asarray(x) for x in sc.state))
    kf, nb = sc.kf, jnp.asarray(sc.nb_ids)
    tri = lm_j.triangulate_batch(
        c["model"], c["params"], s.kf_R[kf], s.kf_t[kf], s.kf_uv[kf], s.kf_octave[kf],
        s.kf_desc[kf], s.kf_mp[kf] < 0, s.kf_R[nb], s.kf_t[nb], s.kf_uv[nb], s.kf_octave[nb],
        s.kf_desc[nb], s.kf_mp[nb] < 0, c["sigma2"], c["scale"], 458.654)
    fuse = lm_j._fuse_batch(c["model"], c["params"], s, nb, jnp.asarray(sc.cand_ids),
                            jnp.asarray(sc.cand_valid), c["img_wh"], c["sigma2"], n_levels=8)
    new, cost, n_bad = lm_j.local_ba(c["model"], c["params"], s, jnp.asarray(sc.window_ids),
                                     jnp.asarray(sc.fixed_ids), c["sigma2"], iters=CFG.iters)
    to_np = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    return dict(tri=to_np(tri), fuse=to_np(fuse), state=st_j.MapState(*to_np(new)),
                cost=float(cost), n_bad=int(n_bad))


@functools.lru_cache(maxsize=None)
def _ref(name):
    return _run_jax(_scene(name))


def _consts_t():
    return E._consts(E.EUROC, "cpu")


def _state_t(sc):
    return convert.to_torch(sc.state, "cpu")


def _assert_tri(got, ref):
    Xw, good, idx = (x.numpy() for x in got)
    np.testing.assert_array_equal(good, ref[1])
    np.testing.assert_array_equal(idx, ref[2])
    err = np.linalg.norm(Xw[good] - ref[0][good], axis=-1)
    assert np.all(err <= 1e-4 * np.linalg.norm(ref[0][good], axis=-1)), err.max()


def _assert_fuse(got, ref):
    rows, adds, incumbent, conflict = (x.numpy() for x in got)
    np.testing.assert_array_equal(rows[:, 1:], ref[0][:, 1:])
    np.testing.assert_array_equal(adds, ref[1])
    np.testing.assert_array_equal(incumbent, ref[2])
    np.testing.assert_array_equal(conflict, ref[3])


def _assert_lba(state, cost, n_bad, ref):
    np.testing.assert_allclose(float(cost), ref["cost"], rtol=1e-3)
    assert int(n_bad) == ref["n_bad"]
    r = ref["state"]
    np.testing.assert_allclose(state.kf_R.numpy(), r.kf_R, rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.kf_t.numpy(), r.kf_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(state.mp_pos.numpy(), r.mp_pos, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(state.kf_mp.numpy()[1:], r.kf_mp[1:])


def test_make_mapping_scene_equals_reference_full_size():
    """At full size, the port's scene is the reference's, exactly: every
    state array, and the neighbour, candidate, window and fixed ids."""
    run, (state,) = G.mapping_pass()
    sc = E.make_mapping_scene(E.EUROC_MAPPING)
    for k, v in state._asdict().items():
        a, b = np.asarray(v), getattr(sc.state, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    closure = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
    assert int(closure["kf"]) == sc.kf == 71
    for k in ("nb_ids", "cand_ids", "cand_valid", "window_ids", "fixed_ids"):
        np.testing.assert_array_equal(getattr(sc, k), np.asarray(closure[k]), err_msg=k)


@pytest.mark.parametrize("name", ["reference", "variant"])
def test_triangulate_batch(name):
    sc, c = _scene(name), _consts_t()
    s = _state_t(sc)
    kf, nb = sc.kf, torch.from_numpy(sc.nb_ids).long()
    got = lm_t.triangulate_batch(
        c.model, c.params, s.kf_R[kf], s.kf_t[kf], s.kf_uv[kf], s.kf_octave[kf], s.kf_desc[kf],
        s.kf_mp[kf] < 0, s.kf_R[nb], s.kf_t[nb], s.kf_uv[nb], s.kf_octave[nb], s.kf_desc[nb],
        s.kf_mp[nb] < 0, c.sigma2, c.scale_f, 458.654)
    _assert_tri(got, _ref(name)["tri"])
    if name == "variant":  # the planted points, each seen from up to 3 neighbours
        assert int(got[1].any(0).sum()) >= N_TRI // 2


@pytest.mark.parametrize("name", ["reference", "variant"])
def test_fuse_batch(name):
    sc, c = _scene(name), _consts_t()
    got = lm_t._fuse_batch(c.model, c.params, _state_t(sc), torch.from_numpy(sc.nb_ids),
                           torch.from_numpy(sc.cand_ids), torch.from_numpy(sc.cand_valid),
                           c.img_wh, c.sigma2, n_levels=8)
    _assert_fuse(got, _ref(name)["fuse"])
    if name == "variant":
        assert (got[1] >= N_FUSE // 2).all() and int(got[3].sum()) >= 1


@pytest.mark.parametrize("name", ["reference", "variant"])
def test_local_ba(name):
    sc, c = _scene(name), _consts_t()
    state, cost, n_bad = lm_t.local_ba(c.model, c.params, _state_t(sc),
                                       torch.from_numpy(sc.window_ids),
                                       torch.from_numpy(sc.fixed_ids), c.sigma2, iters=CFG.iters)
    _assert_lba(state, cost, n_bad, _ref(name))


def test_mapping_pass_variant():
    """The whole entry point: `mapping_pass(cpu)`'s run on the variant's map."""
    run, (state,) = E.mapping_pass("cpu", CFG)
    ref = _ref("variant")
    out = run(_state_t(_scene("variant")))
    _assert_tri(out[:3], ref["tri"])
    _assert_fuse(out[3:7], ref["fuse"])
    _assert_lba(out.state, out.cost, out.n_bad, ref)
    # The reference's own scene (as `mapping_pass` builds it) runs too.
    out = run(state)
    assert torch.isfinite(out.cost) and int(out.n_bad) == _ref("reference")["n_bad"]


def test_c6_keyframe0_outlier_is_erased():
    """The variant moves one observation of keyframe 0 (a fixed keyframe, with
    the fixed list padded by -1) 30 px off. The port's local BA erases it;
    the reference's writes the pre-erase row back through the pad rows,
    which clip to keyframe 0, so it keeps every observation of keyframe 0."""
    sc, c = _scene("variant"), _consts_t()
    assert (sc.fixed_ids == -1).any() and 0 in sc.fixed_ids
    before = sc.state.kf_mp[0]
    ref_row = _ref("variant")["state"].kf_mp[0]
    np.testing.assert_array_equal(ref_row, before)
    state, _, _ = lm_t.local_ba(c.model, c.params, _state_t(sc), torch.from_numpy(sc.window_ids),
                                torch.from_numpy(sc.fixed_ids), c.sigma2, iters=CFG.iters)
    erased = (before >= 0) & (state.kf_mp[0].numpy() < 0)
    assert erased.sum() >= 1
    moved = np.flatnonzero(np.abs(sc.state.kf_uv[0] - _scene("reference").state.kf_uv[0]).max(1))
    assert erased[moved].all()


def test_c4_nan_point_keeps_the_solve_alive():
    """One window point with a NaN position. The reference's weighted rows
    for its observations are 0 * NaN = NaN, its reduced camera system is
    NaN, every Cholesky fails, and no window pose moves (only the points
    do). The port gates those rows to 0: the poses move, stay finite, and
    the cost ends lower than the reference's."""
    sc, c = _scene("reference"), _consts_t()
    pos = sc.state.mp_pos.copy()
    pos[int(sc.state.kf_mp[sc.kf, 0])] = np.nan
    poisoned = sc._replace(state=sc.state._replace(mp_pos=pos))
    ref = _run_jax(poisoned)
    np.testing.assert_array_equal(ref["state"].kf_t, sc.state.kf_t)  # what the reference does
    state, cost, _ = lm_t.local_ba(c.model, c.params, _state_t(poisoned),
                                   torch.from_numpy(sc.window_ids),
                                   torch.from_numpy(sc.fixed_ids), c.sigma2, iters=CFG.iters)
    assert torch.isfinite(state.kf_R).all() and torch.isfinite(state.kf_t).all()
    w = sc.window_ids
    assert float(np.abs(state.kf_t.numpy()[w] - sc.state.kf_t[w]).max()) > 1e-3
    assert float(cost) < ref["cost"]
