"""Port parity: loop closing (`orbslam3_tpu_torch/pipeline/loop_closing.py`)
against the JAX package on the CPU.

* The two cases of `tests/test_loop_second_round.py` (a marginal closure
  that the second round's covisibility cloud rescues, and the same pair
  without that support) are accepted and rejected alike, and the accepted
  Sim3 is the truth's in both.
* On a map with drift set by construction (`tests/loop_scene.py`, fault
  C5's regime: a 24-keyframe circle whose last keyframe revisits the first
  with 8% scale, 0.06 rad and 0.19 m of accumulated drift), both closers
  close the loop at the same keyframe through their keyframe databases
  (9,975-word tree) and cut the keyframes' ATE; from the same measured Sim3,
  `_correct_loop` (essential graph, point correction, SearchAndFuse) gives
  poses and points within 1e-4 of each other and equal keyframe rows.

Sampling (the RANSAC draws) differs between the packages, so the verified
Sim3s are compared as outcomes (both accept, both near the truth)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loop_scene as LS
import test_loop_second_round as second
from orbslam3_tpu.atlas import kfdb as kfdb_j
from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu.io import vocab_io as vio_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.pipeline import loop_closing as lc_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import kfdb as kfdb_t
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.pipeline import loop_closing as lc_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth.bin")


def port_store(store_j):
    """The port's `MapStore` on the CPU holding the same map as `store_j`."""
    s = store_j.state
    out = st_t.MapStore(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device="cpu")
    out.state = convert.to_torch(s, "cpu", st_t.MapState)
    out.n_kf, out.n_mp, out.kf_ts = store_j.n_kf, store_j.n_mp, store_j.kf_ts.copy()
    out.free_mp_slots = list(store_j.free_mp_slots)
    out.free_kf_slots = list(store_j.free_kf_slots)
    return out


def jax_store(arrays, info, Kmax=32, Pmax=4096, Nf=256):
    store = st_j.MapStore(Kmax=Kmax, Pmax=Pmax, Nf=Nf)
    store.state = st_j.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    store.n_kf, store.n_mp, store.kf_ts = info["n_kf"], info["n_mp"], info["kf_ts"].copy()
    return store


def closers(store_j, store_t, params, W, H, n_features, kfdbs=(None, None), **kw):
    orb = feat_j.OrbParams(n_features=n_features, n_levels=4)
    j = lc_j.LoopCloser(cam_j.CameraModel.PINHOLE, jnp.asarray(params), store_j, kfdbs[0],
                        jnp.asarray(feat_j.sigma2(orb)), img_wh=jnp.asarray([float(W), float(H)]),
                        scale_table=jnp.asarray(feat_j.scale_factors(orb)), **kw)
    t = lc_t.LoopCloser(cam_t.CameraModel.PINHOLE, torch.from_numpy(np.array(params, np.float32)),
                        store_t, kfdbs[1], torch.from_numpy(feat_t.sigma2(orb)),
                        img_wh=torch.tensor([float(W), float(H)]),
                        scale_table=torch.from_numpy(feat_t.scale_factors(orb)), **kw)
    return j, t


@pytest.mark.parametrize("support", [True, False])
def test_second_round_accepts_and_rejects_alike(support):
    store_j, k_cand, k_cur, _ = second._make_scene(np.random.default_rng(0), cloud_support=support)
    store_t = port_store(store_j)
    lj, lt = closers(store_j, store_t, np.asarray(second.PARAMS), second.W, second.H, second.NF,
                     consecutive=1)
    out_j = lj._verify_sim3_impl(k_cur, k_cand)
    out_t = lt._verify_sim3_impl(k_cur, k_cand)
    assert (out_t is None) == (out_j is None) == (not support)
    if support:
        for out in (out_j, out_t):
            np.testing.assert_allclose(out[2], 1.0, atol=0.02)
            np.testing.assert_allclose(out[0], np.eye(3), atol=0.02)
        np.testing.assert_allclose(out_t[1], out_j[1], atol=0.02)


@pytest.fixture(scope="module")
def drift_maps():
    arrays, info = LS.make_loop_map()
    return arrays, info


def _state_np(store):
    s = store.state
    return {k: np.asarray(getattr(s, k)) for k in ("kf_R", "kf_t", "mp_pos", "mp_valid", "kf_mp")}


def test_closure_from_the_databases_cuts_the_drift(drift_maps):
    """Both closers add every keyframe to their database and close the loop
    at the last one, with a candidate at the start of the circle, and cut
    the keyframes' ATE."""
    arrays, info = drift_maps
    K, cur = info["n_kf"], info["cur_kf"]
    store_j = jax_store(arrays, info)
    store_t = port_store(store_j)
    voc_j = vio_j.load_binary_vocabulary(VOC)
    dbs = (kfdb_j.KeyFrameDB(voc_j, Kmax=32), kfdb_t.KeyFrameDB(convert.vocabulary(voc_j, "cpu"),
                                                                Kmax=32))
    lj, lt = closers(store_j, store_t, LS.PARAMS, LS.W, LS.H, 256, kfdbs=dbs, consecutive=1,
                     run_gba=False)
    pairs, closed = {}, {}
    for name, lc in (("jax", lj), ("port", lt)):
        lc.on_correction = lambda phase, kf, loop, name=name: pairs.setdefault(name, (kf, loop))
        closed[name] = [k for k in range(K) if lc.process_keyframe(k)]
    # One closure each (the 10-keyframe cool-down), at the same keyframe of
    # the second half, onto a keyframe of the first half.
    assert closed["port"] == closed["jax"] and len(closed["jax"]) == 1
    assert pairs["jax"][0] == pairs["port"][0] == closed["jax"][0] >= K // 2
    assert pairs["jax"][1] < K // 2 and pairs["port"][1] < K // 2
    assert lt.n_loops_closed == lj.n_loops_closed == 1
    np.testing.assert_array_equal(dbs[1].valid.numpy(), np.asarray(dbs[0].valid))
    np.testing.assert_allclose(dbs[1].vecs.numpy(), np.asarray(dbs[0].vecs), rtol=0, atol=1e-6)
    before = LS.keyframe_ate(arrays["kf_R"][:K], arrays["kf_t"][:K], info["centres_true"])
    for store in (store_j, store_t):
        s = _state_np(store)
        after = LS.keyframe_ate(s["kf_R"][:K], s["kf_t"][:K], info["centres_true"])
        assert after < 0.8 * before, (before, after)


def test_correct_loop_and_search_and_fuse_match(drift_maps):
    """From the same measured Sim3 (the reference's verification), the two
    `_correct_loop`s give poses and points within 1e-4 and equal keyframe
    rows after SearchAndFuse, which replaced duplicate points."""
    arrays, info = drift_maps
    K, cur, loop = info["n_kf"], info["cur_kf"], info["loop_kf"]
    store_j = jax_store(arrays, info)
    store_t = port_store(store_j)
    lj, lt = closers(store_j, store_t, LS.PARAMS, LS.W, LS.H, 256, consecutive=1, run_gba=False)
    S = lj._verify_sim3_impl(cur, loop)
    assert S is not None
    n_valid0 = int(arrays["mp_valid"].sum())
    lj._correct_loop(cur, loop, *S)
    lt._correct_loop(cur, loop, *S)
    a, b = _state_np(store_j), _state_np(store_t)
    for k in ("kf_R", "kf_t", "mp_pos"):
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(b["mp_valid"], a["mp_valid"])
    np.testing.assert_array_equal(b["kf_mp"], a["kf_mp"])
    assert sorted(store_t.free_mp_slots) == sorted(store_j.free_mp_slots)
    assert int(b["mp_valid"].sum()) < n_valid0  # SearchAndFuse replaced duplicates
    before = LS.keyframe_ate(arrays["kf_R"][:K], arrays["kf_t"][:K], info["centres_true"])
    after = LS.keyframe_ate(b["kf_R"][:K], b["kf_t"][:K], info["centres_true"])
    assert after < 0.8 * before, (before, after)
    assert lt.loop_edges[0][:2] == lj.loop_edges[0][:2] == (cur, loop)
