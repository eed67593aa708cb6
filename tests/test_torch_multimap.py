"""The port's multi-map `System` against the JAX package's on the CPU, on
`scripts/multimap_replay.py`'s scene (config 5's Atlas core;
`tests/multimap_scene.py` renders the same frames): sweep A maps wall 1, 28
blank frames store the map, sweep B starts a new map on wall 2 and pans back
into wall 1, where place recognition merges the two. The vocabulary is the
JAX scene's, carried over with `convert.vocabulary`.

Gates: the same frame stores map 0, with the same count of maps before the
merge; a merge within 2 keyframes of JAX's (the merged map's keyframe
count), one map after it; the keyframe count within 3 of JAX's; the Sim3
ATE over the frames that are not blank within max(2 x JAX's, 0.01 m). At
the JAX run's merging keyframe, the port's `_merge_sim3` on JAX's two maps
(converted) finds the same matches and, with JAX's RANSAC samples (drawn
from its `PRNGKey(kf_id + 7777)`, which the port's generator cannot
reproduce), a world Sim3 within 1e-3 of JAX's."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import multimap_scene as MS  # noqa: E402

from orbslam3_tpu_torch import convert  # noqa: E402
from orbslam3_tpu_torch.atlas import store as st  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _host(store) -> dict:
    """A JAX store's arrays and host bookkeeping, copied to numpy."""
    return dict(state={k: np.array(v) for k, v in store.state._asdict().items()},
                n_kf=store.n_kf, n_mp=store.n_mp, kf_ts=store.kf_ts.copy(),
                kf_frame_id=store.kf_frame_id.copy(), free_mp=list(store.free_mp_slots),
                free_kf=list(store.free_kf_slots))


def _port_store(h: dict) -> st.MapStore:
    s = h["state"]
    out = st.MapStore(Kmax=s["kf_R"].shape[0], Pmax=s["mp_pos"].shape[0],
                      Nf=s["kf_uv"].shape[1], device="cpu")
    out.state = st.MapState(**{k: torch.from_numpy(v) for k, v in s.items()})
    out.n_kf, out.n_mp = h["n_kf"], h["n_mp"]
    out.kf_ts, out.kf_frame_id = h["kf_ts"].copy(), h["kf_frame_id"].copy()
    out.free_mp_slots, out.free_kf_slots = list(h["free_mp"]), list(h["free_kf"])
    return out


def _ate(slam, scene_frames) -> float:
    from orbslam3_tpu_torch.ate import ate_rmse

    gt = [(ts, c) for tag, _, ts, c in scene_frames if tag != "blank"]
    ts, pos = slam.get_trajectory()
    return ate_rmse(np.asarray(ts), np.asarray(pos), np.asarray([t for t, _ in gt]),
                    np.stack([c for _, c in gt]), with_scale=True, max_dt=0.01)


@pytest.fixture(scope="module")
def runs():
    """The JAX `System` of `multimap_replay.make_system` and the port's on the
    scene's 68 frames: per frame the state, map count and keyframe count;
    the frames that stored a map; each merge (frame, keyframe pair, the merged
    map's keyframe count, world Sim3) with both maps as they were before it
    (JAX's run); the ATE."""
    import multimap_replay as MR

    scene = MR.Scene()
    frames = MS.Scene().frames()
    jslam = MR.make_system(scene)
    out = {}
    for who in ("jax", "port"):
        if who == "jax":
            slam = jslam
        else:
            slam = MS.make_system(convert.vocabulary(jslam.multimap.voc, "cpu"))
        mm = slam.multimap
        rec = dict(states=[], maps=[], kfs=[], stored=[], merges=[])
        frame = [0]
        create, verify, do_merge = mm._create_map, mm._verify_merge, mm._do_merge
        pair = []

        def on_create(slam=slam, rec=rec, frame=frame, create=create):
            rec["stored"].append((frame[0], slam.store.n_kf))
            create()

        def on_verify(act, target, kf_id, cand, verify=verify, pair=pair):
            pair[:] = [kf_id, cand]
            return verify(act, target, kf_id, cand)

        def on_merge(act, target, R, t, s, rec=rec, frame=frame, pair=pair, do_merge=do_merge,
                     who=who):
            m = dict(frame=frame[0], kf=pair[0], cand=pair[1], n_kf_active=act.n_kf,
                     R=np.array(R), t=np.array(t), s=float(s))
            if who == "jax":
                m.update(act=_host(act), target=_host(target))
            rec["merges"].append(m)
            do_merge(act, target, R, t, s)

        mm._create_map, mm._verify_merge, mm._do_merge = on_create, on_verify, on_merge
        for k, (tag, img, ts, _) in enumerate(frames):
            frame[0] = k
            slam.track_monocular(img, ts)
            rec["states"].append(slam.tracking_state.name)
            rec["maps"].append(mm.atlas.n_maps)
            rec["kfs"].append(slam.n_keyframes)
        rec["ate"] = _ate(slam, frames)
        rec["system"] = slam
        out[who] = rec
    return out


def test_system_on_multimap_scene_matches_jax(runs):
    j, p = runs["jax"], runs["port"]
    print("JAX", j["stored"], [(m["frame"], m["kf"], m["cand"], m["n_kf_active"])
                               for m in j["merges"]], j["kfs"][-1], j["ate"])
    print("port", p["stored"], [(m["frame"], m["kf"], m["cand"], m["n_kf_active"])
                                for m in p["merges"]], p["kfs"][-1], p["ate"])
    assert j["stored"] and p["stored"]
    assert p["stored"][0][0] == j["stored"][0][0]
    f0 = j["stored"][0][0]
    assert p["maps"][f0] == j["maps"][f0] == 2
    assert len(p["merges"]) >= 1 and len(j["merges"]) >= 1
    mj, mp_ = j["merges"][0], p["merges"][0]
    assert max(p["maps"][f0:mp_["frame"]]) == max(j["maps"][f0:mj["frame"]])
    assert abs(mp_["n_kf_active"] - mj["n_kf_active"]) <= 2
    assert p["maps"][-1] == j["maps"][-1] == 1
    assert abs(p["kfs"][-1] - j["kfs"][-1]) <= 3
    assert np.isfinite(p["ate"]) and p["ate"] <= max(2 * j["ate"], 0.01)


def test_merge_sim3_on_jax_maps_matches_jax(runs, monkeypatch):
    """`_merge_sim3` of the port on the two maps JAX merged, as they were
    before the merge: the same cross-checked matches as JAX's `match_nn` on
    the same keyframes, and, its Sim3 RANSAC given the hypotheses JAX drew,
    the world Sim3 within 1e-3 of the one JAX merged with (about half of
    the generators' draws fail this keyframe's 39 matches, JAX's did not)."""
    import jax
    import jax.numpy as jnp

    from orbslam3_tpu.ops import matching as jmatching

    from orbslam3_tpu_torch.ops import ransac

    m = runs["jax"]["merges"][0]
    slam = runs["port"]["system"]
    act, tgt = _port_store(m["act"]), _port_store(m["target"])
    sim3_ransac = ransac.sim3_ransac

    def with_jax_samples(X1, X2, valid, *a, **kw):
        logits = jnp.log(jnp.asarray(valid.numpy()).astype(jnp.float32) + 1e-9)
        draw = jax.random.categorical(jax.random.PRNGKey(m["kf"] + 7777), logits[None, None, :],
                                      shape=(128, 3))
        return sim3_ransac(X1, X2, valid, *a, samples=torch.from_numpy(np.array(draw)), **kw)

    monkeypatch.setattr(ransac, "sim3_ransac", with_jax_samples)
    S = slam.multimap._merge_sim3(act, tgt, m["kf"], m["cand"])
    v = slam.multimap.last_verify
    s1, s2 = m["act"]["state"], m["target"]["state"]
    k1, k2 = m["kf"], m["cand"]
    jm = jmatching.match_nn(jnp.asarray(s1["kf_desc"][k1]), jnp.asarray(s2["kf_desc"][k2]),
                            jnp.asarray((s1["kf_mp"][k1] >= 0) & s1["kf_feat_valid"][k1]),
                            jnp.asarray((s2["kf_mp"][k2] >= 0) & s2["kf_feat_valid"][k2]),
                            max_dist=jmatching.TH_LOW, ratio=0.75, cross_check=True)
    jvalid = np.asarray(jm.valid)
    assert np.array_equal(v["valid"], jvalid)
    assert np.array_equal(v["idx"][jvalid], np.asarray(jm.idx)[jvalid])
    assert S is not None
    R, t, s = S
    np.testing.assert_allclose(R, m["R"], atol=1e-3)
    np.testing.assert_allclose(t, m["t"], atol=1e-3)
    assert abs(s - m["s"]) <= 1e-3
