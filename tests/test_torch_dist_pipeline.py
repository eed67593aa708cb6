"""Port parity: the distributed layer as the live pipeline calls it
(`orbslam3_tpu_torch/parallel/context.py` under `pipeline/gba.py`, the loop
closer, the keyframe database and the multi-map `System`) against the JAX
package's (`tests/test_dist_pipeline.py`'s cases and inputs) on the CPU.

The port's ranks are spawned processes over gloo, one thread each
(`parallel/launch.py`; their functions are `tests/dist_cases.py`, which
imports no JAX); the 2-rank cases run in one spawn. The JAX side's
`DistributedContext` spans the suite's virtual CPU devices
(`tests/conftest.py`). Tolerances: poses and points within 2e-3 (the JAX
suite's own for these cases), the KFDB query's ids exact up to keyframes
whose scores tie within 1e-6, scores within 1e-6; the two-rank `System`
(BASELINE config 5's Atlas on `scripts/multimap_replay.py`'s scene) as many
merges as the port's one-process run, each within 2 keyframes, its ATE
within 5e-3 m of it (`scripts/drive_multimap_distributed.py`'s gates), its
GBA over the group, and the ranks' map digests equal."""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))

import dist_cases  # noqa: E402
from orbslam3_tpu.ops import cameras as cam_j  # noqa: E402
from orbslam3_tpu.ops import features as feat_j  # noqa: E402
from orbslam3_tpu.parallel import ba_sharded as bs_j  # noqa: E402
from orbslam3_tpu.parallel.context import DistributedContext as Ctx_j  # noqa: E402
from orbslam3_tpu.pipeline import gba as gba_j  # noqa: E402
from orbslam3_tpu_torch.ops import cameras as cam_t  # noqa: E402
from orbslam3_tpu_torch.parallel import launch  # noqa: E402
from orbslam3_tpu_torch.parallel.context import digests_equal  # noqa: E402
from orbslam3_tpu_torch.pipeline import gba as gba_t  # noqa: E402
from test_gba_async import NF, PARAMS, _build_store  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _ctx_j(n=2):
    return Ctx_j(bs_j.make_mesh(jax.devices()[:n], axis="pt"))


def _s2():
    return feat_j.sigma2(feat_j.OrbParams(n_levels=3))


def _host(store) -> dict:
    """A JAX store's arrays and host bookkeeping, copied to numpy."""
    return dict(state={k: np.array(v) for k, v in store.state._asdict().items()},
                n_kf=store.n_kf, n_mp=store.n_mp, kf_ts=store.kf_ts.copy(),
                kf_frame_id=store.kf_frame_id.copy(), free_mp=list(store.free_mp_slots),
                free_kf=list(store.free_kf_slots))


def _voc_arrays(voc) -> dict:
    return dict(node_desc=np.asarray(voc.node_desc), node_children=np.asarray(voc.node_children),
                node_word=np.asarray(voc.node_word), word_weight=np.asarray(voc.word_weight),
                depth=voc.depth, k=voc.k)


def _kfdb_inputs():
    """`test_dist_pipeline.py::test_kfdb_sharded_query_matches_dense_top1`'s
    vocabulary, 10 keyframes and query (a noisy copy of keyframe 6)."""
    from orbslam3_tpu.ops import bow as bow_j

    rng = np.random.default_rng(11)
    voc = bow_j.build_vocabulary(rng.integers(0, 256, (400, 32), dtype=np.uint8), k=4, depth=3,
                                 seed=0)
    descs = np.stack([rng.integers(0, 256, (NF, 32), dtype=np.uint8) for _ in range(10)])
    q = descs[6].copy()
    q[: NF // 4] ^= rng.integers(0, 256, (NF // 4, 32), dtype=np.uint8).astype(np.uint8) & 3
    return voc, descs, q


@pytest.fixture(scope="module")
def two():
    """Every 2-rank pipeline case in one spawn."""
    params, s2 = np.array(PARAMS), _s2()
    voc, descs, q = _kfdb_inputs()
    todo = [
        ("gba3", "gba", (_host(_build_store(np.random.default_rng(3))[0]), params, s2, 8, 8)),
        ("gba7", "gba", (_host(_build_store(np.random.default_rng(7))[0]), params, s2, 9, 3)),
        ("loop", "loop_gba", (_host(_build_store(np.random.default_rng(5))[0]), params, s2)),
        ("diverged", "diverged_gba",
         (_host(_build_store(np.random.default_rng(5))[0]), params, s2)),
        ("kfdb", "kfdb_frame", (_voc_arrays(voc), descs, q, 3)),
    ]
    return launch.run(dist_cases.cases, 2, (todo,), device="cpu", threads=1)


def _port(store_j):
    return dist_cases.port_store(_host(store_j))


def _args_t():
    return cam_t.CameraModel.PINHOLE, torch.from_numpy(np.array(PARAMS)), torch.from_numpy(_s2())


def _same(got: dict, ref_state, atol=2e-3, what=""):
    for k in ("kf_R", "kf_t", "mp_pos"):
        ref = ref_state[k] if isinstance(ref_state, dict) else getattr(ref_state, k)
        np.testing.assert_allclose(got[k], np.asarray(ref), rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


def test_global_ba_dist_matches_jax(two):
    """`global_ba(dist=)` over 2 ranks against JAX's `global_ba(dist=)` over 2
    devices and against the port's one-device `global_ba` (8 iterations)."""
    a = _build_store(np.random.default_rng(3))[0]
    b = _port(a)
    gba_j.global_ba(a, cam_j.CameraModel.PINHOLE, PARAMS, jnp.asarray(_s2()), iters=8,
                    pcg_iters=40, dist=_ctx_j())
    gba_t.global_ba(b, *_args_t(), iters=8)
    got = two[0]["gba3"]
    _same(got["sync"], a.state, what="vs JAX")
    _same(got["sync"], b.state, what="vs single")
    np.testing.assert_array_equal(two[1]["gba3"]["sync"]["mp_pos"], got["sync"]["mp_pos"])


def test_gba_refuses_diverged_replicas(two):
    """With one rank's map moved by 1e-4 at one point, `global_ba(dist=)` and
    `AsyncGBA(dist=).start` raise `ReplicaDivergence` on every rank before
    any solve: no solve over the group, no GBA left running, the maps as
    they were, and each check recorded unequal."""
    for r in two:
        got = r["diverged"]
        assert got["raised"] == ["sync", "async"], got["raised"]
        assert got["n_solves"] == 0 and not got["running"] and got["unchanged"]
        assert [(w, eq) for w, eq, _ in got["checks"]] == [("gba start", False)] * 2
    assert two[0]["diverged"]["checks"] == two[1]["diverged"]["checks"]


def test_async_gba_dist_three_chunks_matches_jax(two):
    """`AsyncGBA(dist=)` in three chunks of 3 (`n_dist_solves == 3`) against
    JAX's over 2 devices and against the port's plain chunked `AsyncGBA`;
    the replicas' digests compared at the start, equal."""
    a = _build_store(np.random.default_rng(7))[0]
    b = _port(a)
    g = gba_j.AsyncGBA(cam_j.CameraModel.PINHOLE, PARAMS, jnp.asarray(_s2()), iters=9, chunk=3,
                       dist=_ctx_j())
    g.start(a)
    while g.running:
        g.tick(a)
    gt = gba_t.AsyncGBA(*_args_t(), iters=9, chunk=3)
    gt.start(b)
    while gt.running:
        gt.tick(b)
    for r in two:
        got = r["gba7"]
        assert got["n_dist_solves"] == got["n_chunks"] == 3 and got["n_finished"] == 1
        assert digests_equal(got["checks"]) and len(got["checks"]) == 2  # global_ba's, then this
    got = two[0]["gba7"]["async_"]
    _same(got, a.state, what="vs JAX")
    _same(got, b.state, what="vs single")
    np.testing.assert_array_equal(two[1]["gba7"]["async_"]["mp_pos"], got["mp_pos"])


def test_loop_closer_dist_gba_matches_jax(two):
    """The loop closer's synchronous GBA (`LoopCloser._global_ba`, 10
    iterations) with a distributed context against JAX's over 2 devices and
    against the port's without one."""
    from orbslam3_tpu.pipeline.loop_closing import LoopCloser as LC_j
    from orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser as LC_t

    a = _build_store(np.random.default_rng(5))[0]
    b = _port(a)
    lj = LC_j(cam_j.CameraModel.PINHOLE, PARAMS, a, None, jnp.asarray(_s2()))
    lj.dist = _ctx_j()
    lj._global_ba(a.n_kf - 1)
    model, params, s2 = _args_t()
    LC_t(model, params, b, None, s2)._global_ba(b.n_kf - 1)
    _same(two[0]["loop"], a.state, what="vs JAX")
    _same(two[0]["loop"], b.state, what="vs single")


def test_query_frame_sharded_ranks_keyframe_6_first(two):
    """`KeyFrameDB.query_frame_sharded` on 2 ranks: keyframe 6 (the query's
    source) first, as JAX's over 2 devices ranks it; ids exact up to ties
    within 1e-6, scores within 1e-6, both ranks equal."""
    from orbslam3_tpu.atlas.kfdb import KeyFrameDB as DB_j

    voc, descs, q = _kfdb_inputs()
    db = DB_j(voc, Kmax=16)
    for k, d in enumerate(descs):
        db.add(k, jnp.asarray(d), jnp.ones(NF, bool))
    ids_j, sc_j = db.query_frame_sharded(jnp.asarray(q), jnp.ones(NF, bool), _ctx_j(), n_best=3)
    ids_j, sc_j = np.asarray(ids_j), np.asarray(sc_j)
    got = two[0]["kfdb"]
    assert got["ids"][0] == 6 == ids_j[0], (got, ids_j)
    np.testing.assert_allclose(got["scores"], sc_j, rtol=0, atol=1e-6)
    for i in range(len(ids_j)):
        tied = np.abs(sc_j - sc_j[i]) <= 1e-6
        assert got["ids"][i] == ids_j[i] or (tied.sum() > 1 and got["ids"][i] in ids_j[tied])
    np.testing.assert_array_equal(two[1]["kfdb"]["ids"], got["ids"])


def test_two_rank_system_on_multimap_scene():
    """Config 5 on the CPU: `scripts/multimap_replay.py`'s scene (320x240,
    400 features, Kmax 64, Pmax 8192, the Atlas; no place recognition, so
    the post-merge GBA is the synchronous `global_ba(dist=)`) through
    `System.enable_distributed()` on 2 ranks, against the same System in one
    process run meanwhile: the map stored at the same frame, as many merges,
    each within 2 keyframes, |ATE(2 ranks) - ATE(one)| < 5e-3 m
    (`scripts/drive_multimap_distributed.py`'s gates), the post-merge GBA
    run over the group, every merge
    query of the stored map sharded, and both ranks' map digests equal at
    the GBA's start and after the last frame."""
    import multimap_replay as MR

    voc = _voc_arrays(MR.Scene().make_vocabulary())
    out = {}

    def ranks():
        try:
            out["dist"] = launch.run(dist_cases.cases, 2,
                                     ([("run", "multimap_replay", (voc, True))],), device="cpu",
                                     threads=1)
        except BaseException as e:  # reported below
            out["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    one = dist_cases.multimap_replay(0, 1, "cpu", voc, False)
    th.join()
    if "error" in out:
        raise out["error"]
    r0, r1 = (r["run"] for r in out["dist"])
    print("one", one["stored"], one["merges"], one["ate"], "two", r0["stored"], r0["merges"],
          r0["ate"], r0["collectives"])
    assert one["stored"] and one["merges"], one
    assert r0["stored"] == one["stored"]
    # The sharded query scores keyframes without covisibility groups, so
    # the merge may come a keyframe or two apart (JAX's drive gates the
    # count of merges and the ATE).
    assert len(r0["merges"]) == len(one["merges"])
    assert all(abs(a[1] - b[1]) <= 2 for a, b in zip(r0["merges"], one["merges"]))
    assert r0["maps"][-1] == one["maps"][-1] == 1
    assert abs(r0["ate"] - one["ate"]) < 5e-3, (r0["ate"], one["ate"])
    assert r0["n_dist_solves"] >= 1 and r0["n_sharded_queries"] == r0["n_queries"] >= 1
    for r in (r0, r1):
        assert digests_equal(r["checks"]) and len(r["checks"]) >= 2, r["checks"]
    assert r0["checks"] == r1["checks"] and r0["ate"] == r1["ate"]
