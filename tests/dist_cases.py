"""Per-rank functions of the port's multi-rank CPU tests
(`tests/test_torch_parallel.py`, `test_torch_dist_pipeline.py`,
`test_torch_inertial.py`), run in spawned processes by
`orbslam3_tpu_torch.parallel.launch.run`. This module imports only torch,
numpy and the port, so that a rank never imports JAX; its inputs come as
numpy arrays (dicts of a NamedTuple's fields) and its results go back as
numpy.

`cases(rank, n, device, todo)` runs a list of (name, function name, args)
in one group, so that each world size is spawned once per test file."""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.ops import cameras as cam


def _t(d: dict, cls, dtype=None):
    """A NamedTuple `cls` of tensors from a dict of numpy arrays (None
    kept), floats cast to `dtype` when given."""
    out = {}
    for k, v in d.items():
        if v is None:
            out[k] = None
            continue
        x = torch.from_numpy(np.array(v, copy=True))
        out[k] = x.to(dtype) if dtype is not None and x.is_floating_point() else x
    return cls(**out)


def ba_problem(d: dict, dtype=None):
    from orbslam3_tpu_torch.optim import ba

    return _t(d, ba.BAProblem, dtype)


def solve_sharded(rank, n, dev, layout: str, prob: dict, params, kw: dict, dtype=None):
    """`solve_ba_sharded` ("obs") or `solve_ba_point_sharded` ("point") over
    the world group; with `dtype` the problem is cast first."""
    from orbslam3_tpu_torch.parallel import ba_sharded

    p = ba_problem(prob, dtype)
    par = torch.from_numpy(np.asarray(params)).to(p.cam_R.dtype)
    fn = ba_sharded.solve_ba_sharded if layout == "obs" else ba_sharded.solve_ba_point_sharded
    return fn(cam.CameraModel.PINHOLE, par, p, **kw)._asdict()


def sharded_query(rank, n, dev, q_vec, q_words, db, valid, n_best):
    from orbslam3_tpu_torch.parallel import kfdb_sharded

    T = torch.from_numpy
    ids, scores = kfdb_sharded.sharded_query(T(q_vec), T(q_words), T(db), T(valid),
                                             n_best=n_best)
    return dict(ids=ids, scores=scores)


def vi_group(rank, n, dev, prob: dict, params, kw: dict):
    """`solve_vi_ba` with this rank's block of the observations (padded to
    a multiple of n with invalid rows) over the world group."""
    import torch.distributed as dist

    from orbslam3_tpu_torch.optim import inertial as vi

    p = vi_problem(prob)
    O = p.obs_cam.shape[0]
    pad = (-O) % n
    b = (O + pad) // n

    def blk(x, val):
        x = torch.cat([x, torch.full((pad,) + x.shape[1:], val, dtype=x.dtype)])
        return x[rank * b:(rank + 1) * b]

    p = p._replace(obs_cam=blk(p.obs_cam, 0), obs_point=blk(p.obs_point, 0),
                   obs_uv=blk(p.obs_uv, 0.0), obs_sigma2=blk(p.obs_sigma2, 1.0),
                   obs_valid=blk(p.obs_valid, False))
    r = vi.solve_vi_ba(cam.CameraModel.PINHOLE, torch.from_numpy(np.asarray(params)), p,
                       group=dist.group.WORLD, **kw)
    return dict(state=r.state._asdict(), points=r.points, cost=r.cost, obs_inlier=r.obs_inlier)


def vi_problem(d: dict):
    from orbslam3_tpu_torch.optim import inertial as vi

    rest = {k: v for k, v in d.items() if k not in ("state", "edges")}
    return _t(rest, lambda **kw: vi.VIProblem(state=_t(d["state"], vi.BodyState),
                                              edges=_t(d["edges"], vi.ImuEdge), **kw))


def port_store(h: dict):
    """The port's `MapStore` on the CPU from a map's arrays and bookkeeping
    (`tests/test_torch_multimap.py::_host`'s dict)."""
    from orbslam3_tpu_torch.atlas import store as st

    s = h["state"]
    out = st.MapStore(Kmax=s["kf_R"].shape[0], Pmax=s["mp_pos"].shape[0],
                      Nf=s["kf_uv"].shape[1], device="cpu")
    out.state = st.MapState(**{k: torch.from_numpy(np.array(v, copy=True)) for k, v in s.items()})
    out.n_kf, out.n_mp = h["n_kf"], h["n_mp"]
    out.kf_ts, out.kf_frame_id = h["kf_ts"].copy(), h["kf_frame_id"].copy()
    out.free_mp_slots, out.free_kf_slots = list(h["free_mp"]), list(h["free_kf"])
    return out


def _map(store) -> dict:
    return dict(kf_R=store.state.kf_R, kf_t=store.state.kf_t, mp_pos=store.state.mp_pos)


def gba(rank, n, dev, store: dict, params, sigma2, iters: int, chunk: int):
    """`global_ba(dist=)` and `AsyncGBA(dist=)` (in chunks of `chunk`) over
    the world group on copies of one map; each's map after, the async one's
    chunk count and distributed solves, the replica checks."""
    from orbslam3_tpu_torch.parallel.context import DistributedContext
    from orbslam3_tpu_torch.pipeline import gba as gba_mod

    ctx = DistributedContext()
    P, S = torch.from_numpy(np.asarray(params)), torch.from_numpy(np.asarray(sigma2))
    a = port_store(store)
    cost = gba_mod.global_ba(a, cam.CameraModel.PINHOLE, P, S, iters=iters, dist=ctx)
    b = port_store(store)
    g = gba_mod.AsyncGBA(cam.CameraModel.PINHOLE, P, S, iters=iters, chunk=chunk, dist=ctx)
    g.start(b)
    while g.running:
        g.tick(b)
    return dict(sync=_map(a), sync_cost=cost, async_=_map(b), n_dist_solves=g.n_dist_solves,
                n_chunks=g.n_chunks, n_finished=g.n_finished, checks=ctx.replica_checks)


def diverged_gba(rank, n, dev, store: dict, params, sigma2):
    """`global_ba(dist=)` and `AsyncGBA(dist=).start` with the last rank's
    map moved by 1e-4 at one point: each must raise `ReplicaDivergence`
    before it solves. Whether each raised, the solves run, and whether the
    map is untouched."""
    from orbslam3_tpu_torch.parallel.context import DistributedContext, ReplicaDivergence
    from orbslam3_tpu_torch.pipeline import gba as gba_mod

    ctx = DistributedContext()
    P, S = torch.from_numpy(np.asarray(params)), torch.from_numpy(np.asarray(sigma2))
    s = port_store(store)
    if rank == n - 1:
        i = int(torch.nonzero(s.state.mp_valid)[0])
        s.state = s.state._replace(mp_pos=s.state.mp_pos.index_add(
            0, torch.tensor([i]), torch.full((1, 3), 1e-4)))
    before = {k: v.clone() for k, v in _map(s).items()}
    raised = []
    g = gba_mod.AsyncGBA(cam.CameraModel.PINHOLE, P, S, iters=3, chunk=3, dist=ctx)
    for what, fn in (("sync", lambda: gba_mod.global_ba(s, cam.CameraModel.PINHOLE, P, S,
                                                        iters=3, dist=ctx)),
                     ("async", lambda: g.start(s))):
        try:
            fn()
        except ReplicaDivergence:
            raised.append(what)
    return dict(raised=raised, n_solves=ctx.n_solves, running=g.running,
                unchanged=all(torch.equal(v, before[k]) for k, v in _map(s).items()),
                checks=ctx.replica_checks)


def loop_gba(rank, n, dev, store: dict, params, sigma2):
    """The loop closer's synchronous GBA (`LoopCloser._global_ba`) with a
    distributed context attached."""
    from orbslam3_tpu_torch.parallel.context import DistributedContext
    from orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser

    s = port_store(store)
    lc = LoopCloser(cam.CameraModel.PINHOLE, torch.from_numpy(np.asarray(params)), s, None,
                    torch.from_numpy(np.asarray(sigma2)))
    lc.dist = DistributedContext()
    lc._global_ba(s.n_kf - 1)
    return _map(s)


def kfdb_frame(rank, n, dev, voc: dict, descs, q, n_best: int):
    """`KeyFrameDB.query_frame_sharded` over the world group: a database of
    `descs` (one row a keyframe), queried with `q`."""
    from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB
    from orbslam3_tpu_torch.ops.bow import from_arrays
    from orbslam3_tpu_torch.parallel.context import DistributedContext

    v = from_arrays(voc["node_desc"], voc["node_children"], voc["node_word"],
                    voc["word_weight"], voc["depth"], voc["k"], "cpu")
    db = KeyFrameDB(v, Kmax=16)
    nf = descs.shape[1]
    for k, d in enumerate(descs):
        db.add(k, torch.from_numpy(d), torch.ones(nf, dtype=torch.bool))
    ids, scores = db.query_frame_sharded(torch.from_numpy(q), torch.ones(nf, dtype=torch.bool),
                                         DistributedContext(), n_best=n_best)
    return dict(ids=ids, scores=scores)


def multimap_replay(rank, n, dev, voc: dict, distributed: bool):
    """`scripts/multimap_replay.py`'s scene through the port's multi-map
    `System` (`tests/multimap_scene.py`), with `enable_distributed()` when
    asked: per frame the state and map count, the stored maps, the merges,
    the ATE, the post-merge GBA's solves over the group and the replica
    checks (a final one after the last frame)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import multimap_scene as MS

    from orbslam3_tpu_torch.ate import ate_rmse
    from orbslam3_tpu_torch.ops.bow import from_arrays
    from orbslam3_tpu_torch.parallel import comm

    v = from_arrays(voc["node_desc"], voc["node_children"], voc["node_word"],
                    voc["word_weight"], voc["depth"], voc["k"], "cpu")
    slam = MS.make_system(v)
    if distributed:
        slam.enable_distributed()
    mm = slam.multimap
    frames = MS.Scene().frames()
    states, maps, merges, stored = [], [], [], []
    comm.reset_stats()
    for k, (tag, img, ts, _) in enumerate(frames):
        n_maps, n_merges, store0 = mm.atlas.n_maps, mm.n_merges, slam.store
        slam.track_monocular(img, ts)
        if mm.atlas.n_maps > n_maps and store0 in mm.atlas.maps:
            stored.append((k, store0.n_kf))
        if mm.n_merges > n_merges:
            merges.append((k, store0.n_kf))
        states.append(slam.tracking_state.name)
        maps.append(mm.atlas.n_maps)
    checks = []
    if distributed:
        slam.dist.check_replicas(slam.store, "end")
        checks = slam.dist.replica_checks
    gt = [(ts, c) for tag, _, ts, c in frames if tag != "blank"]
    ts, pos = slam.get_trajectory()
    ate = ate_rmse(np.asarray(ts), np.asarray(pos), np.asarray([t for t, _ in gt]),
                   np.stack([c for _, c in gt]), with_scale=True, max_dt=0.01)
    return dict(states=states, maps=maps, merges=merges, stored=stored, ate=ate,
                n_kf=slam.n_keyframes, checks=checks, n_queries=mm.n_queries,
                n_sharded_queries=mm.n_sharded_queries,
                n_dist_solves=slam.dist.n_solves if distributed else 0,
                collectives=comm.stats_copy())


def card_point_sharded(rank, n, dev, prob: dict, params, bf: float, kw: dict):
    """`solve_ba_point_sharded` with the problem on this rank's device."""
    from orbslam3_tpu_torch.optim import ba
    from orbslam3_tpu_torch.parallel import ba_sharded

    p = ba.BAProblem(*(None if v is None else v.to(dev) for v in ba_problem(prob)))
    return ba_sharded.solve_ba_point_sharded(
        cam.CameraModel.PINHOLE, torch.from_numpy(np.asarray(params)).to(dev), p, bf=bf,
        **kw)._asdict()


def card_query(rank, n, dev, q_vec, q_words, db, valid, n_best: int):
    """`KeyFrameDB`'s sharded query with the database on this rank's device
    (`DistributedContext.kfdb_query`)."""
    from orbslam3_tpu_torch.parallel.context import DistributedContext

    T = lambda x: torch.from_numpy(np.asarray(x)).to(dev)  # noqa: E731
    ids, scores = DistributedContext().kfdb_query(T(q_vec), T(q_words), T(db), T(valid),
                                                  n_best=n_best)
    return dict(ids=ids, scores=scores)


def cases(rank, n, dev, todo: list) -> dict:
    """Run each (name, function name, args) of `todo` in this group, in order;
    {name: result}."""
    return {name: globals()[fn](rank, n, dev, *args) for name, fn, args in todo}
