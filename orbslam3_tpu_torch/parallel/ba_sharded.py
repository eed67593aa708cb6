"""Distributed bundle adjustment over a `torch.distributed` group — the port
of `orbslam3_tpu/parallel/ba_sharded.py`.

Two layouts, each rank one process holding the whole problem (the SPMD
replicas of a distributed map hold identical copies) and solving its block:

* observations sharded, state replicated (`solve_ba_sharded`): the
  observation axis is padded to a multiple of the group size and cut into
  equal blocks; every sum over observations is a local sum plus one
  all-reduce (`optim/ba.py`, `group`), and the reduced camera system is
  solved redundantly on every rank;
* the map-point axis block-partitioned (`solve_ba_point_sharded`): each rank
  owns P/n points and every observation of them (`prep_point_sharded`, host
  numpy, identical on every rank), so the point blocks need no collective,
  and with the dense Schur path (the default, as the reference's) the only
  one is an all-reduce of the packed reduced camera system per LM
  iteration. Point state and its coupling tensor scale down with the ranks.

Where the reference lifts process-local replicas into global arrays over a
mesh, each rank here slices its own block out of its replica
(`local_block`).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch.optim import ba as ba_mod
from orbslam3_tpu_torch.parallel import comm

# The observation fields of a `BAProblem` (blocked in both layouts).
OBS_FIELDS = ("obs_cam", "obs_point", "obs_uv", "obs_ur", "obs_sigma2", "obs_valid", "obs_right")
# The reference's `point_sharded_specs`: the fields blocked along their
# leading axis in the point-partitioned layout; the others ("cam_R",
# "cam_t", "cam_fixed") are replicated. Of the result, the cameras and the
# cost are replicated, the points and `obs_inlier` blocked.
POINT_SHARDED_FIELDS = ("points", "point_valid") + OBS_FIELDS


def _group(group):
    """(group or None when there is one rank, size, rank)."""
    g = comm.resolve(group)
    n, r = comm.world(g)
    return (g if n > 1 else None), n, r


def local_block(prob: ba_mod.BAProblem, rank: int, n: int, fields=POINT_SHARDED_FIELDS
                ) -> ba_mod.BAProblem:
    """Rank `rank`'s block of each of `fields` (leading axis cut in `n`
    equal blocks); the other fields as they are."""
    out = {}
    for f in fields:
        x = getattr(prob, f)
        if x is not None:
            b = x.shape[0] // n
            out[f] = x[rank * b:(rank + 1) * b]
    return prob._replace(**out)


def pad_obs(prob: ba_mod.BAProblem, n: int) -> ba_mod.BAProblem:
    """Pad the observation axis to a multiple of `n` with invalid rows."""
    O = prob.obs_cam.shape[0]
    pad = (-O) % n
    if pad == 0:
        return prob

    def cat(x, val):
        return torch.cat([x, torch.full((pad,) + x.shape[1:], val, dtype=x.dtype,
                                        device=x.device)])

    return prob._replace(
        obs_cam=cat(prob.obs_cam, 0), obs_point=cat(prob.obs_point, 0),
        obs_uv=cat(prob.obs_uv, 0.0), obs_ur=cat(prob.obs_ur, -1.0),
        obs_sigma2=cat(prob.obs_sigma2, 1.0), obs_valid=cat(prob.obs_valid, False),
        obs_right=None if prob.obs_right is None else cat(prob.obs_right, False))


def solve_ba_sharded(model, params: torch.Tensor, prob: ba_mod.BAProblem, group=None,
                     bf: float = 0.0, iters: int = 10, pcg_iters: int = 50,
                     dense_schur: bool = False) -> ba_mod.BAResult:
    """`optim.ba.solve_ba` with the observations sharded over `group` (the
    world group by default), the matrix-free PCG path unless `dense_schur`.
    Every rank passes the whole problem and gets the whole result (cameras
    and points replicated, `obs_inlier` gathered, in the caller's order);
    equal to the single-device solve up to summation order."""
    g, n, r = _group(group)
    O = prob.obs_cam.shape[0]
    loc = local_block(pad_obs(prob, n), r, n, OBS_FIELDS)
    res = ba_mod.solve_ba(model, params, loc, bf=bf, iters=iters, pcg_iters=pcg_iters,
                          dense_schur=dense_schur, group=g)
    if g is None:
        return res
    return res._replace(obs_inlier=comm.all_gather(res.obs_inlier, g, "ba/gather")[:O])


def prep_point_sharded(prob: ba_mod.BAProblem, n: int):
    """Host-side layout of the point-partitioned solve: the point axis padded
    to a multiple of `n` (ss = P/n points a shard, blocks in order), every
    observation bucketed into its owner's equal-size block of maxO rows
    (local point indices, order kept within a shard). The bucketing is numpy
    on the host, the same on every rank; the rows are gathered on the
    problem's device. Returns (prob_s, dst, fill, P_orig): `dst` (n * maxO,)
    the source row of each slot, `fill` whether the slot holds one."""
    Pn = prob.points.shape[0]
    pad_p = (-Pn) % n
    if pad_p:
        pts, pv = prob.points, prob.point_valid
        prob = prob._replace(
            points=torch.cat([pts, torch.zeros((pad_p, 3), dtype=pts.dtype, device=pts.device)]),
            point_valid=torch.cat([pv, torch.zeros(pad_p, dtype=pv.dtype, device=pv.device)]))
    ss = (Pn + pad_p) // n

    obs_pt = prob.obs_point.cpu().numpy()
    owner = obs_pt // ss
    counts = np.bincount(owner, minlength=n)
    maxO = max(int(counts.max()), 1)
    perm = np.argsort(owner, kind="stable")
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    dst = np.zeros(n * maxO, np.int64)
    fill = np.zeros(n * maxO, bool)
    for sh in range(n):
        src = perm[starts[sh]:starts[sh] + counts[sh]]
        dst[sh * maxO:sh * maxO + len(src)] = src
        fill[sh * maxO:sh * maxO + len(src)] = True

    dev = prob.obs_point.device
    take = torch.from_numpy(dst).to(dev)
    f = torch.from_numpy(fill).to(dev)
    local_pt = torch.from_numpy(((obs_pt[dst] - owner[dst] * ss) * fill).astype(np.int32)).to(dev)
    prob_s = prob._replace(
        obs_cam=torch.where(f, prob.obs_cam[take], 0),
        obs_point=local_pt,
        obs_uv=prob.obs_uv[take],
        obs_ur=torch.where(f, prob.obs_ur[take], -1.0),
        obs_sigma2=torch.where(f, prob.obs_sigma2[take], 1.0),
        obs_valid=f & prob.obs_valid[take],
        obs_right=None if prob.obs_right is None else f & prob.obs_right[take])
    return prob_s, dst, fill, Pn


def run_point_sharded(model, params: torch.Tensor, prob_l: ba_mod.BAProblem, group=None,
                      bf: float = 0.0, iters: int = 10, pcg_iters: int = 50,
                      dense_schur: bool = True) -> ba_mod.BAResult:
    """The point-partitioned solve of this rank's block (`local_block` of
    `prep_point_sharded`'s layout). Cameras and cost come back replicated,
    points and `obs_inlier` as this rank's block; both feed the next call
    (an interruptible GBA's chunks)."""
    g, _, _ = _group(group)
    return ba_mod.solve_ba(model, params, prob_l, bf=bf, iters=iters, pcg_iters=pcg_iters,
                           dense_schur=dense_schur, group=g, point_axis_local=True)


def solve_ba_point_sharded(model, params: torch.Tensor, prob: ba_mod.BAProblem, group=None,
                           bf: float = 0.0, iters: int = 10, pcg_iters: int = 50,
                           dense_schur: bool = True) -> ba_mod.BAResult:
    """The point-partitioned solve of a whole problem over `group`: the
    layout, this rank's block solved, the points and inliers gathered back
    into the caller's order. Equal to the single-device solve up to
    summation order."""
    g, n, r = _group(group)
    prob_s, dst, fill, Pn = prep_point_sharded(prob, n)
    res = run_point_sharded(model, params, local_block(prob_s, r, n), g, bf=bf, iters=iters,
                            pcg_iters=pcg_iters, dense_schur=dense_schur)
    points, inl_s = res.points, res.obs_inlier
    if g is not None:
        points = comm.all_gather(points, g, "ba/gather")
        inl_s = comm.all_gather(inl_s, g, "ba/gather")
    dev = inl_s.device
    sel = torch.from_numpy(np.flatnonzero(fill)).to(dev)
    inl = torch.zeros(prob.obs_point.shape[0], dtype=torch.bool, device=dev)
    inl[torch.from_numpy(dst[fill]).to(dev)] = inl_s[sel]
    return res._replace(points=points[:Pn], obs_inlier=inl)
