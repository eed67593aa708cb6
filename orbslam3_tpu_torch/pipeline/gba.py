"""Global bundle adjustment over a whole map on torch tensors — the port of
`orbslam3_tpu/pipeline/gba.py` (`RunGlobalBundleAdjustment`,
`LoopClosing.cc:2513`), on one device or over a `torch.distributed` group.

Every feature slot with a map point is one observation row, so at config
1's Kmax 256 the problem has 256 cameras and 256 x Nf rows, and
`auto_dense_schur` picks the dense path: a (6 Kmax)^2 reduced camera system
in float32 (`optim/ba.py::_solve_ba_dense`, every camera in it). The
runner's default map (Kmax 512, Pmax 65536) is past its 4 GiB budget, so
there the GBA takes the matrix-free PCG path (`optim/ba.py::_solve_ba_pcg`,
50 CG steps per LM iteration).

`AsyncGBA` is the reference's interruptible GBA: the map is snapshotted at
`start`, each `tick` launches `chunk` LM iterations on the snapshot with no
host read (nothing is read from them until `_finish`), `abort` drops the
solve, and `_finish` reads the result back once and folds it into the
current map, carrying the keyframes and points made meanwhile through
their anchors (`LoopClosing.cc:2559-2680`).

With a `DistributedContext` (`dist`, `parallel/context.py`) of more than one
rank, the solve is the point-partitioned dense-Schur solve over its group
(BASELINE config 5): `start` lays the problem out once (each rank keeps its
block of the points), each `tick` runs one chunk over the group and feeds
its cameras and point block into the next, and the end gathers the points
(`_fold_dist_result`) before the same `_finish`. Every rank must tick
together: the replicas' map digests are compared at each start, which
raises rather than solve over replicas that differ
(`DistributedContext.check_replicas`).
"""

from __future__ import annotations

import numpy as np
import torch

from orbslam3_tpu_torch import spans
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.optim import ba as ba_mod
from orbslam3_tpu_torch.pipeline.tracking import fetch_bundle


def build_gba_problem(state: st.MapState, fixed: torch.Tensor, sigma2_table) -> ba_mod.BAProblem:
    """The whole-map `BAProblem` of a `MapState`: one observation row per
    feature slot, valid where it holds a map point of a valid keyframe."""
    K, Nf = state.Kmax, state.Nf
    dev = state.kf_R.device
    obs_mp = state.kf_mp.reshape(-1)
    obs_cam = torch.arange(K, dtype=torch.int32, device=dev).repeat_interleave(Nf)
    obs_valid = ((obs_mp >= 0) & state.kf_feat_valid.reshape(-1)
                 & state.kf_valid[obs_cam.to(torch.int64)])
    octave = torch.clamp(state.kf_octave.reshape(-1), 0, sigma2_table.shape[0] - 1)
    return ba_mod.BAProblem(
        cam_R=state.kf_R, cam_t=state.kf_t, cam_fixed=fixed, points=state.mp_pos,
        point_valid=state.mp_valid, obs_cam=obs_cam, obs_point=torch.clamp(obs_mp, min=0),
        obs_uv=state.kf_uv.reshape(-1, 2), obs_ur=state.kf_ur.reshape(-1),
        obs_sigma2=sigma2_table[octave.to(torch.int64)], obs_valid=obs_valid)


def gba_step(model, params, state: st.MapState, fixed, sigma2_table, bf: float, iters: int):
    """`iters` LM iterations of the whole-map BA (the reference's `_gba_jit`):
    (new state with the free poses and the valid points moved, cost). The
    matrix-free path sums each keyframe's Nf rows by one reduction."""
    prob = build_gba_problem(state, fixed, sigma2_table)
    dense = ba_mod.auto_dense_schur(state.Kmax, state.Pmax)
    res = ba_mod.solve_ba(model, params, prob, bf=bf, iters=iters, dense_schur=dense,
                          obs_per_cam=None if dense else state.Nf)
    new_state = state._replace(
        kf_R=torch.where(fixed[:, None, None], state.kf_R, res.cam_R),
        kf_t=torch.where(fixed[:, None], state.kf_t, res.cam_t),
        mp_pos=torch.where(state.mp_valid[:, None], res.points, state.mp_pos),
    )
    return new_state, res.cost


def _fixed(store: st.MapStore, fix_first: bool = True) -> torch.Tensor:
    fixed = ~store.state.kf_valid
    if fix_first:
        fixed = fixed.clone()
        fixed[0] = True
    return fixed


class AsyncGBA:
    """Interruptible global BA, time-sliced from the frame loop (the
    reference's transient GBA thread, `LoopClosing.cc:1323`, abort flag
    `mbStopGBA`, `:1099-1118`)."""

    def __init__(self, model, params, sigma2_table, bf: float = 0.0, iters: int = 10,
                 chunk: int = 2, dist=None):
        self.model = model
        self.params = params
        self.sigma2_table = sigma2_table
        self.bf = bf
        self.iters = iters
        self.chunk = chunk
        self.dist = dist  # DistributedContext: each chunk over its group
        self._state = None  # the in-flight optimized snapshot (device)
        self._prob_l = None  # distributed: this rank's block of the laid-out problem
        self.n_finished = 0
        self.n_aborted = 0
        self.n_chunks = 0  # chunks launched
        self.n_dist_solves = 0  # chunks run over the group

    @property
    def running(self) -> bool:
        return self._state is not None

    def start(self, store: st.MapStore):
        """Snapshot the map and begin the solve (a running one is aborted,
        `LoopClosing.cc:1099`)."""
        if self.running:
            self.abort()
        dist = self.dist is not None and self.dist.n_shards > 1
        if dist:  # raises before anything starts when the replicas differ
            self.dist.check_replicas(store, "gba start")
        s = store.state
        self._state = s
        self._fixed = _fixed(store)
        self._it = 0
        # Host mirrors for the finish-time propagation guard.
        self._valid0_kf = s.kf_valid.cpu().numpy().copy()
        self._valid0_mp = s.mp_valid.cpu().numpy().copy()
        self._first0 = s.mp_first_kf.cpu().numpy().copy()
        self._ts0 = store.kf_ts.copy()
        self._R0, self._t0 = s.kf_R, s.kf_t
        self._prob_l = None
        if dist:
            prob = build_gba_problem(s, self._fixed, self.sigma2_table)
            self._prob_l, _ = self.dist.prep_ba(prob)

    def abort(self):
        """Drop the in-flight solve and its snapshot; the map keeps its
        pose-graph state."""
        if self.running:
            self._state = None
            self._R0 = self._t0 = None
            self._prob_l = None
            self.n_aborted += 1

    def tick(self, store: st.MapStore) -> bool:
        """Launch one chunk of iterations; True when the solve just finished
        and its result was folded into `store`, the map it was started on:
        whatever makes another map active (`System._attach_store`,
        `MultiMapManager._do_merge`) aborts the solve first."""
        with spans.span("GBA chunk"):
            if not self.running:
                return False
            n = min(self.chunk, self.iters - self._it)
            with spans.span("gba/chunk"):
                if self._prob_l is not None:
                    res = self.dist.run_ba(self.model, self.params, self._prob_l, bf=self.bf,
                                           iters=n)
                    self._prob_l = self._prob_l._replace(cam_R=res.cam_R, cam_t=res.cam_t,
                                                         points=res.points)
                    self.n_dist_solves += 1
                else:
                    self._state, _ = gba_step(self.model, self.params, self._state, self._fixed,
                                              self.sigma2_table, self.bf, n)
            self._it += n
            self.n_chunks += 1
            if self._it < self.iters:
                return False
            if self._prob_l is not None:
                self._fold_dist_result()
            self._finish(store)
            return True

    def _fold_dist_result(self):
        """The distributed solve's cameras and gathered points written into
        the snapshot (fixed cameras and invalid points as they were), so
        that `_finish` sees one layout on both paths."""
        s, p = self._state, self._prob_l
        pts = self.dist.fetch(p.points)[:s.Pmax]
        self._state = s._replace(
            kf_R=torch.where(self._fixed[:, None, None], s.kf_R, p.cam_R),
            kf_t=torch.where(self._fixed[:, None], s.kf_t, p.cam_t),
            mp_pos=torch.where(s.mp_valid[:, None], pts, s.mp_pos))
        self._prob_l = None

    def join(self, store: st.MapStore):
        """Run to completion (`System::Shutdown`, `System.cc:474-500`)."""
        while self.running:
            self.tick(store)

    def _finish(self, store: st.MapStore):
        """Fold the optimized snapshot into the current map with the
        spanning-tree propagation of `LoopClosing.cc:2559-2680`: keyframes
        of the snapshot (same slot, same timestamp) take their GBA pose; a
        keyframe made meanwhile keeps its pose relative to the snapshot
        keyframe before it in time; points of the snapshot take their GBA
        position, points made meanwhile ride their first keyframe's
        correction from its current pose. One read-back of everything."""
        opt = self._state
        self._state = None
        s = store.state
        h = fetch_bundle(dict(Rg=opt.kf_R, tg=opt.kf_t, pg=opt.mp_pos, R0=self._R0, t0=self._t0,
                              Rc=s.kf_R, tc=s.kf_t, pc=s.mp_pos, valid_kf=s.kf_valid,
                              valid_mp=s.mp_valid, first_now=s.mp_first_kf))
        Rg, tg, pg, R0, t0, Rc, tc, pc = (h[k] for k in ("Rg", "tg", "pg", "R0", "t0", "Rc", "tc",
                                                         "pc"))
        valid_kf, valid_mp, first_now = h["valid_kf"], h["valid_mp"], h["first_now"]
        in_gba = self._valid0_kf & valid_kf & (self._ts0 == store.kf_ts)
        newR, newt = Rc.copy(), tc.copy()
        newR[in_gba] = Rg[in_gba]
        newt[in_gba] = tg[in_gba]
        gba_ids = np.flatnonzero(in_gba)
        if len(gba_ids):
            order = gba_ids[np.argsort(store.kf_ts[gba_ids])]
            for k in np.flatnonzero(valid_kf & ~in_gba):
                pos = np.searchsorted(store.kf_ts[order], store.kf_ts[k])
                a = order[min(max(pos - 1, 0), len(order) - 1)]
                R_rel = Rc[k] @ R0[a].T  # T_k T_a^-1
                t_rel = tc[k] - R_rel @ t0[a]
                newR[k] = R_rel @ Rg[a]
                newt[k] = R_rel @ tg[a] + t_rel
        in_gba_mp = self._valid0_mp & valid_mp & (self._first0 == first_now)
        newp = pc.copy()
        newp[in_gba_mp] = pg[in_gba_mp]
        for p in np.flatnonzero(valid_mp & ~in_gba_mp):
            a = first_now[p]
            if a < 0 or not valid_kf[a]:
                continue
            Xc = Rc[a] @ newp[p] + tc[a]  # the anchor's frame before the correction
            newp[p] = newR[a].T @ (Xc - newt[a])
        T = store.tensor
        store.state = s._replace(kf_R=T(newR.astype(np.float32)), kf_t=T(newt.astype(np.float32)),
                                 mp_pos=T(newp.astype(np.float32)))
        store.bump()
        self.n_finished += 1


def global_ba(store: st.MapStore, model, params, sigma2_table, bf: float = 0.0, iters: int = 10,
              fix_first: bool = True, dist=None) -> float:
    """Whole-map BA in one go (10 iterations, `LoopClosing.cc:2520`);
    mutates the store, returns the final robust cost (a host read). With a
    `DistributedContext` of more than one rank, the point-partitioned solve
    over its group (equal to the single-device one up to summation order)."""
    fixed = _fixed(store, fix_first)
    s = store.state
    if dist is not None and dist.n_shards > 1:
        dist.check_replicas(store, "gba start")
        prob_l, _ = dist.prep_ba(build_gba_problem(s, fixed, sigma2_table))
        res = dist.run_ba(model, params, prob_l, bf=bf, iters=iters)
        pts = dist.fetch(res.points)[:s.Pmax]
        store.state = s._replace(
            kf_R=torch.where(fixed[:, None, None], s.kf_R, res.cam_R),
            kf_t=torch.where(fixed[:, None], s.kf_t, res.cam_t),
            mp_pos=torch.where(s.mp_valid[:, None], pts, s.mp_pos))
        store.bump()
        return float(res.cost)
    new_state, cost = gba_step(model, params, s, fixed, sigma2_table, bf, iters)
    store.state = new_state
    store.bump()
    return float(cost)
