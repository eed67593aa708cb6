"""The Atlas's multi-map on torch tensors — the port of
`orbslam3_tpu/pipeline/multimap.py`: a map stored on hard tracking loss, and
merged back when place recognition finds it again.

* `on_frame_done`: five LOST frames in a row store a map of more than
  `min_kfs_to_store` keyframes in the Atlas and start a fresh one
  (`Tracking::CreateMapInAtlas`, `Tracking.cc:1239-1257, 2087`); a smaller
  map is reset. Localization mode never stores or resets.
* `on_new_keyframe`: the keyframe goes into its map's keyframe database;
  with a stored map, `_try_merge` queries each stored map's database
  (`KeyFrameDB.query_frame` over its covisibility) and verifies the
  candidates (`_merge_sim3`: the cross-checked match of the two keyframes,
  kernel B1 unwindowed twice; Sim3 RANSAC, its samples from a generator
  seeded with kf_id + 7777 as the reference's `PRNGKey`, the scale fixed for
  stereo, RGB-D and stereo-inertial; `optimize_sim3`; the world Sim3; the
  inertial gate).
* `_do_merge` (`LoopClosing::MergeLocal`, `LoopClosing.cc:1332`): the active
  map moves into the stored one (`map_merging.merge_maps`), every subsystem
  follows it, the trajectory is re-rooted, the weld fuse (`fuse_into_kf`
  over the target's earlier points, kernel B1 windowed, one launch per Nf
  chunk per migrated keyframe), the weld BA and the essential graph
  (`_weld_and_distribute`), then the post-merge global BA.

The host reads the device at each step of a keyframe that reaches a query
or a verification, as the reference does; they happen on keyframe frames
only. Each step is a `spans.span` ("try merge", "merge: ..."), which
`entry.replay` records. With `System.enable_distributed` (config 5) the
query scores each stored map's database over the group
(`KeyFrameDB.query_frame_sharded`) and the post-merge global BA runs over
it (`pipeline/gba.py`, its `dist`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from orbslam3_tpu_torch import spans
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.atlas.atlas import Atlas
from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB
from orbslam3_tpu_torch.ops import bow
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import lie, matching, ransac
from orbslam3_tpu_torch.optim import pose_graph as pg
from orbslam3_tpu_torch.optim import sim3 as sim3_mod
from orbslam3_tpu_torch.pipeline import gba as gba_mod
from orbslam3_tpu_torch.pipeline import map_merging
from orbslam3_tpu_torch.pipeline.local_mapping import fuse_into_kf
from orbslam3_tpu_torch.pipeline.tracking import TrackState


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def gate_inertial_sim3(Rw: np.ndarray, s12: float, imu_metric: bool):
    """The inertial merge gates (`LoopClosing.cc:107, 120-127`): a
    gravity-aligned (metric) map refuses a Sim3 whose scale leaves 0.9-1.1,
    and keeps only the yaw of its rotation (the x and y of the so3 log set
    to 0: both maps share the gravity-aligned world z). Returns (ok,
    Rw_gated)."""
    if not imu_metric:
        return True, Rw
    if not (0.9 < float(s12) < 1.1):
        return False, Rw
    phi = lie.log_so3(torch.from_numpy(np.asarray(Rw, np.float32))).clone()
    phi[0] = 0.0
    phi[1] = 0.0
    return True, lie.exp_so3(phi).numpy()


class MultiMapManager:
    def __init__(self, system, vocabulary, min_kfs_to_store: int = 10,
                 min_merge_matches: int = 15, min_sim3_inliers: int = 12,
                 post_merge_gba: bool = True):
        self.system = system
        self.voc = bow.to_device(vocabulary, system.device)
        s = system.store.state
        self.atlas = Atlas(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device=system.device,
                           maps=[system.store])  # the system's store is map 0
        self.kfdbs: Dict[st.MapStore, KeyFrameDB] = {}
        self.min_kfs_to_store = min_kfs_to_store
        self.min_merge_matches = min_merge_matches
        self.min_sim3_inliers = min_sim3_inliers
        self.post_merge_gba = post_merge_gba
        self.n_merges = 0
        self.n_queries = 0  # stored maps queried by `_try_merge`
        self.n_sharded_queries = 0  # of them, over a distributed group
        self.lost_streak = 0
        self.last_verify: dict = {}  # the last verification: counts, matches, Sim3
        self.last_weld: dict = {}  # the last weld: its BA ("inertial" or "visual"), window, dof4

    def _kfdb(self, store: st.MapStore) -> KeyFrameDB:
        if store not in self.kfdbs:
            self.kfdbs[store] = KeyFrameDB(self.voc, Kmax=store.state.Kmax)
        return self.kfdbs[store]

    # ------------------------------------------------------------------
    def on_new_keyframe(self, kf_id: int):
        """Index the keyframe in the active map's database, then try to merge
        the active map into a stored one."""
        with spans.span("atlas"):
            act = self.system.store
            s = act.state
            self._kfdb(act).add(kf_id, s.kf_desc[kf_id], s.kf_feat_valid[kf_id])
            if self.atlas.n_maps > 1 and act.n_kf >= 5:
                with spans.span("try merge"):
                    self._try_merge(kf_id)

    def on_frame_done(self):
        """The hard-LOST policy (`Tracking.cc:1239-1257`): after five LOST
        frames in a row a map of more than `min_kfs_to_store` keyframes is
        stored and a fresh one starts; a smaller one is reset (the streak
        gives relocalization its last tries first)."""
        with spans.span("atlas"):
            tr = self.system.tracker
            if tr.state == TrackState.LOST and not tr.only_tracking:
                self.lost_streak += 1
            else:
                self.lost_streak = 0
            if self.lost_streak >= 5:
                if self.system.store.n_kf > self.min_kfs_to_store:
                    self._create_map()
                else:
                    self.system.reset_active_map()
                self.lost_streak = 0

    # ------------------------------------------------------------------
    def _create_map(self):
        """`Tracking::CreateMapInAtlas`: keep the active map in the Atlas,
        start a fresh one and attach every subsystem to it (a fresh keyframe
        database and IMU initialization too); the tracker starts over."""
        new_store = self.atlas.create_new_map()
        self.system._attach_store(new_store)
        tr = self.system.tracker
        tr.state = TrackState.NOT_INITIALIZED
        tr.init_frame = None
        tr.ref_kf = -1
        tr.last_kf_id = -1
        tr.velocity = None
        tr.pre_from_kf = None
        tr.imu_ready = False
        tr.frame_prior = None
        tr._ref_pose = None

    def _try_merge(self, kf_id: int):
        """Query every stored map's database with the new keyframe; merge
        the active map into the first one whose candidate verifies."""
        act = self.system.store
        s = act.state
        desc, fvalid = s.kf_desc[kf_id], s.kf_feat_valid[kf_id]
        dist = self.system.dist
        for target in list(self.atlas.maps):
            if target is act or target.n_kf < 3 or target not in self.kfdbs:
                continue
            self.n_queries += 1
            if dist is not None and dist.n_shards > 1:
                # Config 5: the stored map's BoW matrix scored shard-wise.
                cand_ids, _ = self.kfdbs[target].query_frame_sharded(desc, fvalid, dist, n_best=3)
                self.n_sharded_queries += 1
            else:
                covis = target.tensor(target.covisibility_np())
                cand_ids, _ = self.kfdbs[target].query_frame(desc, fvalid, covis, n_best=3)
            for c in _np(cand_ids):
                if c >= 0 and self._verify_merge(act, target, kf_id, int(c)):
                    return

    def _verify_merge(self, act: st.MapStore, target: st.MapStore, kf_id: int,
                      cand: int) -> bool:
        verdict = self._merge_sim3(act, target, kf_id, cand)
        if verdict is None:
            return False
        self._do_merge(act, target, *verdict)
        self.n_merges += 1
        return True

    def _merge_sim3(self, act: st.MapStore, target: st.MapStore, kf_id: int, cand: int):
        """The world Sim3 (R, t, s) taking the active map's coordinates into
        the target's, from keyframe `kf_id` of `act` and `cand` of `target`,
        or None where a gate fails (`DetectCommonRegionsFromBoW`,
        `LoopClosing.cc:746-765`). `last_verify` keeps the counts, the
        matches and the Sim3s."""
        from orbslam3_tpu_torch.system import Sensor

        sysm = self.system
        model, params = sysm.tracker.model, sysm.tracker.params
        s1, s2 = act.state, target.state
        T = act.tensor
        mp1 = _np(s1.kf_mp[kf_id])
        mp2 = _np(s2.kf_mp[cand])
        has1 = T(mp1 >= 0) & s1.kf_feat_valid[kf_id]
        has2 = T(mp2 >= 0) & s2.kf_feat_valid[cand]
        m = matching.match_nn(s1.kf_desc[kf_id], s2.kf_desc[cand], has1, has2,
                              max_dist=matching.TH_LOW, ratio=0.75, cross_check=True)
        idx2, valid = _np(m.idx), _np(m.valid)
        inertial = sysm.sensor in (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
        imu_metric = inertial and sysm.tracker.imu_ready
        out = self.last_verify = dict(kf=kf_id, cand=cand, matches=int(valid.sum()),
                                      idx=idx2, valid=valid, imu_metric=imu_metric)
        if out["matches"] < self.min_merge_matches:
            return None
        i2 = np.clip(idx2, 0, None)
        p1w = _np(s1.mp_pos)[np.clip(mp1, 0, None)]
        p2w = _np(s2.mp_pos)[np.clip(mp2[i2], 0, None)]
        R1, t1 = _np(s1.kf_R[kf_id]), _np(s1.kf_t[kf_id])
        R2, t2 = _np(s2.kf_R[cand]), _np(s2.kf_t[cand])
        X1 = (R1 @ p1w.T).T + t1
        X2 = (R2 @ p2w.T).T + t2
        s2t = _np(sysm.tracker.sigma2_table)
        o1 = np.clip(_np(s1.kf_octave[kf_id]), 0, len(s2t) - 1)
        o2 = np.clip(_np(s2.kf_octave[cand])[i2], 0, len(s2t) - 1)
        uv1 = _np(s1.kf_uv[kf_id])
        uv2 = _np(s2.kf_uv[cand])[i2]

        def f32(x):
            return T(np.asarray(x, np.float32))

        def proj(X):
            return cam.project(model, params, X)

        # Stereo and RGB-D maps are metric: the Sim3 keeps s = 1 (`mbFixScale`,
        # `LoopClosing.h:125`); a monocular-inertial one solves the scale and
        # gates it (`LoopClosing.cc:107`).
        fix_scale = sysm.sensor in (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO)
        gen = torch.Generator(device=act.device).manual_seed(int(kf_id) + 7777)
        ok, R12, t12, s12, _ = ransac.sim3_ransac(
            f32(X1), f32(X2), T(valid), f32(9.21 * s2t[o1]), f32(9.21 * s2t[o2]), proj, proj,
            f32(uv1), f32(uv2), fix_scale=fix_scale, generator=gen,
            min_inliers=self.min_sim3_inliers)
        out["ransac_ok"] = bool(ok)
        if not out["ransac_ok"]:
            return None
        # The Gauss-Newton Sim3 refinement (`Optimizer::OptimizeSim3`) and its
        # chi2 re-gate before a merge is committed.
        ref = sim3_mod.optimize_sim3(model, params, R12, t12, s12, f32(X1), f32(X2), f32(uv1),
                                     f32(uv2), f32(s2t[o1]), f32(s2t[o2]), T(valid),
                                     fix_scale=fix_scale)
        out["sim3_inliers"] = int(ref.n_inliers)
        if out["sim3_inliers"] < self.min_sim3_inliers:
            return None
        R12n, t12n, s12n = _np(ref.R), _np(ref.t), float(ref.s)
        out["sim3"] = (R12n, t12n, s12n)
        # x_t = T2w^-1 S21 T1w x_a = R2^T (s R12 (R1 x_a + t1) + t12 - t2)
        Rw = R2.T @ R12n @ R1
        tw = R2.T @ (s12n * (R12n @ t1) + t12n - t2)
        ok_gate, Rw = gate_inertial_sim3(Rw, s12n, imu_metric)
        out["gate_ok"] = ok_gate
        if not ok_gate:
            return None
        out["world"] = (Rw, tw, s12n)
        return Rw, tw, s12n

    # ------------------------------------------------------------------
    def _do_merge(self, act: st.MapStore, target: st.MapStore, R, t, s):
        """`MergeLocal`: move `act` into `target` by the world Sim3 and weld
        the seam."""
        sysm = self.system
        if sysm.async_mapper is not None:
            # `MergeLocal` stops local mapping before the weld
            # (`LoopClosing.cc:1348`): the queued passes run first.
            sysm.async_mapper.flush()
        with spans.span("merge: merge maps"):
            pre_merge_points = _np(target.state.mp_valid).copy()
            kf_remap, _ = map_merging.merge_maps(target, act, R, t, s)
            db = self._kfdb(target)
            ts = target.state
            for k_tgt in kf_remap.values():
                db.add(k_tgt, ts.kf_desc[k_tgt], ts.kf_feat_valid[k_tgt])
        sysm._point_at(target)
        sysm.mapper.preints = {kf_remap[k]: v for k, v in sysm.mapper.preints.items()
                               if k in kf_remap}
        tr = sysm.tracker
        tr.ref_kf = kf_remap.get(tr.ref_kf, max(kf_remap.values()))
        tr.last_kf_id = kf_remap.get(tr.last_kf_id, tr.ref_kf)
        tr.velocity = None  # the world frame changed
        tr._ref_pose = None
        # The body velocity is a vector of the old world: the Sim3 turns and
        # scales it (fault C20; ORB-SLAM3's `UpdateFrameIMU` after `MergeLocal2`).
        # A keyframe frame then takes its keyframe's; a merge that completes in a
        # later frame's tick (asynchronous mapping) keeps this one.
        tr.body_vel = (float(s) * (np.asarray(R, np.float32) @ tr.body_vel)).astype(np.float32)
        # The source map's trajectory entries move to their migrated reference
        # keyframes; a relative translation of the old map scales by s.
        tr.trajectory = [
            (tss, target, kf_remap[ref], R_cr, float(s) * t_cr)
            if store_e is act and ref in kf_remap else (tss, store_e, ref, R_cr, t_cr)
            for (tss, store_e, ref, R_cr, t_cr) in tr.trajectory
        ]
        if tr.last_frame is not None:
            # The last frame's pose into the target's frame; the current
            # frame's entry, recorded before the merge, is derived again
            # from it against its migrated reference (one stale entry spoils
            # the whole trajectory's Sim3 alignment).
            Rn = np.asarray(tr.last_frame.R) @ np.asarray(R).T
            tn = float(s) * np.asarray(tr.last_frame.t) - Rn @ np.asarray(t)
            tr.last_frame.R = Rn.astype(np.float32)
            tr.last_frame.t = tn.astype(np.float32)
            if tr.trajectory:
                ts_l, store_l, ref_l, _, _ = tr.trajectory[-1]
                if (store_l is target and ref_l >= 0
                        and abs(ts_l - tr.last_frame.timestamp) < 1e-9):
                    R_r, t_r = _np(ts.kf_R[ref_l]), _np(ts.kf_t[ref_l])
                    R_cr = tr.last_frame.R @ R_r.T
                    tr.trajectory[-1] = (ts_l, target, ref_l, R_cr,
                                         tr.last_frame.t - R_cr @ t_r)
        with spans.span("merge: weld fuse"):
            self._weld_fuse(target, list(kf_remap.values()), pre_merge_points)
        target.bump()
        self._weld_and_distribute(target, tr.ref_kf)

        # The source map's content now lives in the target.
        self.atlas.maps.remove(act)
        self.kfdbs.pop(act, None)
        self.atlas.active_idx = self.atlas.maps.index(target)
        lc = sysm.loop_closer
        if lc is not None:  # its loop edges follow the keyframes
            lc.kfdb = self._kfdb(target)
            tr.kfdb = lc.kfdb
            lc._pending = None
            lc.loop_edges = [(kf_remap.get(a, a), kf_remap.get(b, b), ts_a, ts_b, Rm, tm, sm)
                             for (a, b, ts_a, ts_b, Rm, tm, sm) in lc.loop_edges]
        # The post-merge global BA (`LoopClosing.cc:1967`): in the background
        # with place recognition, else at once.
        if self.post_merge_gba:
            with spans.span("merge: GBA start"):
                if lc is not None and lc.gba_async is not None:
                    lc.gba_async.abort()
                    lc.gba_async.start(target)
                else:
                    gba_mod.global_ba(target, tr.model, tr.params, tr.sigma2_table, bf=tr.bf,
                                      iters=10, dist=sysm.dist)

    def _weld_fuse(self, target: st.MapStore, kf_ids, pre_merge_points: np.ndarray):
        """The weld's SearchAndFuse (`LoopClosing.cc:1756-1802`): the target's
        points from before the merge projected into each migrated keyframe
        (`fuse_into_kf`, one B1 launch per Nf chunk), so the two halves share
        observations."""
        tr = self.system.tracker
        cand = np.flatnonzero(pre_merge_points).astype(np.int32)
        if len(cand) == 0:
            return
        Nf = target.state.Nf
        pad_len = Nf * ((len(cand) + Nf - 1) // Nf)
        cand_p = np.zeros(pad_len, np.int32)
        cand_p[: len(cand)] = cand
        cand_v = np.zeros(pad_len, bool)
        cand_v[: len(cand)] = True
        T = target.tensor
        cand_t, cand_vt = T(cand_p), T(cand_v)
        for k_tgt in kf_ids:
            kj = T(np.asarray(k_tgt, np.int64))
            for c0 in range(0, pad_len, Nf):
                row, _, _, _ = fuse_into_kf(tr.model, tr.params, target.state, kj,
                                            cand_t[c0:c0 + Nf], cand_vt[c0:c0 + Nf], tr.img_wh_t,
                                            tr.sigma2_table, n_levels=tr.orb.n_levels)
                kf_mp = target.state.kf_mp.clone()
                kf_mp[k_tgt] = row
                target.state = target.state._replace(kf_mp=kf_mp)

    def _weld_and_distribute(self, target: st.MapStore, weld_center: int):
        """The seam's refinement:

        1. the weld BA around the merging keyframe (`LoopClosing.cc:1802`):
           the local BA of its covisibility window, or once the IMU is
           initialized the local inertial BA over a 16-keyframe temporal
           window (`MergeInertialBA`, `LoopClosing.cc:2301`);
        2. the essential graph over the whole merged map with the welded
           window fixed (`LoopClosing.cc:1910`): the temporal chain and the
           covisibility >= 30 edges, measured by the relative poses from
           before the weld, so every keyframe outside the window follows
           the window's correction (4-DoF once the IMU is initialized); the
           points ride their first keyframe's correction.

        The edge lists are built on the host; the solves run on the device."""
        mapper = self.system.mapper
        old_store = mapper.store
        mapper.store = target
        mapper._covis_pin = None
        s0 = target.state
        R_pre, t_pre = _np(s0.kf_R), _np(s0.kf_t)  # the graph's measurements
        inertial = mapper.imu_initialized
        weld = self.last_weld = dict(ba="inertial" if inertial else "visual",
                                     window=16 if inertial else None, dof4=None)
        with spans.span("merge: weld BA"):
            try:
                if inertial:
                    mapper._local_inertial_ba(weld_center, window=16)
                else:
                    mapper._local_ba(weld_center)
            finally:
                mapper.store = old_store
                mapper._covis_pin = None

        with spans.span("merge: essential graph"):
            s = target.state
            nkf = target.n_kf
            K = s.Kmax
            kf_valid = _np(s.kf_valid)
            covis = target.covisibility_np()
            # The welded window: the centre and its best covisibles, the
            # keyframes the weld BA moved; they anchor the graph.
            order = np.argsort(-covis[weld_center][:nkf])
            window = {weld_center}
            for c in order:
                if len(window) >= 16:
                    break
                if covis[weld_center][c] > 0 and kf_valid[c]:
                    window.add(int(c))
            fixed = np.zeros(K, bool)
            fixed[list(window)] = True
            fixed[nkf:] = True
            fixed |= ~kf_valid
            if fixed.all():
                return
            ei, ej = [], []
            for k in range(1, nkf):
                if kf_valid[k] and kf_valid[k - 1]:
                    ei.append(k - 1)
                    ej.append(k)
            ii, jj = np.nonzero(np.triu(covis[:nkf, :nkf] >= 30, 2))
            for a, b in zip(ii, jj):
                if kf_valid[a] and kf_valid[b]:
                    ei.append(int(a))
                    ej.append(int(b))
            if not ei:
                return
            E = len(ei)
            ei = np.asarray(ei, np.int32)
            ej = np.asarray(ej, np.int32)
            eR = np.einsum("eij,ekj->eik", R_pre[ej], R_pre[ei]).astype(np.float32)
            et = (t_pre[ej] - np.einsum("eij,ej->ei", eR, t_pre[ei])).astype(np.float32)
            T = target.tensor
            dev = target.device
            graph = pg.PoseGraph(
                R=s.kf_R, t=s.kf_t, s=torch.ones(K, device=dev), fixed=T(fixed),
                edge_i=T(ei), edge_j=T(ej), edge_R=T(eR), edge_t=T(et),
                edge_s=torch.ones(E, device=dev), edge_valid=torch.ones(E, dtype=torch.bool,
                                                                        device=dev),
                edge_weight=torch.ones(E, device=dev))
            weld["dof4"] = mapper.imu_initialized
            R_new, t_new, s_new = pg.solve_pose_graph(graph, iters=10, dof4=weld["dof4"])
            ref = torch.clamp(s.mp_first_kf, 0, K - 1).to(torch.int64)
            newp = pg.correct_points(s.mp_pos, s.kf_R[ref], s.kf_t[ref],
                                     torch.ones(s.Pmax, device=dev), R_new[ref], t_new[ref],
                                     s_new[ref])
            newp = torch.where(s.mp_valid[:, None], newp, s.mp_pos)
            target.state = s._replace(kf_R=R_new, kf_t=t_new / s_new[:, None], mp_pos=newp)
            target.bump()
