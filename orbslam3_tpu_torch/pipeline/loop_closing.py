"""Loop closing on torch tensors — the port of
`orbslam3_tpu/pipeline/loop_closing.py` (`LoopClosing.cc`, the same-map
loop, visual or inertial; with `dist`, a `DistributedContext`, the
synchronous global BA runs over its group). An
inertial closer (`inertial=True`, the IMU_MONOCULAR `System`'s) fixes the
scale of every Sim3 step and corrects with the 4-DoF essential graph:

* candidates: the keyframe database (`atlas/kfdb.py`);
* verification (`_verify_sim3`): a cross-checked descriptor match of the
  two keyframes (kernel B1 twice), Sim3 RANSAC on the matched points
  (`ops/ransac.py::sim3_ransac`, its samples from a `torch.Generator` seeded
  with the keyframe id, as the reference's `PRNGKey(kf_id)`), the Sim3
  refinement (`optim/sim3.py`), then the second round: the candidate's
  covisibility window projected through the Sim3 into the keyframe (B1 with
  one radius and no octave band), the refinement again on the augmented
  pairs, and the tight projection gate;
* temporal consistency (`_confirm`): the same region on `consecutive`
  keyframes in a row;
* correction (`_correct_loop`): the 7-DoF essential graph, or the inertial
  closer's 4-DoF one (`optim/pose_graph.py`), over the temporal chain, the
  covisibility >= 30 edges and every loop edge so far, the points
  re-expressed through their first keyframe (and, inertial, each keyframe's
  velocity turned with its rotation), then `_search_and_fuse`
  (`fuse_into_kf`, B1 over chunks of 4096 loop-side points into each
  current-side keyframe) and the global BA, in the background
  (`pipeline/gba.py::AsyncGBA`) or at once.

Like the reference, the host reads the device at every step of a keyframe
that reaches verification (match counts, RANSAC outcome, the point cloud,
conflicts); each read is a host sync on the card. They happen on keyframe
frames only, and `entry.mono_replay` counts them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from orbslam3_tpu_torch import spans
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import matching, ransac
from orbslam3_tpu_torch.optim import pose_graph as pg
from orbslam3_tpu_torch.optim import sim3 as sim3_mod


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class LoopCloser:
    def __init__(self, model: cam.CameraModel, params: torch.Tensor, store: st.MapStore,
                 kfdb: KeyFrameDB, sigma2_table: torch.Tensor, min_bow_matches: int = 20,
                 min_sim3_inliers: int = 20, min_kfs: int = 12, run_gba: bool = True,
                 consecutive: int = 3, inertial: bool = False, img_wh=None, scale_table=None,
                 mapper=None, bf: float = 0.0):
        self.model = model
        self.params = params
        self.device = params.device
        self.store = store
        self.kfdb = kfdb
        self.sigma2_table = sigma2_table
        self.bf = bf
        self.min_bow_matches = min_bow_matches
        self.min_sim3_inliers = min_sim3_inliers
        self.min_kfs = min_kfs
        self.run_gba = run_gba
        self.consecutive = consecutive
        self.inertial = inertial
        self.img_wh = img_wh  # (2,) float32 tensor on the device, or None
        self.scale_table = scale_table
        self.mapper = mapper  # its purge_freed runs after SearchAndFuse
        self.last_loop_kf = -10_000
        # Every accepted closure's measured Sim3 constrains every later
        # essential-graph solve (`KeyFrame::AddLoopEdge`).
        self.loop_edges = []  # (kf_i, kf_j, ts_i, ts_j, R21, t21, s21)
        self.n_loops_closed = 0
        self.gba_async = None  # AsyncGBA, or None: the global BA runs at once
        self.dist = None  # DistributedContext (System.enable_distributed)
        # Called as on_correction(phase, kf_id, loop_kf), phase "before" or
        # "after" the essential-graph correction (replays report ATE deltas).
        self.on_correction = None
        self._pending: Optional[tuple] = None  # (loop_kf, count, last confirming kf)
        self.last_verify: dict = {}  # the counts of the last verification, gate by gate

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int) -> bool:
        """Returns True if a loop was closed at this keyframe."""
        with spans.span("loop closing"):
            s = self.store.state
            with spans.span("place/add"):
                self.kfdb.add(kf_id, s.kf_desc[kf_id], s.kf_feat_valid[kf_id])
            if self.store.n_kf < self.min_kfs:  # `LoopClosing.cc:331`
                return False
            if kf_id - self.last_loop_kf < 10:  # cool-down after a closure
                return False
            with spans.span("place/query"):  # the JAX package's `loop/covis+query`
                covis_np = self.store.covisibility_np()
                cand_ids, _ = self.kfdb.query(kf_id, self.store.tensor(covis_np))
                cands = _np(cand_ids)
            for c in cands:
                if c < 0 or c == kf_id or abs(int(c) - kf_id) < 10:  # too close in time
                    continue
                with spans.span("loop: verify Sim3"):
                    verdict = self._verify_sim3(kf_id, int(c))
                if verdict is None:
                    continue
                R21, t21, s21 = verdict
                if self._confirm(kf_id, int(c), covis_np):
                    self._correct_loop(kf_id, int(c), R21, t21, s21)
                    self._pending = None
                    self.last_loop_kf = kf_id
                    self.n_loops_closed += 1
                    return True
                return False  # armed or extended the pending region
            # A pending region that missed a beat is dropped (`LoopClosing.cc:456-470`).
            if self._pending is not None and kf_id - self._pending[2] >= 2:
                self._pending = None
            return False

    def _confirm(self, kf_id: int, cand: int, covis_np) -> bool:
        """Temporal consistency (`LoopClosing.cc:367`): the verified pair
        must hit the pending region (within 15 keyframes, or covisible by 15
        points) on `consecutive` keyframes in a row."""
        if self.consecutive <= 1:
            return True
        if self._pending is not None:
            loop_kf, count, last_kf = self._pending
            same_region = abs(cand - loop_kf) <= 15 or covis_np[cand, loop_kf] >= 15
            if same_region and kf_id > last_kf:
                count += 1
                self._pending = (cand, count, kf_id)
                return count >= self.consecutive
        self._pending = (cand, 1, kf_id)
        return 1 >= self.consecutive

    # ------------------------------------------------------------------
    def _verify_sim3(self, kf_id: int, cand: int):
        """(R21, t21, s21) numpy, mapping keyframe `kf_id`'s camera frame into
        `cand`'s (X2 = s R X1 + t), or None where a gate fails."""
        return self._verify_sim3_impl(kf_id, cand)

    def _verify_sim3_impl(self, kf_id: int, cand: int):
        s = self.store.state
        T = self.store.tensor
        def f32(x):
            return T(np.asarray(x, np.float32))

        def proj(X):
            return cam.project(self.model, self.params, X)

        with spans.span("loop/verify/match"):
            mp1 = _np(s.kf_mp[kf_id])
            mp2 = _np(s.kf_mp[cand])
            # 1) descriptor matches between the two keyframes' point-bearing features
            has1 = T(mp1 >= 0) & s.kf_feat_valid[kf_id]
            has2 = T(mp2 >= 0) & s.kf_feat_valid[cand]
            m = matching.match_nn(s.kf_desc[kf_id], s.kf_desc[cand], has1, has2,
                                  max_dist=matching.TH_LOW, ratio=0.75, cross_check=True)
            idx2 = _np(m.idx)
            valid = _np(m.valid)
            stats = self.last_verify = dict(matches=int(valid.sum()))
        if stats["matches"] < self.min_bow_matches:
            return None

        # 2) Sim3 RANSAC on the matched points in each keyframe's camera frame
        with spans.span("loop/verify/ransac"):
            mp_pos = _np(s.mp_pos)
            i2 = np.clip(idx2, 0, None)
            pts1_w = mp_pos[np.clip(mp1, 0, None)]
            pts2_w = mp_pos[np.clip(mp2[i2], 0, None)]
            R1, t1 = _np(s.kf_R[kf_id]), _np(s.kf_t[kf_id])
            R2, t2 = _np(s.kf_R[cand]), _np(s.kf_t[cand])
            X1 = (R1 @ pts1_w.T).T + t1
            X2 = (R2 @ pts2_w.T).T + t2
            s2t = _np(self.sigma2_table)
            oct1 = _np(s.kf_octave[kf_id])
            oct2_all = _np(s.kf_octave[cand])
            oct2 = oct2_all[i2]
            s2_1 = s2t[np.clip(oct1, 0, len(s2t) - 1)]
            s2_2 = s2t[np.clip(oct2, 0, len(s2t) - 1)]
            uv1_all = _np(s.kf_uv[kf_id])
            uv2_all = _np(s.kf_uv[cand])
            uv2 = uv2_all[i2]

            gen = torch.Generator(device=self.device).manual_seed(int(kf_id))
            ok, R12, t12, s12, _ = ransac.sim3_ransac(
                f32(X1), f32(X2), T(valid), f32(9.21 * s2_1), f32(9.21 * s2_2), proj, proj,
                f32(uv1_all), f32(uv2), fix_scale=self.inertial, generator=gen,
                min_inliers=self.min_sim3_inliers)
            ok = bool(ok)
        if not ok:
            return None

        # 3) Gauss-Newton refinement on the matched pairs (`OptimizeSim3`)
        with spans.span("loop/verify/refine"):
            ref = sim3_mod.optimize_sim3(self.model, self.params, R12, t12, s12, f32(X1),
                                         f32(X2), f32(uv1_all), f32(uv2), f32(s2_1), f32(s2_2),
                                         T(valid), fix_scale=self.inertial)
            stats["sim3_inliers"] = int(ref.n_inliers)
        if stats["sim3_inliers"] < self.min_sim3_inliers:
            return None

        with spans.span("loop/verify/project"):
            # 4) second round (`LoopClosing.cc:763-840`): the candidate window's
            # points projected through the Sim3, the refinement on the augmented
            # pairs, the tight gate with the refined transform.
            n_feat = s.kf_desc.shape[1]
            min_proj = max(self.min_sim3_inliers, int(round(50 * n_feat / 1000.0)))
            min_proj_opt = int(round(80 * n_feat / 1000.0))
            cloud = self._cov_window_points(cand, exclude=kf_id)
            mm, _, _ = self._sim3_projection_matches(kf_id, cloud, R2, t2, _np(ref.R),
                                                     _np(ref.t), float(ref.s), radius=8.0,
                                                     max_dist=matching.TH_HIGH)
            midx = _np(mm.idx)
            mval = _np(mm.valid)
            stats["proj_matches"] = int(mval.sum())
            if stats["proj_matches"] < min_proj:  # nProjMatches (`:806`)
                return None

            # Pairs indexed by keyframe-1 feature: the forward residual (cloud
            # point -> keyframe-1 pixel) always, the backward one only where the
            # candidate observes the point (`OptimizeSim3` bAllPoints semantics).
            Nf = n_feat
            a_X2 = np.zeros((Nf, 3), np.float32)
            a_uv2 = np.zeros((Nf, 2), np.float32)
            a_s2_2 = np.zeros(Nf, np.float32)
            a_valid = np.zeros(Nf, bool)
            feat_of = np.clip(midx, 0, Nf - 1)
            X2_cloud = (R2 @ mp_pos[np.clip(cloud, 0, None)].T).T + t2
            a_X2[feat_of[mval]] = X2_cloud[mval]
            a_valid[feat_of[mval]] = True
            slot_of_point = np.full(mp_pos.shape[0], -1, np.int64)
            slot_of_point[mp2[mp2 >= 0]] = np.flatnonzero(mp2 >= 0)
            cl_slot = slot_of_point[np.clip(cloud, 0, None)]
            has_bk = mval & (cl_slot >= 0)
            a_uv2[feat_of[has_bk]] = uv2_all[cl_slot[has_bk]]
            a_s2_2[feat_of[has_bk]] = s2t[np.clip(oct2_all[cl_slot[has_bk]], 0, len(s2t) - 1)]
            own1 = mp1 >= 0
            X1_own = np.zeros((Nf, 3), np.float32)
            X1_own[own1] = (R1 @ mp_pos[mp1[own1]].T).T + t1
            a_s2_2 = np.where(own1, a_s2_2, 0.0).astype(np.float32)
            a_s2_1 = s2_1.astype(np.float32)

            ref2 = sim3_mod.optimize_sim3(self.model, self.params, ref.R, ref.t, ref.s,
                                          f32(X1_own), f32(a_X2), f32(uv1_all), f32(a_uv2),
                                          f32(a_s2_1), f32(a_s2_2), T(a_valid),
                                          fix_scale=self.inertial)
            stats["sim3_inliers_2"] = int(ref2.n_inliers)
            if stats["sim3_inliers_2"] < self.min_sim3_inliers:
                return None
            R_r, t_r, s_r = _np(ref2.R), _np(ref2.t), float(ref2.s)
            mm2, _, _ = self._sim3_projection_matches(kf_id, cloud, R2, t2, R_r, t_r, s_r,
                                                      radius=5.0, max_dist=matching.TH_HIGH)
            stats["tight_matches"] = int(_np(mm2.valid).sum())
            if stats["tight_matches"] < min_proj_opt:  # nProjOptMatches (`:826-832`)
                return None
            return R_r, t_r, s_r

    def _cov_window_points(self, cand: int, n_cov: int = 5, cap: int = 4096,
                           exclude: int = -1) -> np.ndarray:
        """Unique valid map-point ids seen by `cand` and its `n_cov` best
        covisible keyframes (`LoopClosing.cc:765-789`), never `exclude`'s
        (the current keyframe: its own points would certify themselves)."""
        s = self.store.state
        covis = self.store.covisibility_np()
        nkf = self.store.n_kf
        row = covis[cand, :nkf].copy()
        row[cand] = 0
        if 0 <= exclude < nkf:
            row[exclude] = 0
        order = np.argsort(-row)
        kfs = [cand] + [int(k) for k in order[:n_cov] if row[k] > 0 and int(k) != exclude]
        ids_t = self.store.tensor(np.asarray(kfs, np.int64))
        mp = _np(s.kf_mp[ids_t])
        fv = _np(s.kf_feat_valid[ids_t])
        ids = np.unique(mp[(mp >= 0) & fv])
        ids = ids[_np(s.mp_valid)[ids]]
        return ids[:cap]

    def _sim3_projection_matches(self, kf_id: int, point_ids: np.ndarray, R2, t2, R21, t21, s21,
                                 radius: float = 8.0, max_dist: Optional[float] = None):
        """Points projected through a Sim3 into keyframe `kf_id`
        (`ORBmatcher::SearchByProjection`, Sim3 overload, `ORBmatcher.cc:
        1455`): world -> the candidate's camera (R2, t2) -> S21^-1 -> pixels,
        matched inside `radius` with no octave band and no ratio test
        (kernel B1). Returns (matches by point, keyframe-1 coordinates,
        in-front and in-image mask)."""
        if max_dist is None:
            max_dist = matching.TH_HIGH
        s = self.store.state
        T = self.store.tensor
        pid = np.asarray(point_ids)
        pts_w = _np(s.mp_pos)[pid]
        ok = _np(s.mp_valid)[pid]
        X2 = (R2 @ pts_w.T).T + t2
        X1 = (1.0 / s21) * ((X2 - t21) @ R21)  # S21^-1
        ok = ok & (X1[:, 2] > 0.05)
        uv = _np(cam.project(self.model, self.params, T(X1.astype(np.float32))))
        if self.img_wh is not None:
            wh = _np(self.img_wh)
            ok = ok & (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < wh[0]) & (uv[:, 1] < wh[1])
        m = matching.search_by_projection(
            s.mp_desc[T(pid.astype(np.int64))], T(uv), T(ok), s.kf_desc[kf_id], s.kf_uv[kf_id],
            s.kf_feat_valid[kf_id], radius=T(np.float32(radius)), max_dist=max_dist, ratio=1.0)
        return matching.assign_unique(m, int(s.kf_desc.shape[1])), X1, ok

    # ------------------------------------------------------------------
    def _correct_loop(self, kf_id: int, loop_kf: int, R21, t21, s21):
        """`CorrectLoop` (`LoopClosing.cc:1093`): the essential graph (7-DoF,
        or 4-DoF when inertial), the points through their first keyframe,
        SearchAndFuse, then the global BA. Inertial, each keyframe's
        velocity, a world vector, turns with its orientation correction,
        v' = R_new^T R_old v (`CorrectLoop`'s "correct velocity according to
        orientation correction", in its loop over the corrected keyframes,
        `LoopClosing.cc:1175-1204`; fault C20)."""
        store = self.store
        s = store.state
        nkf = store.n_kf
        K = s.Kmax
        T = store.tensor
        if self.on_correction is not None:
            self.on_correction("before", kf_id, loop_kf)

        kf_valid = _np(s.kf_valid)
        fixed = np.zeros(K, bool)
        fixed[loop_kf] = True
        fixed[nkf:] = True  # unused slots
        fixed |= ~kf_valid

        # Edges: the temporal chain, covisibility >= 30, every live loop edge
        # and the new one (weight 5), measured M_ji = S_j S_i^-1.
        covis = store.covisibility_np()
        ei, ej, ew = [], [], []
        for k in range(1, nkf):
            if kf_valid[k] and kf_valid[k - 1]:
                ei.append(k - 1); ej.append(k); ew.append(1.0)  # noqa: E702
        ii, jj = np.nonzero(np.triu(covis[:nkf, :nkf] >= 30, 2))
        for a, b in zip(ii, jj):
            if kf_valid[a] and kf_valid[b]:
                ei.append(a); ej.append(b); ew.append(1.0)  # noqa: E702
        n_chain = len(ei)
        live_loops = [
            (a, b, Rm, tm, sm) for (a, b, ts_a, ts_b, Rm, tm, sm) in self.loop_edges
            if a < nkf and b < nkf and kf_valid[a] and kf_valid[b]
            # slots are recycled: the timestamps must still name the same keyframes
            and store.kf_ts[a] == ts_a and store.kf_ts[b] == ts_b
        ]
        for (a, b, _, _, _) in live_loops:
            ei.append(a); ej.append(b); ew.append(5.0)  # noqa: E702
        ei.append(kf_id); ej.append(loop_kf); ew.append(5.0)  # noqa: E702

        E = len(ei)
        ei = np.asarray(ei, np.int32)
        ej = np.asarray(ej, np.int32)
        eR = np.zeros((E, 3, 3), np.float32)
        et = np.zeros((E, 3), np.float32)
        es = np.ones(E, np.float32)
        Rn, tn = _np(s.kf_R), _np(s.kf_t)
        for n in range(n_chain):
            a, b = ei[n], ej[n]
            Rba = Rn[b] @ Rn[a].T  # M_ba = T_b T_a^-1 from the current estimates
            eR[n] = Rba
            et[n] = tn[b] - Rba @ tn[a]
        for k, (_, _, Rm, tm, sm) in enumerate(live_loops):
            eR[n_chain + k], et[n_chain + k], es[n_chain + k] = Rm, tm, sm
        eR[E - 1], et[E - 1], es[E - 1] = R21, t21, s21
        self.loop_edges.append((int(kf_id), int(loop_kf), float(store.kf_ts[kf_id]),
                                float(store.kf_ts[loop_kf]), np.asarray(R21, np.float32).copy(),
                                np.asarray(t21, np.float32).copy(), float(s21)))

        graph = pg.PoseGraph(
            R=s.kf_R, t=s.kf_t, s=torch.ones(K, dtype=torch.float32, device=self.device),
            fixed=T(fixed), edge_i=T(ei), edge_j=T(ej), edge_R=T(eR), edge_t=T(et), edge_s=T(es),
            edge_valid=T(np.ones(E, bool)), edge_weight=T(np.asarray(ew, np.float32)))
        with spans.span("loop: essential graph"):
            R_new, t_new, s_new = pg.solve_pose_graph(graph, iters=12, dof4=self.inertial)

        # Points through their first keyframe; scale folded into SE3 (Tcw =
        # [R | t / s], `CorrectLoop` :1158).
        with spans.span("loop: correct points"):
            ref = torch.clamp(s.mp_first_kf, 0, K - 1).to(torch.int64)
            newp = pg.correct_points(s.mp_pos, s.kf_R[ref], s.kf_t[ref],
                                     torch.ones(s.Pmax, dtype=torch.float32, device=self.device),
                                     R_new[ref], t_new[ref], s_new[ref])
            newp = torch.where(s.mp_valid[:, None], newp, s.mp_pos)
            upd = dict(kf_R=R_new, kf_t=t_new / s_new[:, None], mp_pos=newp)
            if self.inertial:
                upd["kf_vel"] = torch.einsum("kji,kjl,kl->ki", R_new, s.kf_R, s.kf_vel)
            store.state = s._replace(**upd)
            store.bump()
        if self.on_correction is not None:
            self.on_correction("after", kf_id, loop_kf)

        with spans.span("loop: search and fuse"):
            self._search_and_fuse(kf_id, loop_kf, covis)

        if self.run_gba:
            if self.gba_async is not None:
                # A new closure stops a running GBA and starts over
                # (`LoopClosing.cc:1099-1118`).
                self.gba_async.abort()
                self.gba_async.start(self.store)
            else:
                self._global_ba(kf_id)

    # ------------------------------------------------------------------
    def _search_and_fuse(self, kf_id: int, loop_kf: int, covis):
        """`SearchAndFuse` (`LoopClosing.cc:1259`): the loop window's points
        projected into each keyframe of the current window (`fuse_into_kf`,
        chunks of 4096); duplicates replaced keeping the better-observed
        point (`resolve_and_replace`)."""
        if self.img_wh is None:
            return
        from orbslam3_tpu_torch.pipeline import local_mapping as lm

        store = self.store
        nkf = store.n_kf
        cw = np.asarray(covis)

        def window(center, n):
            order = np.argsort(-cw[center][:nkf])
            return [center] + [int(x) for x in order[:n] if cw[center][x] >= 15]

        cur_win = window(kf_id, 10)
        loop_win = window(loop_kf, 10)
        pool = np.unique(store.kf_mp_np()[loop_win].reshape(-1))
        pool = pool[pool >= 0]
        if not len(pool):
            return
        conflicts_src, conflicts_dst = [], []
        CAP = 4096
        for tgt in cur_win:
            tgt_t = store.tensor(np.int64(tgt))
            for start in range(0, len(pool), CAP):
                chunk = pool[start:start + CAP]
                pad = CAP - len(chunk)
                ids = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
                valid = np.arange(CAP) < len(chunk)
                new_row, _n, inc, conf = lm.fuse_into_kf(
                    self.model, self.params, store.state, tgt_t,
                    store.tensor(ids.astype(np.int32)), store.tensor(valid), self.img_wh,
                    self.sigma2_table)
                kf_mp = store.state.kf_mp.clone()
                kf_mp[tgt] = new_row
                store.state = store.state._replace(kf_mp=kf_mp)
                conf = _np(conf)
                if conf.any():
                    conflicts_src.append(ids.astype(np.int64)[conf])
                    conflicts_dst.append(_np(inc)[conf])
        if conflicts_src:
            freed = lm.resolve_and_replace(store, conflicts_src, conflicts_dst, kf_id)
            if self.mapper is not None:
                self.mapper.purge_freed(freed)
            if self.scale_table is not None:
                row = _np(store.state.kf_mp[kf_id])
                st.refresh_points(store, row[row >= 0], self.scale_table)
        store.bump()

    def _global_ba(self, kf_id: int):
        """`RunGlobalBundleAdjustment` (`LoopClosing.cc:2513`) at once: 10
        iterations, keyframe 0 and the unused slots fixed; point-partitioned
        over `dist`'s group when one is attached (config 5)."""
        from orbslam3_tpu_torch.pipeline import gba as gba_mod

        gba_mod.global_ba(self.store, self.model, self.params, self.sigma2_table, bf=self.bf,
                          iters=10, dist=self.dist)
