"""Per-frame tracking on torch tensors — the port of the monocular, visual
path of `orbslam3_tpu/pipeline/tracking.py`: the device programs of one
tracked frame (`_track_last_frame` (motion model), `_track_reference_kf`
(fallback), `_local_point_mask`, `_track_local_map_match`,
`_pose_opt_from_assoc`, `compute_obs_count` and `_track_step`, which chains
them), the initialization matcher `_match_for_initialization`, and the host
state machine `Tracker` (two-view initialization, tracking, the keyframe
policy, keyframe insertion).

Scatters with duplicate indices (fault C6). The reference writes
``assoc.at[clip(idx, 0)].set(where(valid, q, assoc[clip(idx, 0)]))``: every
invalid row clips to index 0 and writes the old value back. The port
scatters the valid rows only (`atlas/store.py::scatter_rows`, `flag`), so
the results equal the reference's everywhere except, at most, at index 0.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import lie, matching, ransac
from orbslam3_tpu_torch.optim import pose_only
from orbslam3_tpu_torch.pipeline import frame as fr

N_LOCAL_KFS = 16  # local keyframes selected per frame (device top-k)


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


def _match_for_initialization(f_ref: feat.Features, f_cur: feat.Features) -> matching.Matches:
    """`ORBmatcher::SearchForInitialization`: 100 px window, ratio 0.9,
    cross-check and rotation consistency, on the dense masked path (as the
    reference: the window is an arbitrary (N,M) mask, not kernel B1's)."""
    mask = matching.window_mask(f_ref.uv, f_cur.uv, 100.0)
    m = matching.match_nn(f_ref.desc, f_cur.desc, f_ref.valid, f_cur.valid,
                          max_dist=matching.TH_LOW, ratio=0.9, cross_check=True,
                          extra_mask=mask)
    return matching.rotation_consistency(f_ref.angle, f_cur.angle, m)


def _track_last_frame(model, params, R_pred, t_pred, last_mp, mp_pos, mp_valid, mp_desc,
                      f_cur: feat.Features, radius_px: float, scale_factors, last_octave):
    """Motion-model match: project the last frame's map points with the
    predicted pose, octave-gated window search (kernel B1). Returns
    (assoc (Nf,) int32, n_matches int32). (The reference's unused
    `last_uv` argument is dropped.)"""
    ok = last_mp >= 0
    ids = torch.clamp(last_mp, min=0).to(torch.int64)
    valid_q = ok & mp_valid[ids]
    Xc = lie.se3_apply(R_pred, t_pred, mp_pos[ids])
    uv = cam.project(model, params, Xc)
    valid_q = valid_q & (Xc[..., 2] > 0.1)
    L = scale_factors.shape[0]
    r = radius_px * scale_factors[torch.clamp(last_octave, 0, L - 1).to(torch.int64)]
    m = matching.search_by_projection(
        mp_desc[ids], uv, valid_q, f_cur.desc, f_cur.uv, f_cur.valid,
        radius=r, octave_kp=f_cur.octave,
        octave_lo=torch.clamp(last_octave - 1, min=0), octave_hi=last_octave + 1,
        max_dist=matching.TH_HIGH, ratio=0.9,
    )
    Nf = f_cur.desc.shape[0]
    m = matching.assign_unique(m, Nf)
    base = torch.full((Nf,), -1, dtype=torch.int32, device=ids.device)
    assoc = st.scatter_rows(base, m.idx, m.valid, ids)
    return assoc, m.valid.to(torch.int32).sum().to(torch.int32)


def _track_reference_kf(kf_desc, kf_feat_valid, kf_mp, mp_valid, f_cur: feat.Features):
    """Reference-keyframe match: full cross-checked Hamming match (kernel B1
    twice) with ratio 0.7."""
    kf_ids = torch.clamp(kf_mp, min=0)
    has_mp = (kf_mp >= 0) & kf_feat_valid & mp_valid[kf_ids.to(torch.int64)]
    m = matching.match_nn(kf_desc, f_cur.desc, has_mp, f_cur.valid,
                          max_dist=matching.TH_LOW, ratio=0.7, cross_check=True)
    Nf = f_cur.desc.shape[0]
    m = matching.assign_unique(m, Nf)
    base = torch.full((Nf,), -1, dtype=torch.int32, device=kf_mp.device)
    assoc = st.scatter_rows(base, m.idx, m.valid, kf_ids)
    return assoc, m.valid.to(torch.int32).sum().to(torch.int32)


def _local_point_mask(state: st.MapState, kf_ids: torch.Tensor) -> torch.Tensor:
    """(P,) bool — valid points observed by any keyframe in kf_ids (-1 pads)."""
    mp = state.kf_mp.index_select(0, torch.clamp(kf_ids, min=0).to(torch.int64))  # (W, Nf)
    ok = (mp >= 0) & (kf_ids >= 0)[:, None]
    return st.flag(state.Pmax, mp.reshape(-1), ok.reshape(-1)) & state.mp_valid


def _track_local_map_match(model, params, R, t, state: st.MapState, local_mask,
                           f_cur: feat.Features, cur_assoc, img_wh, n_levels: int = 8):
    """Frustum-test every local point and match the not-yet-associated ones
    into the free keypoints (kernel B1, windowed). Returns (assoc, visible)."""
    uv, visible, lvl, vcos = fr.frustum_and_scale(
        model, params, R, t, state.mp_pos, state.mp_valid & local_mask, state.mp_normal,
        state.mp_min_dist, state.mp_max_dist, img_wh, n_levels=n_levels,
    )
    already = st.flag(state.Pmax, torch.clamp(cur_assoc, min=0), cur_assoc >= 0)
    query_valid = visible & ~already
    r = fr.search_radius(vcos, lvl)
    kp_free = f_cur.valid & (cur_assoc < 0)
    m = matching.search_by_projection(
        state.mp_desc, uv, query_valid, f_cur.desc, f_cur.uv, kp_free,
        radius=r, octave_kp=f_cur.octave,
        octave_lo=torch.clamp(lvl - 1, min=0), octave_hi=lvl + 1,
        max_dist=matching.TH_HIGH, ratio=0.8,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    src = torch.arange(state.Pmax, dtype=torch.int32, device=cur_assoc.device)
    return st.scatter_rows(cur_assoc, m.idx, m.valid, src), visible


def _pose_opt_from_assoc(model, params, R0, t0, assoc, f_cur: feat.Features, mp_pos,
                         mp_valid, sigma2_table, ur=None, bf: float = 0.0):
    """Pose-only solve over the features associated to valid map points."""
    a = torch.clamp(assoc, min=0).to(torch.int64)
    ok = (assoc >= 0) & f_cur.valid & mp_valid[a]
    L = sigma2_table.shape[0]
    obs = pose_only.PoseObs(
        Xw=mp_pos[a],
        uv=f_cur.uv,
        ur=ur if ur is not None else torch.full(assoc.shape, -1.0, device=assoc.device),
        sigma2=sigma2_table[torch.clamp(f_cur.octave, 0, L - 1).to(torch.int64)],
        valid=ok,
    )
    return pose_only.optimize_pose(model, params, R0, t0, obs, bf=bf)


def compute_obs_count(state: st.MapState) -> torch.Tensor:
    """(Pmax,) int32 observation count per map point over all valid
    keyframes; recompute only when the map changes, not per frame."""
    ok = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    idx = torch.clamp(state.kf_mp, min=0).reshape(-1).to(torch.int64)
    zeros = torch.zeros(state.Pmax, dtype=torch.int32, device=idx.device)
    return zeros.index_add(0, idx, ok.reshape(-1).to(torch.int32))


def _top_k_lowest_index(x: torch.Tensor, k: int):
    """(values, indices) of the k largest, ties to the lowest index (as
    `lax.top_k`; `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _track_step(model, params, state: st.MapState, f_cur: feat.Features,
                R_pred, t_pred, have_pred, last_mp, last_octave, ref_kf, R_last, t_last,
                scale_table, sigma2_table, img_wh, min_obs, ur=None, bf: float = 0.0,
                n_levels: int = 8, obs_count=None):
    """The two-stage visual tracking of one frame: motion-model match + pose
    solve, reference-KF fallback, device-side local-keyframe top-16,
    local-map match + final pose solve, found/visible bookkeeping.

    Host synchronisation: two per frame. The reference's `lax.cond` on the
    motion model's success becomes one host read of `ok_a` here, so the
    fallback (a 1024x1024 cross-checked match and a 40-iteration solve) runs
    only when the motion model failed, as in the reference. The second is
    the caller's single fetch of the returned bundle (`fetch_bundle`).

    `have_pred`, `ref_kf` and `min_obs` are 0-d device tensors; `obs_count`
    is the caller's cached `compute_obs_count(state)`.
    Returns (bundle dict of device tensors, (mp_found, mp_visible))."""
    dev = f_cur.uv.device
    Nf = f_cur.uv.shape[0]
    ur_arr = ur if ur is not None else torch.full((Nf,), -1.0, device=dev)

    # --- Stage 1a: motion model -----------------------------------------
    assoc_a, n_a = _track_last_frame(
        model, params, R_pred, t_pred, last_mp, state.mp_pos, state.mp_valid,
        state.mp_desc, f_cur, 15.0, scale_table, last_octave,
    )
    res_a = _pose_opt_from_assoc(model, params, R_pred, t_pred, assoc_a, f_cur,
                                 state.mp_pos, state.mp_valid, sigma2_table, ur=ur_arr, bf=bf)
    ok_a = have_pred & (n_a >= 20) & (res_a.n_inliers >= 10)

    # --- Stage 1b: reference keyframe fallback (host sync #1) ------------
    rk = torch.clamp(ref_kf, min=0)
    if bool(ok_a):
        assoc_b = torch.full((Nf,), -1, dtype=torch.int32, device=dev)
        n_b = torch.zeros((), dtype=torch.int32, device=dev)
        R_b, t_b = R_last, t_last
        inl_b = torch.zeros(Nf, dtype=torch.bool, device=dev)
        ok_b = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        assoc_b, n_b = _track_reference_kf(
            st.row(state.kf_desc, rk), st.row(state.kf_feat_valid, rk), st.row(state.kf_mp, rk),
            state.mp_valid, f_cur,
        )
        res_b = _pose_opt_from_assoc(model, params, R_last, t_last, assoc_b, f_cur,
                                     state.mp_pos, state.mp_valid, sigma2_table,
                                     ur=ur_arr, bf=bf)
        ok_b = (ref_kf >= 0) & (n_b >= 15) & (res_b.n_inliers >= 10)
        R_b, t_b, inl_b = res_b.R, res_b.t, res_b.inlier

    use_a = ok_a
    R1 = torch.where(use_a, res_a.R, R_b)
    t1 = torch.where(use_a, res_a.t, t_b)
    minus1 = torch.full_like(assoc_a, -1)
    assoc1 = torch.where(use_a, torch.where(res_a.inlier, assoc_a, minus1),
                         torch.where(inl_b, assoc_b, minus1))
    ok1 = ok_a | ok_b

    # --- Local keyframe selection (device top-k) ------------------------
    ptset = st.flag(state.Pmax, torch.clamp(assoc1, min=0), assoc1 >= 0)
    kf_mp = state.kf_mp
    shares = (ptset[torch.clamp(kf_mp, min=0).to(torch.int64)] & (kf_mp >= 0)).to(
        torch.int32).sum(1, dtype=torch.int32) * state.kf_valid.to(torch.int32)
    top_shares, top_kfs = _top_k_lowest_index(shares, N_LOCAL_KFS)
    top_kfs = torch.where(top_shares > 0, top_kfs, -1).to(torch.int32)
    fallback = torch.cat([rk.reshape(1).to(torch.int32),
                          torch.full((N_LOCAL_KFS - 1,), -1, dtype=torch.int32, device=dev)])
    local_pad = torch.where(torch.any(top_kfs >= 0), top_kfs, fallback)

    # --- Stage 2: local map ---------------------------------------------
    local_mask = _local_point_mask(state, local_pad)
    assoc2, visible = _track_local_map_match(model, params, R1, t1, state, local_mask, f_cur,
                                             assoc1, img_wh, n_levels=n_levels)
    res2 = _pose_opt_from_assoc(model, params, R1, t1, assoc2, f_cur, state.mp_pos,
                                state.mp_valid, sigma2_table, ur=ur_arr, bf=bf)
    assoc_final = torch.where(res2.inlier, assoc2, torch.full_like(assoc2, -1))

    # --- found/visible stats (stay on device) ---------------------------
    mp_found, mp_visible = st.bump_found_visible_arrays(state, visible, assoc_final)

    # Reference-KF tracked count for NeedNewKeyFrame (points with >= min_obs
    # observations).
    new_ref = torch.where(local_pad[0] >= 0, local_pad[0], rk.to(torch.int32))
    if obs_count is None:
        obs_count = compute_obs_count(state)
    row = st.row(state.kf_mp, new_ref)
    row_ok = (row >= 0) & st.row(state.kf_feat_valid, new_ref)
    ref_matches = torch.sum(
        row_ok & (obs_count[torch.clamp(row, min=0).to(torch.int64)] >= min_obs)
    ).to(torch.int32)

    # The new reference keyframe's pose rides in the bundle: the tracker
    # logs the frame relative to it without a host read of its own.
    bundle = dict(
        ok1=ok1, used_a=use_a, n_a=n_a, n_b=n_b,
        R=res2.R, t=res2.t, assoc=assoc_final,
        n_inl=res2.n_inliers, top_kfs=top_kfs, ref_matches=ref_matches,
        ref_kf=new_ref, ref_R=st.row(state.kf_R, new_ref), ref_t=st.row(state.kf_t, new_ref),
    )
    return bundle, (mp_found, mp_visible)


def fetch_bundle(bundle: dict) -> dict:
    """The bundle on the host as numpy, in ONE device-to-host copy: every
    entry is packed into one float64 vector (exact for int32, bool and
    float32 values) and unpacked after the copy."""
    keys = list(bundle)
    flat = [bundle[k].reshape(-1).to(torch.float64) for k in keys]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for k, f in zip(keys, flat):
        n = f.numel()
        t = bundle[k]
        v = host[i : i + n].reshape(tuple(t.shape))
        out[k] = v.astype(str(t.dtype).replace("torch.", ""))
        i += n
    return out


# ---------------------------------------------------------------------------
# Host tracker
# ---------------------------------------------------------------------------


class Tracker:
    """Host-side loop of the tracking state machine, monocular and visual only
    (`Tracking::Track`): NO_IMAGES_YET -> NOT_INITIALIZED -> OK <->
    RECENTLY_LOST -> LOST. Stereo, RGB-D and the two-camera rig (A10, A12)
    and the inertial branches (A11) are not ported: their entry points
    raise. Relocalization needs a keyframe database (A9); without one it
    fails, as the reference's does.

    Host synchronisations: a tracked frame that inserts no keyframe makes
    `HOST_SYNCS_PER_FRAME` = 2, both inside `_track_step`: the read of the
    motion model's success and the one fetch of the decision bundle. The
    frame's inputs go up through pinned memory without a sync
    (`convert.tensor`); the reference keyframe's pose for the trajectory
    log rides in the bundle; extraction is not waited for. Initialization
    and keyframe frames read more (the two-view result, the mapping pass)."""

    HOST_SYNCS_PER_FRAME = 2

    def __init__(self, model: cam.CameraModel, params: torch.Tensor, img_wh: Tuple[int, int],
                 store: st.MapStore, orb_params: feat.OrbParams = feat.OrbParams(),
                 fps: float = 20.0):
        self.model = model
        self.params = params
        self.device = params.device
        self.focal = float(params[0])
        self.img_wh_t = convert.tensor(np.asarray(img_wh, np.float32), self.device)
        self.store = store
        self.orb = orb_params
        self.state = TrackState.NO_IMAGES_YET
        self.sigma2_table = convert.tensor(feat.sigma2(orb_params), self.device)
        self.scale_table = convert.tensor(feat.scale_factors(orb_params), self.device)
        self.scale_np = feat.scale_factors(orb_params)

        self.last_frame: Optional[fr.FrameData] = None
        self.init_frame: Optional[fr.FrameData] = None
        self.ref_kf: int = -1  # covisibility reference (ref mpReferenceKF)
        self.last_kf_id: int = -1  # temporal chain anchor (ref mpLastKeyFrame)
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (R, t) of Tcl
        self._ref_pose = None  # (store, change_index, kf, R, t) from the bundle
        self._obs_cache = None  # ((id(store), change_index), obs_count)
        self.frame_id = 0
        self.trajectory = []  # (ts, store, ref kf, R_cr, t_cr)
        self.new_kf_callback = None  # set by System: runs local mapping
        self.anomaly_cb = None  # set by System: called with "reorder" (timestamp went back)
        self.kfdb = None  # keyframe database (place recognition, A9)
        # NeedNewKeyFrame policy state (ref `Tracking.cc:2577-2715`).
        self.max_frames = max(1, int(round(fps)))  # ref mMaxFrames = fps
        self.min_frames = 0  # ref mMinFrames
        self.time_recently_lost = 5.0  # ref time_recently_lost
        self.time_lost: Optional[float] = None  # ref mTimeStampLost
        self.last_reloc_frame_id = -(10**9)
        self.last_kf_frame_id = -(10**9)

    def reset_map_state(self, full: bool = False):
        """Clear every per-map field (`Tracking::ResetActiveMap`; `full`
        also clears the trajectory and the frame count, `Tracking::Reset`).
        Call before the fresh MapStore is swapped in: the trajectory filter
        drops the entries rooted in `self.store`."""
        self.state = TrackState.NO_IMAGES_YET if full else TrackState.NOT_INITIALIZED
        self.last_frame = None
        self.init_frame = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.velocity = None
        self._ref_pose = None
        self.time_lost = None
        self.last_reloc_frame_id = -(10**9)
        self.last_kf_frame_id = -(10**9)
        if full:
            self.trajectory = []
            self.frame_id = 0
        else:
            self.trajectory = [e for e in self.trajectory if e[1] is not self.store]

    # -- helpers --------------------------------------------------------
    def _extract(self, img: np.ndarray) -> feat.Features:
        """Features of a host image, left in flight on the device."""
        return feat.extract(convert.tensor(img, self.device, torch.float32), self.orb)

    def _kf_pose(self, kf: int):
        """Host copy of keyframe `kf`'s pose: from the last bundle when it
        carried this keyframe and the map has not changed since, else read
        from the store."""
        hit = self._ref_pose
        if hit is not None and hit[:3] == (self.store, self.store.change_index, kf):
            return hit[3], hit[4]
        s = self.store.state
        return s.kf_R[kf].cpu().numpy(), s.kf_t[kf].cpu().numpy()

    def _record_pose(self, ts, R, t):
        """Log the frame pose relative to its reference keyframe
        (mlRelativeFramePoses): the exported trajectory then chains through
        the current keyframe poses, so later BA corrections reach it."""
        R = np.asarray(R)
        t = np.asarray(t)
        if self.ref_kf >= 0:
            R_r, t_r = self._kf_pose(self.ref_kf)
            R_cr = R @ R_r.T  # T_cr = T_cw * T_rw^-1
            t_cr = t - R_cr @ t_r
            self.trajectory.append((ts, self.store, self.ref_kf, R_cr, t_cr))
        else:
            self.trajectory.append((ts, self.store, -1, R, t))

    def on_kf_culled(self, store, slot: int, new_ref: int):
        """Re-root the trajectory entries that reference a culled keyframe
        slot onto a live one, with both poses at cull time (slots are
        recycled, so a stale reference would chain through the next tenant)."""
        s = store.state
        R_r, t_r = s.kf_R[slot].cpu().numpy(), s.kf_t[slot].cpu().numpy()
        R_p, t_p = s.kf_R[new_ref].cpu().numpy(), s.kf_t[new_ref].cpu().numpy()
        R_rp = R_r @ R_p.T  # T_rp = T_rw * T_pw^-1
        t_rp = t_r - R_rp @ t_p
        self.trajectory = [
            (ts, st_e, int(new_ref), R_cr @ R_rp, R_cr @ t_rp + t_cr)
            if (st_e is store and ref == slot) else (ts, st_e, ref, R_cr, t_cr)
            for (ts, st_e, ref, R_cr, t_cr) in self.trajectory
        ]
        if store is self.store:
            if self.ref_kf == slot:
                self.ref_kf = int(new_ref)
            if self.last_kf_id == slot:
                self.last_kf_id = int(new_ref)

    def _obs_count_cached(self):
        """Per-point observation counts, recomputed only when the map moved
        (`compute_obs_count`)."""
        ver = (id(self.store), self.store.change_index)
        if self._obs_cache is None or self._obs_cache[0] != ver:
            self._obs_cache = (ver, compute_obs_count(self.store.state))
        return self._obs_cache[1]

    def reconstructed_trajectory(self):
        """(ts, Rwc, twc) per logged frame, chained through each entry's map's
        current keyframe poses."""
        cache = {}
        out = []
        for ts, store, ref, R_cr, t_cr in self.trajectory:
            if id(store) not in cache:
                cache[id(store)] = (store.state.kf_R.cpu().numpy(), store.state.kf_t.cpu().numpy())
            kf_R, kf_t = cache[id(store)]
            if ref >= 0:
                R_cw = R_cr @ kf_R[ref]
                t_cw = R_cr @ kf_t[ref] + t_cr
            else:
                R_cw, t_cw = R_cr, t_cr
            Rwc = R_cw.T
            out.append((ts, Rwc, -Rwc @ t_cw))
        return out

    # -- entries that wait for their slices -----------------------------
    def process_stereo_frame(self, img_left, img_right, timestamp):
        raise NotImplementedError("stereo tracking is ROADMAP A10")

    def process_rgbd_frame(self, img, depth_map, timestamp):
        raise NotImplementedError("RGB-D tracking is ROADMAP A10")

    def process_stereo_fisheye_frame(self, img_left, img_right, timestamp):
        raise NotImplementedError("the two-camera fisheye rig is ROADMAP A12")

    def grab_imu(self, t, acc, gyro):
        raise NotImplementedError("inertial tracking is ROADMAP A11")

    def _initialize_stereo(self, cur):
        raise NotImplementedError("stereo initialization is ROADMAP A10")

    def _create_depth_points(self, cur, slot):
        raise NotImplementedError("stereo/RGB-D point creation is ROADMAP A10")

    # -- main entry -----------------------------------------------------
    def process_frame(self, img: np.ndarray, timestamp: float) -> fr.FrameData:
        return self._process_with_features(self._extract(img), timestamp)

    def _process_with_features(self, f: feat.Features, timestamp: float) -> fr.FrameData:
        # A frame older than the last one resets the active map, and then
        # goes on as the first frame of a new one (`Tracking::Track`,
        # Tracking.cc:987-996). The >1 s gap branches are inertial (A11).
        if (self.anomaly_cb is not None and self.last_frame is not None
                and timestamp - self.last_frame.timestamp < 0):
            self.anomaly_cb("reorder")
        cur = fr.FrameData(features=f, timestamp=timestamp, frame_id=self.frame_id,
                           R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
                           mp_assoc=np.full(f.n, -1, np.int32))
        self.frame_id += 1
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._initialize_mono(cur)
        elif self._track_state_machine(cur):
            self.state = TrackState.OK
        if self.state == TrackState.OK:
            self._record_pose(cur.timestamp, cur.R, cur.t)
        self.last_frame = cur
        return cur

    def _track_state_machine(self, cur: fr.FrameData) -> bool:
        """One tracked frame through the reference's state machine
        (`Tracking::Track`, visual branches). Returns whether it tracked."""
        if self.state == TrackState.OK:
            if self._track(cur):
                return True
            # Failure out of OK: a grace period only for a usable map.
            if self.store.n_kf > 10:
                self.state = TrackState.RECENTLY_LOST
                self.time_lost = cur.timestamp
            else:
                self.state = TrackState.LOST
            return False
        if self._relocalize(cur):
            self.velocity = None
            self.last_reloc_frame_id = cur.frame_id
            if self._track(cur, have_pose=True):
                return True
        if self.state == TrackState.RECENTLY_LOST and (
                self.time_lost is None
                or cur.timestamp - self.time_lost > self.time_recently_lost):
            self.state = TrackState.LOST
        return False

    # -- initialization --------------------------------------------------
    def _initialize_mono(self, cur: fr.FrameData):
        """`MonocularInitialization`: the first frame with >= 100 keypoints
        becomes the reference; a later one with >= 100 matches to it tries
        the two-view reconstruction (the sampler seeded 0 on every attempt,
        as the reference's fixed key)."""
        if cur.n_features < 100:
            self.init_frame = None
            self.state = TrackState.NOT_INITIALIZED
            return
        if self.init_frame is None:
            self.init_frame = cur
            self.state = TrackState.NOT_INITIALIZED
            return
        ref = self.init_frame
        m = _match_for_initialization(ref.features, cur.features)
        if int(m.valid.sum()) < 100:
            self.init_frame = cur  # the reference frame is replaced
            return
        rays_ref = cam.unproject(self.model, self.params, ref.features.uv)[:, :2]
        rays_cur = cam.unproject(self.model, self.params, cur.features.uv)[:, :2]
        rays_cur = rays_cur[torch.clamp(m.idx, min=0).to(torch.int64)]
        gen = torch.Generator(device=self.device).manual_seed(0)
        res = ransac.reconstruct_two_views(rays_ref, rays_cur, m.valid, generator=gen,
                                           sigma_norm=1.0 / self.focal)
        if not bool(res.success):
            return
        self._create_initial_map(ref, cur, m, res)

    def _create_initial_map(self, ref: fr.FrameData, cur: fr.FrameData, m, res):
        """`CreateInitialMapMonocular`: two keyframes, the triangulated
        points, then (through the mapper) the initial BA and the median-depth
        normalization."""
        good = res.is_good.cpu().numpy()
        X = res.points.cpu().numpy()
        med_depth = float(np.median(X[good][:, 2])) if good.any() else 1.0
        inv_med = 1.0 / max(med_depth, 1e-6)
        X = X * inv_med
        R21 = res.R.cpu().numpy()
        t21 = res.t.cpu().numpy() * inv_med

        n_new = int(good.sum())
        slots = self.store.alloc_mps(n_new)
        sel = np.flatnonzero(good)
        idx_cur = m.idx.cpu().numpy()[sel]
        pos = X[sel]
        normals = pos / np.maximum(np.linalg.norm(pos, axis=-1, keepdims=True), 1e-9)
        dist = np.linalg.norm(pos, axis=-1)
        octs = ref.features.octave.cpu().numpy()[sel]
        sf = self.scale_np
        max_dist = dist * sf[np.clip(octs, 0, len(sf) - 1)]
        min_dist = max_dist / sf[-1]

        k0 = self.store.alloc_kf()
        k1 = self.store.alloc_kf()
        Nf = ref.features.n
        assoc0 = np.full(Nf, -1, np.int32)
        assoc0[sel] = slots
        assoc1 = np.full(Nf, -1, np.int32)
        assoc1[idx_cur] = slots

        T = self.store.tensor
        ur = torch.full((Nf,), -1.0, device=self.device)
        s = self.store.state
        s = st.add_keyframe(s, k0, torch.eye(3, device=self.device),
                            torch.zeros(3, device=self.device), ref.features.uv, ur,
                            ref.features.octave, ref.features.angle, ref.features.desc,
                            ref.features.valid, T(assoc0), prev_kf=-1)
        s = st.add_keyframe(s, k1, T(R21.astype(np.float32)), T(t21.astype(np.float32)),
                            cur.features.uv, ur, cur.features.octave, cur.features.angle,
                            cur.features.desc, cur.features.valid, T(assoc1), prev_kf=k0)
        s = st.add_points(s, T(slots), T(pos.astype(np.float32)),
                          ref.features.desc[T(sel)], T(normals.astype(np.float32)),
                          T(min_dist.astype(np.float32)), T(max_dist.astype(np.float32)),
                          T(np.full(n_new, k0, np.int32)), T(np.ones(n_new, bool)))
        self.store.state = s
        self.store.kf_ts[k0] = ref.timestamp
        self.store.kf_ts[k1] = cur.timestamp
        self.store.bump()

        # Initial BA (ref GlobalBundleAdjustemnt(20)) and depth normalization.
        if self.new_kf_callback is not None:
            self.new_kf_callback(k1, initial=True)

        cur.R = self.store.state.kf_R[k1].cpu().numpy()
        cur.t = self.store.state.kf_t[k1].cpu().numpy()
        cur.mp_assoc = assoc1
        self.ref_kf = k1
        self.last_kf_id = k1
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_id = cur.frame_id
        self._record_pose(ref.timestamp, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        self.init_frame = None

    # -- tracking --------------------------------------------------------
    def _track(self, cur: fr.FrameData, have_pose: bool = False) -> bool:
        """Two-stage tracking (`_track_step`) and the keyframe decision.
        `have_pose=True` (after relocalization) tracks from `cur`'s pose."""
        s = self.store.state
        last = self.last_frame
        R_pred = t_pred = None
        if not have_pose and self.velocity is not None and last is not None:
            Rv, tv = self.velocity  # constant-velocity motion model
            R_pred = Rv @ last.R
            t_pred = Rv @ last.t + tv
        have_pred = R_pred is not None and last is not None
        if not have_pred:
            R_pred = np.eye(3, dtype=np.float32)
            t_pred = np.zeros(3, np.float32)
        if have_pose:
            R_last, t_last = cur.R, cur.t
        elif last is not None:
            R_last, t_last = last.R, last.t
        else:
            R_last, t_last = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        Nf = cur.features.n
        last_mp = last.mp_assoc if last is not None else np.full(Nf, -1, np.int32)
        last_oct = (last.features.octave if last is not None
                    else torch.zeros(Nf, dtype=torch.int32, device=self.device))

        def up(x, dtype):
            return convert.tensor(np.asarray(x, dtype), self.device)

        bundle, (fnd, vis) = _track_step(
            self.model, self.params, s, cur.features, up(R_pred, np.float32),
            up(t_pred, np.float32), up(have_pred, bool), up(last_mp, np.int32), last_oct,
            up(self.ref_kf, np.int32), up(R_last, np.float32), up(t_last, np.float32),
            self.scale_table, self.sigma2_table, self.img_wh_t,
            up(3 if self.store.n_kf > 2 else 2, np.int32),
            obs_count=self._obs_count_cached(), n_levels=self.orb.n_levels,
        )
        b = fetch_bundle(bundle)  # the frame's one round trip
        if not bool(b["ok1"]):
            return False
        n_inl = int(b["n_inl"])
        if n_inl < 15:  # ref threshold 30 normal / 15 after reloc
            return False
        cur.R = b["R"]
        cur.t = b["t"]
        cur.mp_assoc = b["assoc"].copy()
        if int(b["top_kfs"][0]) >= 0:
            self.ref_kf = int(b["top_kfs"][0])
        self._ref_pose = (self.store, self.store.change_index, int(b["ref_kf"]), b["ref_R"],
                          b["ref_t"])
        self.store.state = s._replace(mp_found=fnd, mp_visible=vis)

        if last is not None:  # motion model update: Tcl = Tcw_cur * Twc_last
            Rl, tl = last.R, last.t
            Rwc, twc = Rl.T, -Rl.T @ tl
            self.velocity = (cur.R @ Rwc, cur.R @ twc + cur.t)

        if self._need_new_keyframe(cur, n_inl, int(b["ref_matches"])):
            self._create_keyframe(cur)
        return True

    def _relocalize(self, cur: fr.FrameData) -> bool:
        """`Tracking::Relocalization` needs the keyframe database of place
        recognition (A9); without one it fails, as the reference's does."""
        if self.kfdb is None:
            return False
        raise NotImplementedError("relocalization is ROADMAP A9")

    def _need_new_keyframe(self, cur: fr.FrameData, n_inl: int, ref_matches: int) -> bool:
        """`NeedNewKeyFrame` for a monocular, visual tracker with the
        synchronous (always idle) mapper: the reloc gate, the c1a/c1b frame
        gates and the 0.9 ratio to `ref_matches`, the reference keyframe's
        well-observed points (0.4 while the map has < 2 keyframes)."""
        if self.ref_kf < 0:
            return False
        nkf = self.store.n_kf - len(self.store.free_kf_slots)
        if (cur.frame_id < self.last_reloc_frame_id + self.max_frames
                and nkf > self.max_frames):
            return False
        th_ratio = 0.4 if nkf < 2 else 0.9
        c1a = cur.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = cur.frame_id >= self.last_kf_frame_id + self.min_frames
        c2 = (n_inl < ref_matches * th_ratio) and n_inl > 15
        return (c1a or c1b) and c2

    def _create_keyframe(self, cur: fr.FrameData):
        """`CreateNewKeyFrame`: insert the frame as a keyframe and run its
        mapping pass (the reference's `_create_keyframe_impl`)."""
        slot = self.store.alloc_kf()
        T = self.store.tensor
        f = cur.features
        self.store.state = st.add_keyframe(
            self.store.state, slot, T(cur.R.astype(np.float32)), T(cur.t.astype(np.float32)),
            f.uv, torch.full((f.n,), -1.0, device=self.device), f.octave, f.angle, f.desc,
            f.valid, T(cur.mp_assoc.astype(np.int32)), prev_kf=self.last_kf_id,
        )
        self.store.kf_ts[slot] = cur.timestamp
        self.store.bump()
        self.ref_kf = slot
        self.last_kf_id = slot
        self.last_kf_frame_id = cur.frame_id
        if self.new_kf_callback is not None:
            self.new_kf_callback(slot, initial=False)
        # The mapping pass may have fused points into this keyframe.
        cur.mp_assoc = self.store.state.kf_mp[slot].cpu().numpy()
