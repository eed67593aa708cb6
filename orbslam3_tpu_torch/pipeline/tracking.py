"""Per-frame tracking on torch tensors — the port of
`orbslam3_tpu/pipeline/tracking.py` for monocular, rectified stereo, RGB-D
and two-camera fisheye rigs, pinhole or Kannala-Brandt 8, with or without
an IMU: the device programs of one tracked frame
(`_track_last_frame` (motion model), `_track_reference_kf` (fallback),
`_local_point_mask`, `_track_local_map_match`, `_pose_opt_from_assoc`,
`compute_obs_count` and `_track_step`, which chains them), the
initialization matcher `_match_for_initialization`, relocalization's
`_projection_rescue_match`, the pose-inertial solves' observation sets
(`_pose_inertial_from_assoc`, `_pose_inertial_lf_from_assoc`), and the host
state machine `Tracker` (two-view or single-frame stereo initialization,
tracking, relocalization, the keyframe policy, keyframe insertion with the
stereo depth points; for a monocular-inertial sensor the IMU queue, the
per-gap preintegration, the IMU prediction, the pose-inertial refinement,
IMU dead-reckoning while recently lost and the inertial keyframe rows; for
a two-camera rig the lapping-area match and the right-camera rows of the
pose solves).

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

from orbslam3_tpu_torch import convert, spans
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops import lie, matching, ransac, stereo
from orbslam3_tpu_torch.optim import pose_inertial, pose_only
from orbslam3_tpu_torch.pipeline import frame as fr
from orbslam3_tpu_torch.pipeline import inertial_support as isup

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


def _projection_rescue_match(model, params, R, t, state: st.MapState, point_mask,
                             f_cur: feat.Features, cur_assoc, img_wh, base_radius: float,
                             max_dist: float, n_levels: int = 8):
    """Relocalization's guided second chance (`Tracking.cc:3376-3424`,
    `ORBmatcher::SearchByProjection(Frame, KeyFrame*, ...)`): project the
    candidate keyframe's points at the coarse pose and match them into the
    frame's free keypoints inside base_radius x 1.2^level, octave-gated,
    with a plain Hamming budget and no ratio test (kernel B1 over all Pmax
    queries); the found rows are merged into `cur_assoc`."""
    uv, visible, lvl, _ = fr.frustum_and_scale(
        model, params, R, t, state.mp_pos, state.mp_valid & point_mask, state.mp_normal,
        state.mp_min_dist, state.mp_max_dist, img_wh, n_levels=n_levels,
    )
    already = st.flag(state.Pmax, torch.clamp(cur_assoc, min=0), cur_assoc >= 0)
    r = base_radius * 1.2 ** lvl.to(torch.float32)
    m = matching.search_by_projection(
        state.mp_desc, uv, visible & ~already, f_cur.desc, f_cur.uv, f_cur.valid & (cur_assoc < 0),
        radius=r, octave_kp=f_cur.octave, octave_lo=torch.clamp(lvl - 1, min=0),
        octave_hi=lvl + 1, max_dist=max_dist, ratio=1.0,
    )
    m = matching.assign_unique(m, f_cur.desc.shape[0])
    src = torch.arange(state.Pmax, dtype=torch.int32, device=cur_assoc.device)
    return st.scatter_rows(cur_assoc, m.idx, m.valid, src)


def _pose_obs(assoc, f_cur: feat.Features, mp_pos, mp_valid, sigma2_table, ur=None):
    """The observations of the features associated to valid map points."""
    a = torch.clamp(assoc, min=0).to(torch.int64)
    L = sigma2_table.shape[0]
    return pose_only.PoseObs(
        Xw=mp_pos[a], uv=f_cur.uv,
        ur=ur if ur is not None else torch.full(assoc.shape, -1.0, device=assoc.device),
        sigma2=sigma2_table[torch.clamp(f_cur.octave, 0, L - 1).to(torch.int64)],
        valid=(assoc >= 0) & f_cur.valid & mp_valid[a],
    )


def _pose_opt_from_assoc(model, params, R0, t0, assoc, f_cur: feat.Features, mp_pos,
                         mp_valid, sigma2_table, ur=None, bf: float = 0.0, rig=None):
    """Pose-only solve over the features associated to valid map points.
    `rig` = (params_r, R_rl, t_rl, uv_r, sig2_r, has_r): a two-camera rig's
    frame adds a right-camera row for each of them with a right match."""
    obs = _pose_obs(assoc, f_cur, mp_pos, mp_valid, sigma2_table, ur)
    if rig is None:
        return pose_only.optimize_pose(model, params, R0, t0, obs, bf=bf)
    params_r, R_rl, t_rl, uv_r, sig2_r, has_r = rig
    obs_r = pose_only.PoseObs(Xw=obs.Xw, uv=uv_r, ur=torch.full_like(obs.ur, -1.0),
                              sigma2=sig2_r, valid=obs.valid & has_r)
    with spans.span("pose solve with right rows"):
        return pose_only.optimize_pose(model, params, R0, t0, obs, bf=bf, obs_r=obs_r,
                                       params_r=params_r, R_rl=R_rl, t_rl=t_rl)


def _pose_inertial_from_assoc(model, params, assoc, f_cur: feat.Features, mp_pos, mp_valid,
                              sigma2_table, Rbc, tbc, kf_R, kf_t, kf_vel, kf_bg, kf_ba,
                              pre: imu_ops.Preintegrated, R0, t0, v0, ur=None, bf: float = 0.0):
    """The visual-inertial refinement of the frame state against the last
    keyframe (`PoseInertialOptimizationLastKeyFrame`): the observation set
    of `_pose_opt_from_assoc`, the keyframe's camera pose and the frame's
    visual pose (R0, t0) turned into body poses."""
    obs = _pose_obs(assoc, f_cur, mp_pos, mp_valid, sigma2_table, ur)
    R_kf, p_kf = isup.cam_to_body(kf_R, kf_t, Rbc, tbc)
    R0b, p0b = isup.cam_to_body(R0, t0, Rbc, tbc)
    return pose_inertial.optimize_pose_inertial(model, params, obs, Rbc, tbc, R_kf, p_kf, kf_vel,
                                                kf_bg, kf_ba, pre, R0b, p0b, v0, bf=bf)


def _pose_inertial_lf_from_assoc(model, params, assoc, f_cur: feat.Features, mp_pos, mp_valid,
                                 sigma2_table, Rbc, tbc, R_lf, p_lf, v_lf, bg_lf, ba_lf, H_prior,
                                 pre: imu_ops.Preintegrated, R0, t0, v0, ur=None, bf: float = 0.0):
    """`PoseInertialOptimizationLastFrame`: anchored on the previous frame's
    body state and its marginalization prior (`H_prior`, a host array)."""
    obs = _pose_obs(assoc, f_cur, mp_pos, mp_valid, sigma2_table, ur)
    R0b, p0b = isup.cam_to_body(R0, t0, Rbc, tbc)
    return pose_inertial.optimize_pose_inertial_last_frame(
        model, params, obs, Rbc, tbc, R_lf, p_lf, v_lf, bg_lf, ba_lf, H_prior, pre, R0b, p0b, v0,
        bf=bf)


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
                n_levels: int = 8, obs_count=None, rig=None):
    """The two-stage visual tracking of one frame: motion-model match + pose
    solve, reference-KF fallback, device-side local-keyframe top-16,
    local-map match + final pose solve, found/visible bookkeeping.

    Host synchronisation: two per frame. The reference's `lax.cond` on the
    motion model's success becomes one host read of `ok_a` here, so the
    fallback (a 1024x1024 cross-checked match and a 40-iteration solve) runs
    only when the motion model failed, as in the reference. The second is
    the caller's single fetch of the returned bundle (`fetch_bundle`).

    `have_pred`, `ref_kf` and `min_obs` are 0-d device tensors; `obs_count`
    is the caller's cached `compute_obs_count(state)`; `rig` adds a
    two-camera rig's right rows to the three pose solves
    (`_pose_opt_from_assoc`).
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
                                 state.mp_pos, state.mp_valid, sigma2_table, ur=ur_arr, bf=bf,
                                 rig=rig)
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
                                     ur=ur_arr, bf=bf, rig=rig)
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
                                state.mp_valid, sigma2_table, ur=ur_arr, bf=bf, rig=rig)
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
    """Host-side loop of the tracking state machine (`Tracking::Track`):
    NO_IMAGES_YET -> NOT_INITIALIZED -> OK <-> RECENTLY_LOST -> LOST, for a
    monocular (`process_frame`), rectified stereo (`process_stereo_frame`),
    RGB-D (`process_rgbd_frame`) or two-camera rig
    (`process_stereo_fisheye_frame`, with `camera2`) pinhole or
    Kannala-Brandt 8 camera. A stereo or RGB-D frame carries each keypoint's
    right-image u and depth: it initializes the map on its own, adds the
    (u, v, u_right) rows to the pose solves, and seeds depth points at each
    keyframe. A rig's frame carries each keypoint's triangulated depth
    (its u_right is -1: no rectified row) and, on the device, its right
    match, which adds a right-camera row to the three pose solves of
    `_track_step`. With `imu_calib` the tracker is inertial: `grab_imu`
    queues the samples, each frame gap is preintegrated and merged since
    the last keyframe, keyframes come at 4 Hz until the mapper initializes
    the IMU (`imu_ready`), and after it each frame is predicted from the IMU
    and refined by the pose-inertial solve (`Tracking::TrackLocalMap`).
    Relocalization needs a keyframe database (place recognition,
    `System.enable_place_recognition`); without one it fails, as the
    reference's does.

    Host synchronisations: a tracked monocular frame that inserts no
    keyframe makes `HOST_SYNCS_PER_FRAME` = 2, both inside `_track_step`:
    the read of the motion model's success and the one fetch of the
    decision bundle. A stereo or RGB-D frame adds one, the fetch of its
    stacked `ur` and depth (`HOST_SYNCS_PER_STEREO_FRAME` = 3); so does a
    rig's frame, the fetch of its depth (the right rows stay on the
    device). The frame's inputs go up through pinned memory without a sync
    (`convert.tensor`); the reference keyframe's pose for the trajectory log
    rides in the bundle; extraction is not waited for. Initialization and keyframe
    frames read more (the two-view result, the depth points, the mapping
    pass). A monocular-inertial frame makes the monocular 2 before the IMU
    is initialized (its preintegration goes up without a sync), and
    `HOST_SYNCS_PER_INERTIAL_FRAME` = 4 after it: the 2, the one fetch of
    the IMU prediction (the pose the motion-model stage projects with), and
    the one fetch of the pose-inertial result, as the reference reads them
    (`tracking.py:1172-1177, 1298`); a stereo-inertial frame (a rectified
    pair or a rig) makes the stereo 3 before the initialization and
    `HOST_SYNCS_PER_STEREO_INERTIAL_FRAME` = 3 + 2 after it."""

    HOST_SYNCS_PER_FRAME = 2
    HOST_SYNCS_PER_STEREO_FRAME = 3
    HOST_SYNCS_PER_INERTIAL_FRAME = 4
    HOST_SYNCS_PER_STEREO_INERTIAL_FRAME = 5

    def __init__(self, model: cam.CameraModel, params: torch.Tensor, img_wh: Tuple[int, int],
                 store: st.MapStore, orb_params: feat.OrbParams = feat.OrbParams(),
                 bf: float = 0.0, fps: float = 20.0, imu_calib: imu_ops.ImuCalib | None = None,
                 camera2=None):
        self.model = model
        self.params = params
        self.device = params.device
        self.focal = float(params[0])
        self.bf = bf  # stereo baseline x fx (pixels x metres); 0 for monocular
        self.th_depth = 35.0  # ref ThDepth: close points lie under th_depth baselines
        self.is_stereo_like = False  # stereo or RGB-D (set by System)
        self.img_wh_t = convert.tensor(np.asarray(img_wh, np.float32), self.device)
        # A two-camera rig (`Frame.cc:1187`): camera2 = (params2, Tlr (4x4,
        # the right camera in the left frame), lap1, lap2); each lapping area
        # is a (u_lo, u_hi) range, the whole width when empty.
        self.camera2 = None
        if camera2 is not None:
            params2, Tlr, lap1, lap2 = camera2
            Tlr = np.asarray(Tlr, np.float64)
            R_rl = Tlr[:3, :3].T
            W = float(img_wh[0])
            self.camera2 = dict(
                params=convert.tensor(np.asarray(params2, np.float32), self.device),
                R_rl=convert.tensor(R_rl.astype(np.float32), self.device),
                t_rl=convert.tensor((-R_rl @ Tlr[:3, 3]).astype(np.float32), self.device),
                lap1=tuple(lap1) if lap1 else (0.0, W - 1.0),
                lap2=tuple(lap2) if lap2 else (0.0, W - 1.0),
                baseline=float(np.linalg.norm(Tlr[:3, 3])))
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
        self.new_kf_callback = None  # set by System: mapping pass, loop closing -> corrected?
        self.anomaly_cb = None  # set by System: called with "reorder" (timestamp went back)
        self.kfdb = None  # keyframe database (set by enable_place_recognition)
        # The mapper's state for the keyframe decision (`LocalMapping::
        # AcceptKeyFrames`, `KeyframesInQueue`): None is a synchronous mapper,
        # always idle with an empty queue.
        self.mapper_idle_query = None  # callable -> bool
        self.mapping_queue_len = None  # callable -> int
        # NeedNewKeyFrame policy state (ref `Tracking.cc:2577-2715`).
        self.max_frames = max(1, int(round(fps)))  # ref mMaxFrames = fps
        self.min_frames = 0  # ref mMinFrames
        self.time_recently_lost = 5.0  # ref time_recently_lost
        self.time_lost: Optional[float] = None  # ref mTimeStampLost
        self.last_reloc_frame_id = -(10**9)
        self.last_kf_frame_id = -(10**9)
        # Inertial plumbing (ref Tracking.cc:621-850).
        self.imu_calib = imu_calib
        if imu_calib is not None:
            self.imu_queue = isup.ImuQueue()
            self.Rbc = imu_calib.Rbc.cpu().numpy()
            self.tbc = imu_calib.tbc.cpu().numpy()
        # The last frame's marginalization prior (ref Frame::mpcpi): host
        # (R, p, v, bg, ba, H15), valid while the map is unchanged since.
        self.frame_prior = None
        self.prior_map_version = -1
        self.prior_ts = -1.0  # timestamp of the frame the prior belongs to
        self.pi_taken = False  # whether this frame took the pose-inertial result
        self._map_transformed = False  # set by apply_map_transform
        self._reset_inertial()

    def _reset_inertial(self):
        self.imu_ready = False  # set by the mapper after IMU initialization
        self.pre_from_kf = None  # preintegration since the last keyframe
        self.pre_frame = None  # preintegration over the last frame gap
        self.body_vel = np.zeros(3, np.float32)
        self.bias_g = np.zeros(3, np.float32)
        self.bias_a = np.zeros(3, np.float32)

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
        self.frame_prior = None
        self.prior_map_version = -1
        self._reset_inertial()
        if full:
            self.trajectory = []
            self.frame_id = 0
            if self.imu_calib is not None:
                self.imu_queue = isup.ImuQueue()
        else:
            self.trajectory = [e for e in self.trajectory if e[1] is not self.store]

    # -- helpers --------------------------------------------------------
    def _image(self, img) -> torch.Tensor:
        """A host image (or a tensor already on the device, as the
        rectifier returns) as a float32 tensor on the device."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32)
        return convert.tensor(img, self.device, torch.float32)

    def _extract(self, img) -> feat.Features:
        """Features of an image, left in flight on the device."""
        return feat.extract(self._image(img), self.orb)

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

    def apply_map_transform(self, Rwg: np.ndarray, s: float):
        """Keep the tracker's state in the map's frame after
        `apply_scaled_rotation` (IMU initialization, scale refinement): world
        x' = s Rwg^T x, so the last frame's pose becomes Rcw Rwg, s tcw; the
        motion model's translation and the relative trajectory of this map
        scale by s (`Tracking::UpdateFrameIMU`, `Tracking.cc:3161-3224`). The
        marginalization prior, in the old frame, is dropped. A keyframe frame
        whose mapping pass transformed the map then takes its keyframe's pose
        (fault C13, `_create_keyframe`)."""
        Rwg = np.asarray(Rwg, np.float32)
        s = float(s)
        self.frame_prior = None
        self._map_transformed = True
        if self.last_frame is not None:
            self.last_frame.R = np.asarray(self.last_frame.R) @ Rwg
            self.last_frame.t = s * np.asarray(self.last_frame.t)
        if self.velocity is not None:
            Rv, tv = self.velocity
            self.velocity = (Rv, s * tv)
        self._ref_pose = None
        self.trajectory = [
            (ts, store_e, ref, R_cr, s * t_cr) if store_e is self.store
            else (ts, store_e, ref, R_cr, t_cr)
            for (ts, store_e, ref, R_cr, t_cr) in self.trajectory
        ]

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

    def grab_imu(self, t: float, acc, gyro):
        """`Tracking::GrabImuData`: queue one sample (host)."""
        self.imu_queue.push(t, acc, gyro)

    # -- main entry -----------------------------------------------------
    def process_frame(self, img: np.ndarray, timestamp: float) -> fr.FrameData:
        return self._process_with_features(self._extract(img), timestamp)

    def process_stereo_frame(self, img_left, img_right, timestamp: float) -> fr.FrameData:
        """`GrabImageStereo`: features of both images (kernel B2 on each
        atlas), the scanline match for each left keypoint's right u and
        depth (one fetch of both), then the frame as a stereo one. Every
        positive depth is kept: the close/far rule applies where points are
        created and in the keyframe census, not here."""
        il, ir = self._image(img_left), self._image(img_right)
        f = self._extract(il)
        f_r = self._extract(ir)
        sm = stereo.match_stereo_rectified(f, f_r, il, ir, self.bf, self.scale_table)
        ur, depth = torch.stack([sm.ur, sm.depth]).cpu().numpy()
        return self._process_with_features(f, timestamp, ur=ur, depth=depth)

    def process_rgbd_frame(self, img, depth_map, timestamp: float) -> fr.FrameData:
        """`GrabImageRGBD`: features of the image, then each keypoint's depth
        from the registered depth map (metres, <= 0 none) and its virtual
        right u = u - bf / depth (one fetch of both)."""
        f = self._extract(img)
        d = convert.tensor(depth_map, self.device, torch.float32)
        sm = stereo.depth_to_ur(f.uv, f.valid, d, self.bf)
        ur, depth = torch.stack([sm.ur, sm.depth]).cpu().numpy()
        return self._process_with_features(f, timestamp, ur=ur, depth=depth)

    def process_stereo_fisheye_frame(self, img_left, img_right,
                                     timestamp: float) -> fr.FrameData:
        """A two-camera rig's frame (`Frame.cc:1187`,
        `ComputeStereoFishEyeMatches`): features of both images (kernel B2
        on each atlas), the lapping-area match and its triangulation
        (`stereo.match_stereo_fisheye`, kernel B1 twice), each left
        keypoint's depth fetched once; its right match's pixel, octave
        variance and existence stay on the device for the right-camera rows.
        `ur` is -1 everywhere (no rectified row), as the reference's."""
        c2 = self.camera2
        if c2 is None:
            raise ValueError("a two-camera rig's frame needs a Tracker built with camera2")
        f = self._extract(img_left)
        f_r = self._extract(img_right)
        with spans.span("fisheye match"):
            fs = stereo.match_stereo_fisheye(self.model, self.params, c2["params"], f, f_r,
                                             c2["R_rl"], c2["t_rl"], self.sigma2_table,
                                             lap_l=c2["lap1"], lap_r=c2["lap2"])
        ridx = torch.clamp(fs.right_idx, min=0).to(torch.int64)
        L = self.sigma2_table.shape[0]
        sig2_r = self.sigma2_table[torch.clamp(f_r.octave[ridx], 0, L - 1).to(torch.int64)]
        depth = fs.depth.cpu().numpy()  # the frame's one read of the match
        return self._process_with_features(
            f, timestamp, ur=np.full(f.n, -1.0, np.float32), depth=depth, uv_r=f_r.uv[ridx],
            sig2_r=sig2_r, has_r=fs.valid & (fs.right_idx >= 0))

    def _process_with_features(self, f: feat.Features, timestamp: float,
                               ur: Optional[np.ndarray] = None,
                               depth: Optional[np.ndarray] = None,
                               uv_r: Optional[torch.Tensor] = None,
                               sig2_r: Optional[torch.Tensor] = None,
                               has_r: Optional[torch.Tensor] = None) -> fr.FrameData:
        # Timestamp anomalies (`Tracking::Track`, Tracking.cc:987-1031): a
        # frame older than the last one resets the active map; an inertial
        # gap of more than 1 s reports "gap_init" (IMU initialized) or
        # "gap_uninit". The frame then goes on as the first of a new map.
        if self.anomaly_cb is not None and self.last_frame is not None:
            dt = timestamp - self.last_frame.timestamp
            if dt < 0:
                self.anomaly_cb("reorder")
            elif dt > 1.0 and self.imu_calib is not None:
                self.anomaly_cb("gap_init" if self.imu_ready else "gap_uninit")
        cur = fr.FrameData(features=f, timestamp=timestamp, frame_id=self.frame_id,
                           R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32),
                           mp_assoc=np.full(f.n, -1, np.int32), ur=ur, depth=depth,
                           uv_r=uv_r, sig2_r=sig2_r, has_r=has_r)
        self.frame_id += 1
        self.pi_taken = False
        # IMU preintegration over the frame gap (`PreintegrateIMU`), merged
        # into the window since the last keyframe. No host read.
        if self.imu_calib is not None and self.last_frame is not None:
            with spans.span("preintegration"):
                self.pre_frame = isup.preintegrate_window(
                    self.imu_queue, self.last_frame.timestamp, timestamp, self.bias_g,
                    self.bias_a, self.imu_calib)
            if self.pre_frame is not None:
                self.pre_from_kf = (self.pre_frame if self.pre_from_kf is None else
                                    imu_ops.merge(self.pre_from_kf, self.pre_frame,
                                                  self.imu_calib))
        publish_anyway = False
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            if cur.ur is not None:
                self._initialize_stereo(cur)
            else:
                self._initialize_mono(cur)
        else:
            ok, publish_anyway = self._track_state_machine(cur)
            if ok:
                self.state = TrackState.OK
        if self.state == TrackState.OK or publish_anyway:
            self._record_pose(cur.timestamp, cur.R, cur.t)
        self.last_frame = cur
        return cur

    def _track_state_machine(self, cur: fr.FrameData):
        """One tracked frame through the reference's state machine
        (`Tracking::Track`, `Tracking.cc:1100-1290`). Returns (ok,
        publish_anyway): the latter marks an IMU dead-reckoned pose that goes
        to the trajectory while RECENTLY_LOST."""
        inertial = self.imu_calib is not None
        if self.state == TrackState.OK:
            if self._track(cur):
                return True, False
            # Failure out of OK: a grace period only for a usable map.
            if self.store.n_kf > 10 and (not inertial or self.imu_ready):
                self.state = TrackState.RECENTLY_LOST
                self.time_lost = cur.timestamp
            else:
                self.state = TrackState.LOST
            return False, False
        if self.state == TrackState.RECENTLY_LOST and inertial and self.imu_ready:
            # IMU dead-reckoning (`Track:1210-1225`): predict through the
            # gap, publish the pose, and try the two-stage track from it.
            published = False
            if self.pre_frame is not None and self.last_frame is not None:
                cur.R, cur.t, self.body_vel = self._imu_predict(self.last_frame)
                published = True
            if self._track(cur, have_pose=published):
                return True, False
            if self.time_lost is not None and \
                    cur.timestamp - self.time_lost > self.time_recently_lost:
                self.state = TrackState.LOST  # the 5 s cap
                return False, False
            return False, published
        if self._relocalize(cur):
            self.velocity = None
            self.last_reloc_frame_id = cur.frame_id
            if self._track(cur, have_pose=True):
                return True, False
        if self.state == TrackState.RECENTLY_LOST and (
                self.time_lost is None
                or cur.timestamp - self.time_lost > self.time_recently_lost):
            self.state = TrackState.LOST
        return False, False

    def _imu_predict(self, last: fr.FrameData):
        """`PredictStateIMU` from the last frame's pose through the last gap:
        the camera pose (R, t) and the body velocity, as host arrays. The
        state goes up in one pinned copy; the prediction comes back in one
        fetch (the frame's one read of it)."""
        R_wb, p_wb = isup.cam_to_body(np.asarray(last.R, np.float32),
                                      np.asarray(last.t, np.float32), self.Rbc, self.tbc)
        up = convert.tensor(np.concatenate([R_wb.reshape(-1), p_wb, self.body_vel, self.bias_g,
                                            self.bias_a]).astype(np.float32), self.device)
        R1, v1, p1 = isup.predict_state(up[0:9].reshape(3, 3), up[9:12], up[12:15], up[15:18],
                                        up[18:21], self.pre_frame)
        Rp, tp = isup.body_to_cam(R1, p1, self.imu_calib.Rbc, self.imu_calib.tbc)
        b = fetch_bundle(dict(R=Rp, t=tp, v=v1))
        return b["R"], b["t"], b["v"]

    # -- initialization --------------------------------------------------
    def _initialize_stereo(self, cur: fr.FrameData, min_features: int = 300):
        """`StereoInitialization`: a frame with >= `min_features` keypoints
        and >= 100 depths seeds the map alone. It becomes keyframe 0 at the
        identity pose with its `ur` row, and every keypoint with a depth
        becomes a point at its back-projection (metric scale from the
        baseline). No mapping pass runs on it, as in the reference."""
        if cur.n_features < min_features or cur.depth is None:
            return
        f = cur.features
        depth = cur.depth
        kp_ok = f.valid.cpu().numpy() & (depth > 0)
        n_new = int(kp_ok.sum())
        if n_new < 100:
            return
        rays = cam.unproject(self.model, self.params, f.uv).cpu().numpy()
        sel = np.flatnonzero(kp_ok)
        pos = (rays * depth[:, None])[sel]  # the identity pose: camera frame = world
        slots = self.store.alloc_mps(n_new)
        dist = np.linalg.norm(pos, axis=-1)
        normal = pos / np.maximum(dist[:, None], 1e-9)
        sf = self.scale_np
        max_d = dist * sf[np.clip(f.octave.cpu().numpy()[sel], 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        k0 = self.store.alloc_kf()
        assoc = np.full(f.n, -1, np.int32)
        assoc[sel] = slots
        T = self.store.tensor
        s = st.add_keyframe(self.store.state, k0, torch.eye(3, device=self.device),
                            torch.zeros(3, device=self.device), f.uv,
                            T(cur.ur.astype(np.float32)), f.octave, f.angle, f.desc, f.valid,
                            T(assoc), prev_kf=-1)
        self.store.state = st.add_points(
            s, T(slots), T(pos.astype(np.float32)), f.desc[T(sel)],
            T(normal.astype(np.float32)), T(min_d.astype(np.float32)),
            T(max_d.astype(np.float32)), T(np.full(n_new, k0, np.int32)),
            T(np.ones(n_new, bool)))
        self.store.kf_ts[k0] = cur.timestamp
        self.store.bump()
        cur.mp_assoc = assoc
        self.ref_kf = k0
        self.last_kf_id = k0
        self.velocity = None
        self.state = TrackState.OK
        self.last_kf_frame_id = cur.frame_id
        self.init_frame = None

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
            self.pre_from_kf = None  # the preintegration restarts at the reference
            self.state = TrackState.NOT_INITIALIZED
            return
        ref = self.init_frame
        m = _match_for_initialization(ref.features, cur.features)
        if int(m.valid.sum()) < 100:
            self.init_frame = cur  # the reference frame is replaced
            self.pre_from_kf = None
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

        # Initial BA (ref GlobalBundleAdjustemnt(20)) and depth normalization;
        # the mapper keeps keyframe 1's preintegration from the reference.
        if self.new_kf_callback is not None:
            self.new_kf_callback(k1, initial=True, preint=self.pre_from_kf)
        self.pre_from_kf = None

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
        if have_pose:
            pass
        elif self.imu_ready and self.pre_frame is not None and last is not None:
            # The IMU prediction replaces the constant-velocity model.
            R_pred, t_pred, self.body_vel = self._imu_predict(last)
        elif self.velocity is not None and last is not None:
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

        c2 = self.camera2
        rig = None
        if c2 is not None and cur.uv_r is not None:
            rig = (c2["params"], c2["R_rl"], c2["t_rl"], cur.uv_r, cur.sig2_r, cur.has_r)

        bundle, (fnd, vis) = _track_step(
            self.model, self.params, s, cur.features, up(R_pred, np.float32),
            up(t_pred, np.float32), up(have_pred, bool), up(last_mp, np.int32), last_oct,
            up(self.ref_kf, np.int32), up(R_last, np.float32), up(t_last, np.float32),
            self.scale_table, self.sigma2_table, self.img_wh_t,
            up(3 if self.store.n_kf > 2 else 2, np.int32),
            ur=up(cur.ur, np.float32) if cur.ur is not None else None, bf=self.bf,
            obs_count=self._obs_count_cached(), n_levels=self.orb.n_levels, rig=rig,
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
        if self.imu_ready and self.pre_from_kf is not None and self.last_kf_id >= 0:
            n_inl = self._pose_inertial(cur, last, n_inl)

        if last is not None:  # motion model update: Tcl = Tcw_cur * Twc_last
            Rl, tl = last.R, last.t
            Rwc, twc = Rl.T, -Rl.T @ tl
            self.velocity = (cur.R @ Rwc, cur.R @ twc + cur.t)

        if self._need_new_keyframe(cur, n_inl, int(b["ref_matches"])):
            self._create_keyframe(cur)
        return True

    def _pose_inertial(self, cur: fr.FrameData, last, n_inl: int) -> int:
        """After IMU initialization the pose-inertial solve replaces the
        visual pose (`Tracking::TrackLocalMap`, `Tracking.cc:2470-2490`): the
        LastFrame variant when the previous frame left a prior and the map is
        unchanged since (ref `mbMapUpdated`), else the LastKeyFrame one. Its
        result is taken with >= 15 inliers, and its marginal H becomes the
        next frame's prior. One fetch. Returns the inlier count."""
        s = self.store.state
        T = self.store.tensor
        assoc = T(cur.mp_assoc.astype(np.int32))
        R0, t0 = T(np.asarray(cur.R, np.float32)), T(np.asarray(cur.t, np.float32))
        v0 = T(np.asarray(self.body_vel, np.float32))
        ur = T(cur.ur.astype(np.float32)) if cur.ur is not None else None
        cal = self.imu_calib
        use_lf = (self.frame_prior is not None and self.pre_frame is not None and last is not None
                  and self.prior_ts == last.timestamp
                  and self.prior_map_version == self.store.change_index)
        if use_lf:
            R_a, p_a, v_a, bg_a, ba_a, H_a = self.frame_prior
            anchor = T(np.concatenate([R_a.reshape(-1), p_a, v_a, bg_a, ba_a]).astype(np.float32))
            with spans.span("pose-inertial (last frame)"):
                res = _pose_inertial_lf_from_assoc(
                    self.model, self.params, assoc, cur.features, s.mp_pos, s.mp_valid,
                    self.sigma2_table, cal.Rbc, cal.tbc, anchor[0:9].reshape(3, 3),
                    anchor[9:12], anchor[12:15], anchor[15:18], anchor[18:21], H_a,
                    self.pre_frame, R0, t0, v0, ur=ur, bf=self.bf)
        else:
            k = self.last_kf_id
            with spans.span("pose-inertial (last keyframe)"):
                res = _pose_inertial_from_assoc(
                    self.model, self.params, assoc, cur.features, s.mp_pos, s.mp_valid,
                    self.sigma2_table, cal.Rbc, cal.tbc, s.kf_R[k], s.kf_t[k], s.kf_vel[k],
                    s.kf_bias_g[k], s.kf_bias_a[k], self.pre_from_kf, R0, t0, v0, ur=ur,
                    bf=self.bf)
        rv = fetch_bundle(res._asdict())  # the result's one round trip
        n_vi = int(rv["n_inliers"])
        if n_vi < 15:
            self.frame_prior = None
            return n_inl
        cur.R, cur.t = rv["Rcw"], rv["tcw"]
        cur.mp_assoc = np.where(rv["inlier"], cur.mp_assoc, -1).astype(np.int32)
        self.body_vel, self.bias_g, self.bias_a = rv["v"], rv["bg"], rv["ba"]
        self.frame_prior = (rv["R_wb"], rv["p_wb"], rv["v"], rv["bg"], rv["ba"], rv["H"])
        self.prior_map_version = self.store.change_index
        self.prior_ts = cur.timestamp
        self.pi_taken = True
        return n_vi

    def _relocalize(self, cur: fr.FrameData) -> bool:
        """`Tracking::Relocalization` (`Tracking.cc:3248`): keyframe-database
        candidates, then per candidate the reference-keyframe match (kernel
        B1 twice), PnP RANSAC (its samples from a generator seeded with the
        frame id, as the reference's `PRNGKey(frame_id)`), the pose solve,
        and below the accept threshold the 10 px and 3 px projection passes
        (B1 over all Pmax points). Without a keyframe database (no place
        recognition) it fails, as the reference's does. Its host reads are
        the reference's, one sync each on the card."""
        if self.kfdb is None:
            return False
        s = self.store.state
        f = cur.features
        covis = self.store.tensor(self.store.covisibility_np())
        cand_ids, _ = self.kfdb.query_frame(f.desc, f.valid, covis)
        rays = cam.unproject(self.model, self.params, f.uv)[:, :2]
        # The reference's nGood >= 50 (`Tracking.cc:3430`) scaled to the
        # feature budget, floored at 15.
        thr = max(15, int(round(50 * self.orb.n_features / 1000.0)))

        def solve(R, t, assoc):
            return _pose_opt_from_assoc(self.model, self.params, R, t, assoc, f, s.mp_pos,
                                        s.mp_valid, self.sigma2_table)

        def rescue(res, assoc, kf_mask, radius, max_dist):
            assoc = torch.where(res.inlier, assoc, torch.full_like(assoc, -1))
            assoc = _projection_rescue_match(self.model, self.params, res.R, res.t, s, kf_mask, f,
                                             assoc, self.img_wh_t, base_radius=radius,
                                             max_dist=max_dist, n_levels=self.orb.n_levels)
            return solve(res.R, res.t, assoc), assoc

        for c in cand_ids.cpu().numpy():
            if c < 0:
                continue
            c = int(c)
            assoc, n = _track_reference_kf(s.kf_desc[c], s.kf_feat_valid[c], s.kf_mp[c],
                                           s.mp_valid, f)
            if int(n) < 15:
                continue
            Xw = s.mp_pos[torch.clamp(assoc, min=0).to(torch.int64)]
            gen = torch.Generator(device=self.device).manual_seed(int(cur.frame_id))
            ok, R, t, _ = ransac.pnp_ransac(Xw, rays, (assoc >= 0) & f.valid,
                                            sigma_norm=1.0 / self.focal, generator=gen)
            if not bool(ok):
                continue
            res = solve(R, t, assoc)
            n_good = int(res.n_inliers)
            if n_good < thr:
                kf_mask = _local_point_mask(s, self.store.tensor(np.asarray([c], np.int32)))
                res, assoc = rescue(res, assoc, kf_mask, 10.0, float(matching.TH_HIGH))
                n_good = int(res.n_inliers)
                if thr * 0.6 <= n_good < thr:
                    res, assoc = rescue(res, assoc, kf_mask, 3.0, float(matching.TH_LOW))
                    n_good = int(res.n_inliers)
            if n_good >= thr:
                cur.R = res.R.cpu().numpy()
                cur.t = res.t.cpu().numpy()
                cur.mp_assoc = torch.where(res.inlier, assoc, -1).cpu().numpy()
                self.ref_kf = c
                return True
        return False

    def _need_new_keyframe(self, cur: fr.FrameData, n_inl: int, ref_matches: int) -> bool:
        """`NeedNewKeyFrame` for a visual tracker: the reloc gate; for
        stereo and RGB-D the close-point census (close: a depth under
        `_close_depth_cutoff`; fewer than 100 tracked close points and more
        than 70 untracked ones need a keyframe); the ratio to `ref_matches`,
        the reference keyframe's well-observed points (0.9 monocular, 0.75
        stereo-like, 0.4 while the map has < 2 keyframes, 0.75 always for a
        two-camera rig); the c1a/c1b frame
        gates and, for stereo-like sensors, c1c (a quarter of
        `ref_matches`, or the census). Monocular-inertial: a keyframe every
        0.25 s until the IMU is initialized; after it the ratio is 0.75 above
        350 inliers (else 0.9), c3 asks for a keyframe 0.5 s after the last
        and c4 on 15-75 inliers or out of RECENTLY_LOST. A busy mapper queues
        a stereo-like keyframe while fewer than 3 wait, and refuses a
        monocular one."""
        if self.ref_kf < 0:
            return False
        inertial = self.imu_calib is not None
        # Before IMU initialization: a fixed 4 Hz cadence feeds the
        # initializer (`Tracking.cc:2579-2588`).
        if inertial and not self.imu_ready:
            if self.last_kf_id < 0:
                return False
            return cur.timestamp - float(self.store.kf_ts[self.last_kf_id]) >= 0.25
        idle = self.mapper_idle_query is None or bool(self.mapper_idle_query())
        nkf = self.store.n_kf - len(self.store.free_kf_slots)
        if (cur.frame_id < self.last_reloc_frame_id + self.max_frames
                and nkf > self.max_frames):
            return False
        mono_like = not self.is_stereo_like
        need_close = False
        if not mono_like and cur.depth is not None:
            close = (cur.depth > 0) & (cur.depth < self._close_depth_cutoff())
            tracked_close = int(np.sum(close & (cur.mp_assoc >= 0)))
            untracked_close = int(np.sum(close & (cur.mp_assoc < 0)))
            need_close = tracked_close < 100 and untracked_close > 70
        th_ratio = 0.9 if mono_like and not inertial else 0.75
        if nkf < 2:
            th_ratio = 0.4
        if self.camera2 is not None:
            th_ratio = 0.75
        if inertial and mono_like:
            th_ratio = 0.75 if n_inl > 350 else 0.9
        c1a = cur.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = cur.frame_id >= self.last_kf_frame_id + self.min_frames and idle
        c1c = not mono_like and not inertial and (n_inl < ref_matches * 0.25 or need_close)
        c2 = ((n_inl < ref_matches * th_ratio) or need_close) and n_inl > 15
        # Inertial: a keyframe at least every 0.5 s (c3, `:2670-2683`), and on
        # weak mono-inertial tracking or out of RECENTLY_LOST (c4, `:2685-2689`).
        c3 = (inertial and self.imu_ready and self.last_kf_id >= 0
              and cur.timestamp - float(self.store.kf_ts[self.last_kf_id]) >= 0.5)
        c4 = inertial and mono_like and (15 < n_inl < 75
                                         or self.state == TrackState.RECENTLY_LOST)
        if not (((c1a or c1b or c1c) and c2) or c3 or c4):
            return False
        if idle:
            return True
        if not mono_like:
            q = 0 if self.mapping_queue_len is None else int(self.mapping_queue_len())
            return q < 3
        return False

    def _close_depth_cutoff(self) -> float:
        """ThDepth baselines, in metres (`Tracking.cc:1616, 2624`): the rig's
        baseline for a two-camera rig, else bf / fx."""
        if self.camera2 is not None:
            return self.th_depth * self.camera2["baseline"]
        return self.th_depth * (self.bf / self.focal)

    def _create_depth_points(self, cur: fr.FrameData, slot: int):
        """Stereo and RGB-D points at a new keyframe (`CreateNewKeyFrame`,
        `Tracking.cc:2756-2830`): of the keypoints with a depth and no map
        point, nearest first, every close one, and at least 100 whatever
        their depth, as far as free point slots allow. Each becomes a point
        at its back-projection through the frame's pose, associated in the
        keyframe's row (at those keypoints only) and in the frame."""
        depth = cur.depth
        f = cur.features
        cand = np.flatnonzero(f.valid.cpu().numpy() & (depth > 0) & (cur.mp_assoc < 0))
        if len(cand) == 0:
            return
        order = cand[np.argsort(depth[cand])]
        n_close = int(np.searchsorted(depth[order], self._close_depth_cutoff()))
        sel = order[:max(n_close, min(100, len(order)))]
        free = int((~self.store.state.mp_valid).sum()) - 1  # the dump slot is not free
        if free < len(sel):  # the capacity guard: the nearest first
            sel = sel[:max(free, 0)]
        if len(sel) == 0:
            return
        T = self.store.tensor
        rays = cam.unproject(self.model, self.params, f.uv[T(sel)]).cpu().numpy()
        Xw = (rays * depth[sel][:, None] - cur.t) @ cur.R  # X_w = R^T (X_c - t)
        centre = -cur.R.T @ cur.t
        dist = np.linalg.norm(Xw - centre, axis=-1)
        normal = (Xw - centre) / np.maximum(dist[:, None], 1e-9)
        sf = self.scale_np
        max_d = dist * sf[np.clip(f.octave.cpu().numpy()[sel], 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        slots = self.store.alloc_mps(len(sel))
        s = st.add_points(self.store.state, T(slots), T(Xw.astype(np.float32)), f.desc[T(sel)],
                          T(normal.astype(np.float32)), T(min_d.astype(np.float32)),
                          T(max_d.astype(np.float32)), T(np.full(len(sel), slot, np.int32)),
                          T(np.ones(len(sel), bool)))
        kf_mp = s.kf_mp.clone()
        kf_mp[slot, T(sel)] = T(slots.astype(np.int32))
        self.store.state = s._replace(kf_mp=kf_mp)
        cur.mp_assoc = cur.mp_assoc.copy()
        cur.mp_assoc[sel] = slots

    def _create_keyframe(self, cur: fr.FrameData):
        """`CreateNewKeyFrame`: insert the frame as a keyframe (with its `ur`
        row; for stereo and RGB-D, its depth points), then run its mapping
        pass (the reference's `_create_keyframe_impl`)."""
        slot = self.store.alloc_kf()
        T = self.store.tensor
        f = cur.features
        ur = (T(cur.ur.astype(np.float32)) if cur.ur is not None
              else torch.full((f.n,), -1.0, device=self.device))
        imu = T(np.concatenate([self.body_vel, self.bias_g, self.bias_a]).astype(np.float32))
        self.store.state = st.add_keyframe(
            self.store.state, slot, T(cur.R.astype(np.float32)), T(cur.t.astype(np.float32)),
            f.uv, ur, f.octave, f.angle, f.desc, f.valid, T(cur.mp_assoc.astype(np.int32)),
            vel=imu[0:3], bias_g=imu[3:6], bias_a=imu[6:9], prev_kf=self.last_kf_id,
        )
        self.store.kf_ts[slot] = cur.timestamp
        if self.is_stereo_like and cur.depth is not None:
            self._create_depth_points(cur, slot)
        self.store.bump()
        self.ref_kf = slot
        self.last_kf_id = slot
        self.last_kf_frame_id = cur.frame_id
        preint, self.pre_from_kf = self.pre_from_kf, None
        self._map_transformed = False
        if self.new_kf_callback is not None and (
                self.new_kf_callback(slot, initial=False, preint=preint)
                or self._map_transformed):
            # A loop correction (fault C12) or the IMU initialization's
            # gravity and scale alignment (fault C13) moved the map under
            # this frame: the frame takes its keyframe's pose, as ORB-SLAM3's
            # UpdateLastFrame / UpdateFrameIMU give it to the next frame.
            cur.R = self.store.state.kf_R[slot].cpu().numpy()
            cur.t = self.store.state.kf_t[slot].cpu().numpy()
        # The mapping pass may have fused points into this keyframe.
        cur.mp_assoc = self.store.state.kf_mp[slot].cpu().numpy()
        if self.imu_calib is not None and self.imu_ready:
            # Mapping may have (re-)initialized the IMU or moved the keyframe's
            # state: the next frames start from it.
            s = self.store.state
            b = fetch_bundle(dict(bg=s.kf_bias_g[slot], ba=s.kf_bias_a[slot], v=s.kf_vel[slot]))
            self.bias_g, self.bias_a, self.body_vel = b["bg"], b["ba"], b["v"]
