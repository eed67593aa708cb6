"""Per-frame tracking on torch tensors — the port of the device programs of
`orbslam3_tpu/pipeline/tracking.py` that one tracked frame runs:
`_track_last_frame` (motion model), `_track_reference_kf` (fallback),
`_local_point_mask`, `_track_local_map_match`, `_pose_opt_from_assoc`,
`compute_obs_count` and `_track_step`, which chains them.

Scatters with duplicate indices (fault C6). The reference writes
``assoc.at[clip(idx, 0)].set(where(valid, q, assoc[clip(idx, 0)]))``: every
invalid row clips to index 0 and writes the old value back. The port
scatters the valid rows only (`atlas/store.py::scatter_rows`, `flag`), so
the results equal the reference's everywhere except, at most, at index 0.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import lie, matching
from orbslam3_tpu_torch.optim import pose_only
from orbslam3_tpu_torch.pipeline import frame as fr

N_LOCAL_KFS = 16  # local keyframes selected per frame (device top-k)


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

    bundle = dict(
        ok1=ok1, used_a=use_a, n_a=n_a, n_b=n_b,
        R=res2.R, t=res2.t, assoc=assoc_final,
        n_inl=res2.n_inliers, top_kfs=top_kfs, ref_matches=ref_matches,
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
