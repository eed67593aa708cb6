"""The per-keyframe mapping pass on torch tensors — the port of the device
programs of `orbslam3_tpu/pipeline/local_mapping.py` that one pass runs:
two-view triangulation against the covisible neighbours
(`triangulate_pair`, `triangulate_batch`), the fuse of candidate points
into the neighbours (`fuse_into_kf`, `_fuse_batch`, kernel B1 through
`search_by_projection`) and the dense-Schur local BA (`local_ba`).

The reference's `vmap`s over the neighbour axis are Python loops here, with
the results stacked. Every index the reference takes with `jnp.nonzero(size=)`
or a 0-d device index is taken with a stable sort or `index_select`, so the
pass reads nothing back to the host.

Scatters with duplicate indices (fault C6): `fuse_into_kf`'s `present`
flags and row write, and `local_ba`'s write-back and outlier erase, write
only the rows whose mask is true (`atlas/store.py::scatter_rows`, `flag`).
The reference writes the old value back through every other row, whose
clipped index can collide with a real one: with the fixed list padded by -1,
its `local_ba` never erases an outlier observation of keyframe 0.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import lie, matching
from orbslam3_tpu_torch.optim import ba as ba_mod
from orbslam3_tpu_torch.optim import lm
from orbslam3_tpu_torch.pipeline import frame as fr

# The reference's defaults (its environment overrides are not ported).
WINDOW = 48  # optimizable keyframes of the local BA
FIXED = 128  # fixed frontier keyframes
OBS_CAP = 768  # observation slots per camera after validity compaction
LBA_TOL = 1e-3  # relative cost decrease that stops the LM loop
POINT_CAP = 8192  # compacted window points


def lba_caps(Kmax: int):
    """(window, fixed) clamped to the store capacity."""
    return min(WINDOW, int(Kmax)), min(FIXED, int(Kmax))


def _clip_idx(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.clamp(x, 0, n - 1).to(torch.int64)


# ---------------------------------------------------------------------------
# Triangulation of new map points
# ---------------------------------------------------------------------------


def triangulate_pair(model, params, R1, t1, R2, t2, uv1, oct1, desc1, free1,
                     uv2, oct2, desc2, free2, sigma2_table, scale_table, focal: float):
    """One keyframe pair: epipolar-masked cross-checked Hamming match of the
    free features (dense, as in the reference), DLT triangulation by 3x3
    normal equations, then the cheirality, parallax, reprojection and
    scale gates. Returns (Xw (N,3), good (N,), match_idx2 (N,)) indexed by
    keyframe 1's feature."""
    L = sigma2_table.shape[0]
    rays1 = cam.unproject(model, params, uv1)  # (N,3), z = 1
    rays2 = cam.unproject(model, params, uv2)
    R1i, t1i = lie.se3_inv(R1, t1)
    R21, t21 = lie.se3_compose(R2, t2, R1i, t1i)
    E21 = lie.hat(t21) @ R21

    # Epipolar line distance in normalized coordinates, 3.84 sigma^2 gate.
    l2 = rays1 @ E21.T  # (N1,3)
    num = (l2 @ rays2.T) ** 2  # (N1,N2)
    den = (l2[:, None, 0] ** 2 + l2[:, None, 1] ** 2) + 1e-12
    s2_kp2 = sigma2_table[_clip_idx(oct2, L)]
    epi_ok = num / den < (3.84 / (focal * focal)) * s2_kp2[None, :]

    m = matching.match_nn(desc1, desc2, free1, free2, max_dist=matching.TH_LOW, ratio=0.8,
                          cross_check=True, extra_mask=epi_ok)
    idx2 = torch.clamp(m.idx, min=0).to(torch.int64)

    # World-frame DLT rows of both cameras; w = 1 and the 4x3 least squares
    # solved through its normal equations (the reference's default branch).
    P1 = torch.cat([R1, t1[:, None]], dim=1)  # (3,4)
    P2 = torch.cat([R2, t2[:, None]], dim=1)
    p1n = rays1[:, :2]
    p2n = rays2[idx2][:, :2]

    def rows(P, p):
        return torch.stack([p[..., 0:1] * P[2] - P[0], p[..., 1:2] * P[2] - P[1]], dim=-2)

    A = torch.cat([rows(P1, p1n), rows(P2, p2n)], dim=-2)  # (N,4,4)
    A3 = A[..., :3]
    a4 = A[..., 3]
    N3 = A3.transpose(1, 2) @ A3
    brhs = -torch.einsum("nki,nk->ni", A3, a4)
    Xw = torch.einsum("nij,nj->ni", lm.inv3x3(N3), brhs)

    Xc1 = lie.se3_apply(R1, t1, Xw)
    Xc2 = lie.se3_apply(R2, t2, Xw)
    O1 = -R1.T @ t1
    O2 = -R2.T @ t2
    r1w = Xw - O1[None]
    r2w = Xw - O2[None]
    n1 = torch.linalg.norm(r1w, dim=-1)
    n2 = torch.linalg.norm(r2w, dim=-1)
    cosp = torch.sum(r1w * r2w, -1) / (n1 * n2 + 1e-12)
    uv1_hat = cam.project(model, params, Xc1)
    uv2_hat = cam.project(model, params, Xc2)
    e1 = torch.sum((uv1_hat - uv1) ** 2, -1) / sigma2_table[_clip_idx(oct1, L)]
    e2 = torch.sum((uv2_hat - uv2[idx2]) ** 2, -1) / s2_kp2[idx2]
    # Scale consistency (ratioFactor = 1.5 * scaleFactor).
    ratio_dist = n2 / torch.clamp(n1, min=1e-9)
    Ls = scale_table.shape[0]
    ratio_oct = scale_table[_clip_idx(oct1, Ls)] / scale_table[_clip_idx(oct2[idx2], Ls)]
    rf = 1.5 * 1.2
    scale_ok = (ratio_dist * rf > ratio_oct) & (ratio_dist < ratio_oct * rf)

    good = (
        m.valid
        & (Xc1[..., 2] > 1e-3)
        & (Xc2[..., 2] > 1e-3)
        & (cosp < 0.9998)
        & (cosp > 0)
        & (e1 < lm.CHI2_MONO)
        & (e2 < lm.CHI2_MONO)
        & scale_ok
        & torch.all(torch.isfinite(Xw), dim=-1)
    )
    return Xw, good, m.idx


def triangulate_batch(model, params, R1, t1, uv1, oct1, desc1, free1,
                      R2s, t2s, uv2s, oct2s, desc2s, free2s, sigma2_table, scale_table,
                      focal: float):
    """`triangulate_pair` of the current keyframe against each stacked
    neighbour (leading axis B). Returns (Xw (B,N,3), good (B,N), idx (B,N))."""
    outs = [triangulate_pair(model, params, R1, t1, R2s[b], t2s[b], uv1, oct1, desc1, free1,
                             uv2s[b], oct2s[b], desc2s[b], free2s[b], sigma2_table,
                             scale_table, focal)
            for b in range(R2s.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


# ---------------------------------------------------------------------------
# Fuse (SearchInNeighbors)
# ---------------------------------------------------------------------------


def fuse_into_kf(model, params, state: st.MapState, kf_id: torch.Tensor, cand_ids,
                 cand_valid, img_wh, sigma2_table, n_levels: int = 8):
    """Project candidate points into keyframe `kf_id` (0-d device tensor)
    and match them into its keypoints (kernel B1, windowed). Where the
    matched keypoint is free the association is added; where it holds a
    different point, the (candidate, incumbent) conflict is reported.
    Returns (new kf_mp row, n added, conflict incumbents (M,), conflict (M,))."""
    R = st.row(state.kf_R, kf_id)
    t = st.row(state.kf_t, kf_id)
    row = st.row(state.kf_mp, kf_id)
    kf_uv = st.row(state.kf_uv, kf_id)
    kf_oct = st.row(state.kf_octave, kf_id)
    ids = torch.clamp(cand_ids, min=0).to(torch.int64)
    # Skip candidates this keyframe already observes.
    present = st.flag(state.Pmax, torch.clamp(row, min=0), row >= 0)
    cand_valid = cand_valid & ~present[ids]
    uv, visible, lvl, _ = fr.frustum_and_scale(
        model, params, R, t, state.mp_pos[ids], cand_valid & state.mp_valid[ids],
        state.mp_normal[ids], state.mp_min_dist[ids], state.mp_max_dist[ids], img_wh,
        n_levels=n_levels,
    )
    r = 3.0 * 1.2 ** lvl.to(torch.float32)
    m = matching.search_by_projection(
        state.mp_desc[ids], uv, visible, st.row(state.kf_desc, kf_id), kf_uv,
        st.row(state.kf_feat_valid, kf_id), radius=r, octave_kp=kf_oct,
        octave_lo=torch.clamp(lvl - 1, min=0), octave_hi=lvl,
        max_dist=matching.TH_LOW, ratio=1.0,
    )
    m = matching.assign_unique(m, state.Nf)
    tgt = torch.clamp(m.idx, min=0).to(torch.int64)
    # The projection must land within 5.99 sigma^2 of the matched keypoint,
    # at the keypoint's octave.
    s2_kp = sigma2_table[_clip_idx(kf_oct[tgt], sigma2_table.shape[0])]
    e2 = torch.sum((uv - kf_uv[tgt]) ** 2, dim=-1)
    m_ok = m.valid & (e2 <= 5.99 * s2_kp)
    incumbent = row[tgt]
    write = m_ok & (incumbent < 0)
    new_row = st.scatter_rows(row, tgt, write, ids)
    conflict = m_ok & (incumbent >= 0) & (incumbent != ids)
    conflict &= state.mp_valid[torch.clamp(incumbent, min=0).to(torch.int64)]
    return new_row, write.to(torch.int32).sum().to(torch.int32), incumbent, conflict


def _fuse_batch(model, params, state, nb_ids, cand_ids, cand_valid, img_wh, sigma2_table,
                n_levels: int = 8):
    """`fuse_into_kf` into each neighbour of `nb_ids` (one B1 launch each),
    results stacked along a leading neighbour axis."""
    outs = [fuse_into_kf(model, params, state, nb_ids[b], cand_ids, cand_valid, img_wh,
                         sigma2_table, n_levels=n_levels)
            for b in range(nb_ids.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


# ---------------------------------------------------------------------------
# Local BA assembly
# ---------------------------------------------------------------------------


def _first_true(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """The indices of the True entries in increasing order, cut or padded
    with `fill` to `size` — `jnp.nonzero(mask, size=, fill_value=)` without
    a host read."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)[:size]
    n = mask.to(torch.int64).sum()
    slot = torch.arange(size, device=mask.device)
    return torch.where(slot < n, order, fill)


def local_ba(model, params, state: st.MapState, window_ids, fixed_ids, sigma2_table,
             iters: int = 8):
    """Assemble and solve the local BA (`Optimizer::LocalBundleAdjustment`):
    the window keyframes are optimized, the fixed ones anchor; observations
    are every feature of both sets whose point the window sees, compacted
    per camera to `OBS_CAP` slots (valid first, in slot order), and the
    point axis is compacted to the window's points. Writes back the window
    poses and points and erases the outlier observations. Returns
    (new state, cost, number of erased observations)."""
    dev = state.kf_R.device
    W = window_ids.shape[0]
    all_ids = torch.cat([window_ids, fixed_ids])
    C = all_ids.shape[0]
    ok_kf = all_ids >= 0
    ids = torch.clamp(all_ids, min=0).to(torch.int64)
    cam_fixed = (torch.arange(C, device=dev) >= W) | ~ok_kf

    # Points seen from the window.
    win_mp = state.kf_mp[torch.clamp(window_ids, min=0).to(torch.int64)]
    wok = (win_mp >= 0) & (window_ids >= 0)[:, None]
    win_mask = st.flag(state.Pmax, torch.clamp(win_mp, min=0).reshape(-1),
                       wok.reshape(-1)) & state.mp_valid

    Nf = state.Nf
    cap = min(OBS_CAP, Nf)
    kf_mp_w = state.kf_mp[ids]  # (C,Nf)
    valid_w = ((kf_mp_w >= 0) & state.kf_feat_valid[ids] & ok_kf[:, None]
               & win_mask[torch.clamp(kf_mp_w, min=0).to(torch.int64)])
    order = torch.argsort((~valid_w).to(torch.uint8), dim=1, stable=True)[:, :cap]  # (C,cap)
    crow = torch.arange(C, device=dev)[:, None]
    obs_mp = kf_mp_w[crow, order].reshape(-1)
    obs_cam = torch.arange(C, dtype=torch.int32, device=dev)[:, None].expand(C, cap).reshape(-1)
    obs_uv = state.kf_uv[ids][crow, order].reshape(-1, 2)
    obs_ur = state.kf_ur[ids][crow, order].reshape(-1)
    obs_oct = state.kf_octave[ids][crow, order].reshape(-1)
    obs_valid = valid_w[crow, order].reshape(-1)
    obs_s2 = sigma2_table[_clip_idx(obs_oct, sigma2_table.shape[0])]

    # Compact the point axis to the window's points (fixed cap).
    Pmax = state.Pmax
    CAP = min(POINT_CAP, Pmax)
    sel = _first_true(win_mask, CAP, Pmax)
    sel_ok = sel < Pmax
    sel_c = torch.clamp(sel, max=Pmax - 1)
    inv = st.scatter_rows(torch.full((Pmax,), CAP, dtype=torch.int64, device=dev), sel_c,
                          sel_ok, torch.arange(CAP, device=dev))
    sel_of = inv[torch.clamp(obs_mp, min=0).to(torch.int64)]
    obs_valid = obs_valid & (sel_of < CAP)

    prob = ba_mod.BAProblem(
        cam_R=state.kf_R[ids], cam_t=state.kf_t[ids], cam_fixed=cam_fixed,
        points=state.mp_pos[sel_c], point_valid=sel_ok,
        obs_cam=obs_cam, obs_point=torch.clamp(sel_of, max=CAP - 1), obs_uv=obs_uv,
        obs_ur=obs_ur, obs_sigma2=obs_s2, obs_valid=obs_valid,
    )
    res = ba_mod.solve_ba(model, params, prob, iters=iters, dense_schur=True,
                          n_opt_prefix=W, obs_per_cam=cap, early_stop_tol=LBA_TOL)

    new_state = st.update_poses_points(
        state, torch.clamp(window_ids, min=0), res.cam_R[:W], res.cam_t[:W], window_ids >= 0,
        sel_c, res.points, sel_ok,
    )
    # Erase the outlier observations, at the bad rows only (C6).
    bad_obs = obs_valid & ~res.obs_inlier
    flat = ids[:, None] * Nf + order  # (C,cap) index into kf_mp.reshape(-1)
    kf_mp = st.scatter_rows(new_state.kf_mp.reshape(-1), flat.reshape(-1), bad_obs,
                            torch.full_like(obs_mp, -1)).reshape(new_state.kf_mp.shape)
    return (new_state._replace(kf_mp=kf_mp), res.cost,
            bad_obs.to(torch.int32).sum().to(torch.int32))
