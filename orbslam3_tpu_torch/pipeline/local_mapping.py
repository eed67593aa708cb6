"""The per-keyframe mapping pass on torch tensors — the port of
`orbslam3_tpu/pipeline/local_mapping.py` (its synchronous form):
the device programs of one pass (two-view triangulation against the
covisible neighbours, `triangulate_pair`, `triangulate_batch`; the fuse of
candidate points into keyframes, `fuse_into_kf`, `_fuse_batch`, kernel B1
through `search_by_projection`; the dense-Schur local BA, `local_ba`), the
fuse conflict resolution `resolve_and_replace`, and the host-side loop
`LocalMapper` (point culling -> triangulation -> two-way fuse -> descriptor
and normal refresh -> local BA -> keyframe culling; the initial map's BA;
for a monocular-inertial map the IMU initialization, the local inertial BA
that replaces the local BA after it, VIBA1, VIBA2 and the scale
refinement, and the bad-IMU watchdog).

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

import numpy as np
import torch

from orbslam3_tpu_torch import convert, spans
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.ops import lie, matching
from orbslam3_tpu_torch.optim import ba as ba_mod
from orbslam3_tpu_torch.optim import inertial as vi
from orbslam3_tpu_torch.optim import lm
from orbslam3_tpu_torch.pipeline import frame as fr
from orbslam3_tpu_torch.pipeline import inertial_support as isup

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
             bf: float = 0.0, iters: int = 8, obs_cap: int | None = None):
    """Assemble and solve the local BA (`Optimizer::LocalBundleAdjustment`):
    the window keyframes are optimized, the fixed ones anchor; observations
    are every feature of both sets whose point the window sees, compacted
    per camera to `obs_cap` slots (valid first, in slot order; `OBS_CAP`
    when None, at most Nf), and the point axis is compacted to the window's
    points. An observation with a right u (`kf_ur` >= 0) adds the stereo
    row u_r = u - bf / z. Writes back the window poses and points and erases
    the outlier observations. Returns (new state, cost, number of erased
    observations).

    Stereo and RGB-D callers pass `obs_cap=Nf` and keep every observation:
    their rows carry the metric constraints (the reference's A/B on its
    600-frame stereo replay: dropping the tail doubled the ATE)."""
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
    cap = min(OBS_CAP if obs_cap is None else obs_cap, Nf)
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
    res = ba_mod.solve_ba(model, params, prob, bf=bf, iters=iters, dense_schur=True,
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


# ---------------------------------------------------------------------------
# Host-side LocalMapper
# ---------------------------------------------------------------------------


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def resolve_and_replace(store: st.MapStore, conflicts_src, conflicts_dst, anchor_kf: int):
    """Resolve fuse conflicts with `MapPoint::Replace` semantics: of each
    (candidate, incumbent) pair whose positions agree within 0.2 of the
    depth from `anchor_kf`, the point with more observers survives
    (`ORBmatcher::Fuse`). Chains (a -> b, c -> a) land on their end; cycles
    are left alone. Returns the freed (replaced) slots, which the caller
    purges from its slot-keyed bookkeeping."""
    a = np.concatenate(conflicts_src).astype(np.int64)
    b = np.concatenate(conflicts_dst).astype(np.int64)
    s = store.state
    pos = _np(s.mp_pos)
    Rk, tk = _np(s.kf_R[anchor_kf]), _np(s.kf_t[anchor_kf])
    Ow = -Rk.T @ tk
    depth = np.linalg.norm(pos[b] - Ow, axis=1)
    gap = np.linalg.norm(pos[a] - pos[b], axis=1)
    sane = gap <= 0.2 * np.maximum(depth, 1e-6)
    a, b = a[sane], b[sane]
    obs = store.point_observers_np()
    keep_b = obs[b] >= obs[a]
    src0 = np.where(keep_b, a, b)
    dst0 = np.where(keep_b, b, a)
    src0, uniq = np.unique(src0, return_index=True)
    mapping = dict(zip(src0.tolist(), dst0[uniq].tolist()))
    pairs = []
    for s_, d_ in mapping.items():
        seen = {s_}
        while d_ in mapping and d_ not in seen:
            seen.add(d_)
            d_ = mapping[d_]
        if d_ in seen:  # a cycle
            continue
        pairs.append((s_, d_))
    if not pairs:
        return []
    src = np.asarray([p[0] for p in pairs], np.int64)
    dst = np.asarray([p[1] for p in pairs], np.int64)
    CAP = 1024
    for start in range(0, len(src), CAP):
        cs = src[start : start + CAP]
        cd = dst[start : start + CAP]
        pad = CAP - len(cs)
        store.state = st.replace_points(
            store.state,
            store.tensor(np.concatenate([cs, np.full(pad, -1)]).astype(np.int32)),
            store.tensor(np.concatenate([cd, np.full(pad, -1)]).astype(np.int32)),
            store.tensor(np.arange(CAP) < len(cs)),
        )
    freed = [int(x) for x in src]
    store.free_mp_slots.extend(freed)
    store.bump()  # the host mirrors are stale
    return freed


class LocalMapper:
    """Synchronous local mapping: one pass per keyframe insertion
    (`LocalMapping::Run`). With a baseline (`bf` > 0, stereo and RGB-D) the
    local BA adds the stereo rows and keeps every observation
    (`stereo_like`). With `imu_calib` (monocular-inertial) the mapper keeps
    each keyframe's preintegration from its previous one (`preints`), tries
    the IMU initialization after each pass until it succeeds (`imu_init`),
    then runs the local inertial BA in place of the local BA and stages
    VIBA1, VIBA2 and the scale refinement; before it, the bad-IMU watchdog
    (`bad_imu`). `pipeline/async_mapping.AsyncMapper` runs the same pass
    sliced, one of `STAGES` per tracked frame; under its interrupt
    (`interrupt_ba`) the pass skips the local BA."""

    NB_BATCH = 10  # covisible neighbours of triangulation and fuse

    def __init__(self, model, params: torch.Tensor, img_wh, store: st.MapStore,
                 orb_params: feat.OrbParams = feat.OrbParams(), bf: float = 0.0,
                 imu_calib: imu_ops.ImuCalib | None = None, mono: bool = True):
        self.model = model
        self.params = params
        self.bf = bf
        self.stereo_like = bf > 0  # set by System for the sensor
        self.device = params.device
        self.img_wh = convert.tensor(np.asarray(img_wh, np.float32), self.device)
        self.store = store
        self.sigma2_table = convert.tensor(feat.sigma2(orb_params), self.device)
        self.scale_table = convert.tensor(feat.scale_factors(orb_params), self.device)
        self.scale_np = feat.scale_factors(orb_params)
        self.focal = float(params[0])
        self.recent_mp: list[tuple[int, np.ndarray]] = []  # (birth_kf, slots)
        self.tracker = None  # set by System: trajectory re-rooting on culls
        self._covis_pin = None
        self.interrupt_ba = False  # set by AsyncMapper.interrupt
        # IMU: per-keyframe preintegration from its previous keyframe, and
        # the initialization staging.
        self.imu_calib = imu_calib
        self.preints: dict = {}
        self.imu_init = isup.ImuInitializer(imu_calib, mono=mono) if imu_calib is not None else None
        self.bad_imu = False  # watchdog flag (ref mbBadImu, LocalMapping.cc:192)
        self._last_scale_ref_ts = -1e18
        # IMU stages completed (the initialization, VIBA1, VIBA2, an applied
        # scale refinement): `System._tick_gba` hands the tracker the new state
        # after a tick that completed one.
        self.n_imu_stages = 0
        if imu_calib is not None:
            self.Rbc = imu_calib.Rbc.cpu().numpy()
            self.tbc = imu_calib.tbc.cpu().numpy()

    @property
    def imu_initialized(self) -> bool:
        return self.imu_init is not None and self.imu_init.initialized

    def process_keyframe(self, kf_id: int, initial: bool = False, preint=None):
        """One whole mapping pass for keyframe `kf_id` (with `preint`, its
        preintegration from the previous keyframe); for the initial map,
        its BA and normalization instead."""
        if preint is not None:
            self.preints[kf_id] = preint
        if initial:
            self._global_ba_small(kf_id)
            return
        for stage in self.STAGES:
            stage(self, kf_id)

    # -- the pass's stages (in `LocalMapping::Run` order) ---------------
    def stage_prepare(self, kf_id: int):
        # One covisibility snapshot for the whole pass (UpdateConnections
        # once per keyframe, as the reference).
        self._covis_pin = (kf_id, self.store.covisibility_np())
        with spans.span("mapping/cull_points"):
            self._cull_points(kf_id)

    def stage_triangulate(self, kf_id: int):
        with spans.span("mapping/triangulate"):
            self._create_new_points(kf_id)

    def stage_fuse(self, kf_id: int):
        with spans.span("mapping/fuse"):
            self._fuse_neighbors(kf_id)

    def stage_ba(self, kf_id: int):
        if self.interrupt_ba:
            # `LocalMapping::InterruptBA`: tracking wants a keyframe in now,
            # so this pass skips its local BA.
            return
        with spans.span("mapping/local_ba"):
            if self.imu_initialized:
                with spans.span("local inertial BA"):
                    self._local_inertial_ba(kf_id)
            else:
                self._local_ba(kf_id)

    def stage_maintain(self, kf_id: int):
        with spans.span("mapping/cull_keyframes"):
            self._cull_keyframes(kf_id)
        if self.imu_init is not None and not self.imu_init.initialized:
            self._try_imu_init(kf_id)
            if not self.imu_init.initialized:
                self._imu_watchdog(kf_id)
        elif self.imu_init is not None:
            self._viba_staging(kf_id)

    STAGES = (stage_prepare, stage_triangulate, stage_fuse, stage_ba, stage_maintain)

    # ------------------------------------------------------------------
    def _covis_matrix(self, kf_id: int) -> np.ndarray:
        pin = self._covis_pin
        return pin[1] if pin and pin[0] == kf_id else self.store.covisibility_np()

    def _covisible(self, kf_id: int, n: int) -> np.ndarray:
        """The n best covisible keyframes with weight >= 15 (any weight > 0
        when none has 15)."""
        weights = self._covis_matrix(kf_id)[kf_id][: self.store.n_kf]
        order = np.argsort(-weights)
        top = order[weights[order] >= 15][:n]  # ref th=15 (KeyFrame.cc:469)
        if len(top) == 0:
            top = order[weights[order] > 0][:n]
        return top.astype(np.int32)

    def _create_new_points(self, kf_id: int):
        """`CreateNewMapPoints`: triangulate against the best covisible
        keyframes (one B1-free dense match per pair), each current feature
        with its best-connected neighbour only, then one point insert and
        one association write. Only the real neighbours run: the reference's
        padding lanes have no free features and add nothing."""
        s = self.store.state
        neighbors = self._covisible(kf_id, self.NB_BATCH)
        if len(neighbors) == 0 and self.store.n_kf >= 2:
            neighbors = np.asarray([kf_id - 1], np.int32)
        if len(neighbors) == 0:
            self.store.bump()
            return
        nb = neighbors[: self.NB_BATCH]
        nb_t = self.store.tensor(nb.astype(np.int64))
        free_cur = (s.kf_mp[kf_id] < 0) & s.kf_feat_valid[kf_id]
        free_nbs = (s.kf_mp[nb_t] < 0) & s.kf_feat_valid[nb_t]
        Xw_b, good_b, idx2_b = triangulate_batch(
            self.model, self.params, s.kf_R[kf_id], s.kf_t[kf_id], s.kf_uv[kf_id],
            s.kf_octave[kf_id], s.kf_desc[kf_id], free_cur,
            s.kf_R[nb_t], s.kf_t[nb_t], s.kf_uv[nb_t], s.kf_octave[nb_t], s.kf_desc[nb_t],
            free_nbs, self.sigma2_table, self.scale_table, self.focal,
        )
        good_b, Xw_b, idx2_b = _np(good_b), _np(Xw_b), _np(idx2_b)
        R_row, t_row, oct_row = _np(s.kf_R[kf_id]), _np(s.kf_t[kf_id]), _np(s.kf_octave[kf_id])

        claimed = np.zeros(s.Nf, bool)
        picks = []
        for b in range(len(nb)):
            sel = np.flatnonzero(good_b[b] & ~claimed)
            if len(sel) == 0:
                continue
            claimed[sel] = True
            picks.append((b, sel))
        if not picks:
            self.store.bump()
            return
        sel_all = np.concatenate([sel for _, sel in picks])
        b_all = np.concatenate([np.full(len(sel), b, np.int64) for b, sel in picks])
        total = len(sel_all)
        slots = self.store.alloc_mps(total)

        Xw_np = Xw_b[b_all, sel_all]
        Ow = -R_row.T @ t_row
        vec = Xw_np - Ow
        dist = np.linalg.norm(vec, axis=-1)
        normal = vec / np.maximum(dist[:, None], 1e-9)
        sf = self.scale_np
        max_d = dist * sf[np.clip(oct_row[sel_all], 0, len(sf) - 1)]
        min_d = max_d / sf[-1]
        T = self.store.tensor
        new_state = st.add_points(
            s, T(slots), T(Xw_np.astype(np.float32)), s.kf_desc[kf_id][T(sel_all)],
            T(normal.astype(np.float32)), T(min_d.astype(np.float32)),
            T(max_d.astype(np.float32)), T(np.full(total, kf_id, np.int32)),
            T(np.ones(total, bool)),
        )

        # Associations: the current keyframe's row and the neighbours' rows.
        kf_mp = _np(new_state.kf_mp)
        kf_mp[kf_id, sel_all] = slots
        off = 0
        for b, sel in picks:
            kf_mp[nb[b], idx2_b[b, sel]] = slots[off : off + len(sel)]
            off += len(sel)
        rows = np.concatenate([[kf_id], nb]).astype(np.int64)
        new_kf_mp = new_state.kf_mp.clone()
        new_kf_mp[T(rows)] = T(kf_mp[rows])
        self.store.state = new_state._replace(kf_mp=new_kf_mp)
        self.recent_mp.append((kf_id, slots))
        self.store.bump()

    def purge_freed(self, freed):
        """Drop freed (soon reallocated) slots from the pending culling
        batches, or their new tenants would be judged by the old point's
        birth and culled at birth."""
        if not freed:
            return
        freed = list(freed)
        self.recent_mp = [(b, s[~np.isin(s, freed)]) for b, s in self.recent_mp]

    def _fuse_neighbors(self, kf_id: int):
        """`SearchInNeighbors`, both ways: the current keyframe's points into
        each 1-hop neighbour (one B1 launch each), then the points of the
        1- and 2-hop neighbourhood into the current keyframe (B1 on chunks
        of 4096 candidates). Conflicts are resolved by observer count
        (`resolve_and_replace`); then the points of the current keyframe get
        fresh descriptors and normals. Both directions predict the scale
        over `fuse_into_kf`'s default 8 levels, whatever the pyramid, as the
        reference does (ROADMAP C8)."""
        neighbors = self._covisible(kf_id, self.NB_BATCH)
        Wmat = self._covis_matrix(kf_id)
        nkf = self.store.n_kf
        hood = set(int(n) for n in neighbors)
        for nb in list(hood):  # 2-hop: 5 best covisibles of each neighbour
            w = Wmat[nb][:nkf]
            second = np.argsort(-w)[:5]
            hood.update(int(x) for x in second[w[second] >= 15] if int(x) != kf_id)
        hood.discard(kf_id)

        conflicts_src: list[np.ndarray] = []
        conflicts_dst: list[np.ndarray] = []

        def collect(cand_np, inc, conf):
            if conf.any():
                conflicts_src.append(cand_np[conf])
                conflicts_dst.append(inc[conf])

        T = self.store.tensor
        cand = self.store.kf_mp_np()[kf_id]
        cand_pos = np.where(cand >= 0, cand, 0)
        if len(neighbors):
            nb = neighbors[: self.NB_BATCH]
            rows_b, _, inc_b, conf_b = _fuse_batch(
                self.model, self.params, self.store.state, T(nb.astype(np.int64)),
                T(cand_pos), T(cand >= 0), self.img_wh, self.sigma2_table)
            kf_mp = self.store.state.kf_mp.clone()
            kf_mp[T(nb.astype(np.int64))] = rows_b
            self.store.state = self.store.state._replace(kf_mp=kf_mp)
            inc_b, conf_b = _np(inc_b), _np(conf_b)
            for b in range(len(nb)):
                collect(cand_pos, inc_b[b], conf_b[b])

        if hood:
            kf_mp_np = self.store.kf_mp_np()
            pool = np.unique(kf_mp_np[sorted(hood)].reshape(-1))
            pool = pool[pool >= 0]
            CAP = 4096
            kf_j = torch.tensor(kf_id, device=self.device)
            pending = []
            for start in range(0, len(pool), CAP):
                chunk = pool[start : start + CAP]
                pad = CAP - len(chunk)
                ids = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
                new_row, _, inc, conf = fuse_into_kf(
                    self.model, self.params, self.store.state, kf_j, T(ids.astype(np.int32)),
                    T(np.arange(CAP) < len(chunk)), self.img_wh, self.sigma2_table)
                kf_mp = self.store.state.kf_mp.clone()
                kf_mp[kf_id] = new_row
                self.store.state = self.store.state._replace(kf_mp=kf_mp)
                pending.append((ids.astype(np.int64), inc, conf))
            for ids64, inc, conf in pending:
                collect(ids64, _np(inc), _np(conf))

        if conflicts_src:
            self.purge_freed(resolve_and_replace(self.store, conflicts_src, conflicts_dst,
                                                 kf_id))
        # The row writes above changed kf_mp: bump before the mirrors are read.
        self.store.bump()
        row = self.store.kf_mp_np()[kf_id]
        st.refresh_points(self.store, row[row >= 0], self.scale_table)

    def _local_ba(self, kf_id: int):
        """The local BA's window (the keyframe and its covisibles, up to 48)
        and fixed frontier (keyframes sharing points with it, bucketed to
        32/64/128 slots), keyframe 0 always fixed."""
        WIN, FIX = lba_caps(self.store.state.Kmax)
        cov = self._covisible(kf_id, WIN - 1)
        window = np.concatenate([[kf_id], cov]).astype(np.int32)[:WIN]
        Wmat = self._covis_matrix(kf_id)
        shares = Wmat[window][:, : self.store.n_kf].sum(0)
        cand = np.argsort(-shares)
        in_win = set(window.tolist())
        fixed = [c for c in cand if shares[c] > 0 and c not in in_win][:FIX]
        # Anchor: with no fixed keyframe, fix the oldest window one.
        if len(fixed) == 0 and len(window) > 1:
            oldest = int(window.min())
            window = np.asarray([k for k in window if k != oldest], np.int32)
            fixed = [oldest]
        win_pad = np.full(WIN, -1, np.int32)
        win_pad[: len(window)] = window
        fix_bucket = next(b for b in (FIX // 4, FIX // 2, FIX) if len(fixed) <= b)
        fix_pad = np.full(fix_bucket, -1, np.int32)
        fix_pad[: len(fixed)] = fixed
        if 0 in window.tolist():  # keyframe 0 anchors the gauge
            win_pad = np.asarray([k if k != 0 else -1 for k in win_pad], np.int32)
            if 0 not in fixed:
                free = np.flatnonzero(fix_pad < 0)
                if len(free):
                    fix_pad[free[0]] = 0
                else:  # bucket full: grow it for keyframe 0
                    fix_pad = np.concatenate([fix_pad, np.full(len(fix_pad), -1, np.int32)])
                    fix_pad[len(fix_pad) // 2] = 0
        T = self.store.tensor
        new_state, _, _ = local_ba(self.model, self.params, self.store.state, T(win_pad),
                                   T(fix_pad), self.sigma2_table, bf=self.bf,
                                   obs_cap=self._obs_cap())
        self.store.state = new_state
        self.store.bump()

    def _obs_cap(self):
        """Observation slots per camera of the local BA: every feature for a
        stereo-like sensor, else `OBS_CAP`."""
        return self.store.state.Nf if self.stereo_like else None

    def _cull_keyframes(self, kf_id: int, keep_recent: int = 3):
        """`KeyFrameCulling`: erase covisible keyframes whose points are >=
        90% redundant (>= 3 other observers at the same or a finer scale).
        Keyframe 0, the new one and the `keep_recent` newest are kept; in an
        inertial map also the newest 21, the temporal window the IMU chain
        needs (Nd = 21, `LocalMapping.cc:1176-1198`), and the culled
        keyframe's preintegration is merged into its heir's."""
        nkf = self.store.n_kf
        protected = {0, kf_id}
        protected.update(range(max(0, nkf - keep_recent), nkf))
        if self.imu_calib is not None:
            protected.update(range(max(0, nkf - 21), nkf))
        candidates = [c for c in self._covisible(kf_id, 10) if int(c) not in protected]
        if not candidates:
            return
        s = self.store.state
        kf_mp = self.store.kf_mp_np()
        valid = _np(s.kf_valid)
        kf_oct, feat_ok = _np(s.kf_octave), _np(s.kf_feat_valid)
        L = int(self.sigma2_table.shape[0])
        m = (kf_mp >= 0) & feat_ok & valid[:, None]
        cnt = np.zeros((s.Pmax, L), np.int32)
        np.add.at(cnt, (kf_mp[m], np.clip(kf_oct[m], 0, L - 1)), 1)
        cum = np.cumsum(cnt, axis=1)  # observations of p at octave <= o
        for c in candidates:
            c = int(c)
            if not valid[c]:
                continue
            sel_f = kf_mp[c] >= 0
            pts = kf_mp[c][sel_f]
            if len(pts) < 20:
                continue
            oct_c = np.clip(kf_oct[c][sel_f], 0, L - 1)
            fine = cum[pts, np.minimum(oct_c + 1, L - 1)] - 1  # other observers
            if (fine >= 3).sum() >= 0.9 * len(pts):
                prev = _np(self.store.state.kf_prev)
                if self.tracker is not None:
                    anchor = int(prev[c])
                    if anchor < 0 or not _np(self.store.state.kf_valid)[anchor]:
                        anchor = kf_id
                    self.tracker.on_kf_culled(self.store, c, anchor)
                self.store.state = st.erase_keyframe(self.store.state, c)
                self.store.free_kf_slots.append(c)
                # Keep the temporal chain linked past the hole.
                heirs = np.flatnonzero(prev[: self.store.n_kf] == c)
                if len(heirs):
                    kf_prev = self.store.state.kf_prev.clone()
                    kf_prev[self.store.tensor(heirs)] = int(prev[c])
                    self.store.state = self.store.state._replace(kf_prev=kf_prev)
                for h in heirs:  # the heir's window absorbs the culled one's
                    h = int(h)
                    if c in self.preints and h in self.preints:
                        self.preints[h] = imu_ops.merge(self.preints[c], self.preints[h],
                                                        self.imu_calib)
                self.preints.pop(c, None)
        self.store.bump()

    def _cull_points(self, kf_id: int):
        """`MapPointCulling`: a point born two or more keyframes ago with <= 2
        observers, or found in < 25% of the frames that predicted it
        visible, is erased; survivors graduate."""
        if not self.recent_mp:
            return
        s = self.store.state
        observers = self.store.point_observers_np()
        found, visible, mp_valid = _np(s.mp_found), _np(s.mp_visible), _np(s.mp_valid)
        ratio = found / np.maximum(visible, 1)
        keep = []
        erase_slots = []
        for birth_kf, slots in self.recent_mp:
            slots = slots[mp_valid[slots]]  # replaced or erased since
            if kf_id - birth_kf >= 2:
                erase_slots.append(slots[(observers[slots] <= 2) | (ratio[slots] < 0.25)])
            else:
                keep.append((birth_kf, slots))
        self.recent_mp = keep
        bad = np.concatenate(erase_slots) if erase_slots else np.zeros(0, np.int32)
        if len(bad):
            CAP = 1024
            for start in range(0, len(bad), CAP):
                chunk = bad[start : start + CAP]
                pad = CAP - len(chunk)
                self.store.state = st.erase_points(
                    self.store.state,
                    self.store.tensor(np.concatenate([chunk, np.zeros(pad, chunk.dtype)])),
                    self.store.tensor(np.arange(CAP) < len(chunk)))
            self.store.free_mp_slots.extend(int(b) for b in bad)

    def _global_ba_small(self, kf_id: int):
        """The initial map's BA (both keyframes, the first fixed, 12
        iterations), then median-depth normalization: the median depth of
        the points in keyframe 0 becomes 1."""
        WIN, FIX = lba_caps(self.store.state.Kmax)
        win = np.full(WIN, -1, np.int32)
        win[0] = kf_id
        fix = np.full(max(FIX // 4, 1), -1, np.int32)
        fix[0] = 0
        T = self.store.tensor
        self.store.state, _, _ = local_ba(self.model, self.params, self.store.state, T(win),
                                          T(fix), self.sigma2_table, bf=self.bf, iters=12,
                                          obs_cap=self._obs_cap())
        s = self.store.state
        pos = _np(s.mp_pos)[_np(s.mp_valid)]
        if len(pos):
            z = pos @ _np(s.kf_R[0]).T + _np(s.kf_t[0])
            med = np.median(z[:, 2])
            if med > 1e-6:
                inv = float(1.0 / med)
                self.store.state = s._replace(mp_pos=s.mp_pos * inv, kf_t=s.kf_t * inv)
        self.store.bump()

    # ------------------------------------------------------------------
    # Inertial staging
    # ------------------------------------------------------------------
    def _imu_watchdog(self, kf_id: int):
        """Bad-IMU watchdog (`LocalMapping.cc:183-192`): while the map is
        still visual and younger than 10 s, less than 2 cm of camera motion
        across the newest three keyframes (at least 0.45 s apart) means the
        accelerometer is unexcited: `bad_imu` asks the System to reset."""
        valid = _np(self.store.state.kf_valid)
        ids = np.flatnonzero(valid[: self.store.n_kf])
        if len(ids) < 3:
            return
        ts = self.store.kf_ts
        order = ids[np.argsort(ts[ids])]
        if ts[order[-1]] - ts[order[0]] >= 10.0:
            return
        if ts[order[-1]] - ts[order[-3]] < 0.45:
            return
        last3 = self.store.tensor(order[-3:].astype(np.int64))
        R3, t3 = _np(self.store.state.kf_R[last3]), _np(self.store.state.kf_t[last3])
        centers = np.einsum("kji,kj->ki", R3, -t3)  # Ow = -R^T t
        dist = float(np.linalg.norm(centers[1] - centers[0])
                     + np.linalg.norm(centers[2] - centers[1]))
        if dist < 0.02:
            self.bad_imu = True

    def _sync_tracker(self, kf_id: int):
        """Hand the map's transform (if any) and the keyframe's velocity and
        biases to the tracker."""
        if self.tracker is None:
            return
        if self.imu_init.applied_transform is not None:
            self.tracker.apply_map_transform(*self.imu_init.applied_transform)
            self.imu_init.applied_transform = None
        s = self.store.state
        self.tracker.bias_g = _np(s.kf_bias_g[kf_id])
        self.tracker.bias_a = _np(s.kf_bias_a[kf_id])
        self.tracker.body_vel = _np(s.kf_vel[kf_id])

    def _try_imu_init(self, kf_id: int):
        """`LocalMapping::InitializeIMU` (`LocalMapping.cc:1448`): the
        inertial-only MAP and the map's alignment, then the init-time full
        VI-BA (priors 1e2 / 1e6, `:1585-1587`)."""
        with spans.span("try_initialize"):
            ok = self.imu_init.try_initialize(self.store, self.preints, self.Rbc, self.tbc)
        if not ok:
            return
        self._full_inertial_ba(kf_id, prior_gyro=1e2, prior_acc=1e6)
        if self.tracker is not None:
            self.tracker.imu_ready = True
        self._sync_tracker(kf_id)
        self.n_imu_stages += 1

    def _viba_staging(self, kf_id: int):
        """The refinements after initialization (`LocalMapping.cc:232-273`),
        by the time since the map's first keyframe: VIBA1 past 5 s (priors
        1 / 1e5), VIBA2 past 15 s (no priors), and for a monocular map the
        scale refinement every 10 s while 25 s < t < 75 s."""
        ini = self.imu_init
        ids = np.flatnonzero(_np(self.store.state.kf_valid)[: self.store.n_kf])
        if len(ids) < 3:
            return
        now = float(self.store.kf_ts[kf_id])
        tinit = now - float(self.store.kf_ts[ids].min())
        if not ini.viba1_done and tinit > 5.0:
            self._full_inertial_ba(kf_id, prior_gyro=1.0, prior_acc=1e5)
            ini.viba1_done = True
            self.n_imu_stages += 1
        elif ini.viba1_done and not ini.viba2_done and tinit > 15.0:
            self._full_inertial_ba(kf_id, prior_gyro=0.0, prior_acc=0.0)
            ini.viba2_done = True
            self.n_imu_stages += 1
        elif (ini.mono and ini.viba2_done and 25.0 < tinit < 75.0
              and now - self._last_scale_ref_ts >= 10.0):
            self._last_scale_ref_ts = now
            ini.applied_transform = None
            with spans.span("scale refinement"):
                applied = ini.refine_scale(self.store, self.preints, self.Rbc, self.tbc)
            self._sync_tracker(kf_id)
            self.n_imu_stages += bool(applied)

    def _full_inertial_ba(self, kf_id: int, prior_gyro: float, prior_acc: float):
        """Whole-map VI-BA (`Optimizer::FullInertialBA`, `Optimizer.cc:473`):
        the temporal chain from the map's newest keyframe back to its origin,
        the window bucketed to a multiple of 16, 10 iterations. The newest
        keyframe is this pass's own, except under asynchronous mapping, where
        keyframes inserted since wait for their passes: ORB-SLAM3 optimizes
        every keyframe of the map, and the tracker's next frames start from
        the newest one's velocity (`Tracker.update_frame_imu`, fault C20)."""
        n_live = self.store.n_kf - len(self.store.free_kf_slots)
        window = max(16 * ((n_live + 15) // 16), 16)
        ids = np.flatnonzero(_np(self.store.state.kf_valid)[: self.store.n_kf])
        newest = int(ids[np.argmax(self.store.kf_ts[ids])]) if len(ids) else kf_id
        with spans.span("full VI-BA"):
            self._local_inertial_ba(newest, window=window, prior_gyro=prior_gyro,
                                    prior_acc=prior_acc, iters=10)

    def _local_inertial_ba(self, kf_id: int, window: int = 10, prior_gyro: float = 1e2,
                           prior_acc: float = 1e6, iters: int = 6):
        """`Optimizer::LocalInertialBA` (`Optimizer.cc:4753`): the temporal
        window of the newest `window` keyframes plus one pose-fixed anchor,
        padded to window + 1 with fixed copies of the anchor (no
        observations, no edges); the visual observations of the window's
        keyframes, the IMU chain and the bias random walk (`solve_vi_ba`).
        Writes back the free keyframes' poses, every real keyframe's velocity
        and biases, and the window's points; only real rows are written."""
        s = self.store.state
        chain = [kf_id]
        prev = _np(s.kf_prev)
        while len(chain) < window + 1 and prev[chain[-1]] >= 0:
            chain.append(int(prev[chain[-1]]))
        chain = chain[::-1]  # oldest first; chain[0] is the anchor
        K_real = len(chain)
        if K_real < 3:
            return self._local_ba(kf_id)
        K = window + 1
        chain = chain + [chain[0]] * (K - K_real)
        # Edges between consecutive real chain members with a stored
        # preintegration, padded to K - 1 with invalid 0 -> 0 edges.
        ei, ej, pres = [], [], []
        for n_ in range(1, K_real):
            if chain[n_] in self.preints:
                ei.append(n_ - 1)
                ej.append(n_)
                pres.append(self.preints[chain[n_]])
        if len(pres) < 2:
            return self._local_ba(kf_id)
        ev = [True] * len(pres) + [False] * (K - 1 - len(pres))
        pres += [pres[0]] * (K - 1 - len(pres))
        ei += [0] * (K - 1 - len(ei))
        ej += [0] * (K - 1 - len(ej))
        T = self.store.tensor
        idx = np.asarray([ei, ej], np.int32)
        edges = vi.make_imu_edges(T(idx[0]), T(idx[1]), imu_ops.stack(pres), T(np.asarray(ev)))

        cal = self.imu_calib
        ch = T(np.asarray(chain, np.int64))
        R_wb, p_wb = isup.cam_to_body(s.kf_R[ch], s.kf_t[ch], cal.Rbc, cal.tbc)
        state = vi.BodyState(R=R_wb, p=p_wb, v=s.kf_vel[ch], bg=s.kf_bias_g[ch],
                             ba=s.kf_bias_a[ch])
        fixed = np.zeros(K, bool)
        fixed[0] = True
        fixed[K_real:] = True  # the padding entries
        # Visual observations: the window keyframes' features on their points.
        win_mp = s.kf_mp[ch]  # (K, Nf)
        win_mask = st.flag(s.Pmax, torch.clamp(win_mp, min=0).reshape(-1),
                           (win_mp >= 0).reshape(-1)) & s.mp_valid
        Nf = s.Nf
        obs_mp = win_mp.reshape(-1)
        real_row = T(np.repeat(np.arange(K) < K_real, Nf))
        obs_valid = (obs_mp >= 0) & s.kf_feat_valid[ch].reshape(-1) & real_row
        obs_oct = s.kf_octave[ch].reshape(-1)
        L = self.sigma2_table.shape[0]
        prob = vi.VIProblem(
            state=state, kf_fixed=T(fixed), Tcb_R=cal.Rbc.T, Tcb_t=-(cal.Rbc.T @ cal.tbc),
            points=s.mp_pos, point_valid=win_mask,
            obs_cam=T(np.repeat(np.arange(K, dtype=np.int64), Nf)),
            obs_point=torch.clamp(obs_mp, min=0), obs_uv=s.kf_uv[ch].reshape(-1, 2),
            obs_sigma2=self.sigma2_table[_clip_idx(obs_oct, L)], obs_valid=obs_valid,
            edges=edges,
        )
        res = vi.solve_vi_ba(self.model, self.params, prob, iters=iters, pcg_iters=40,
                             prior_gyro=prior_gyro, prior_acc=prior_acc, obs_per_cam=Nf)
        # Write back, at the real rows only (C6): the free keyframes' camera
        # poses; every real keyframe's velocity and biases; the points.
        Rcw, tcw = isup.body_to_cam(res.state.R, res.state.p, cal.Rbc, cal.tbc)
        free = T(np.flatnonzero(~fixed[:K_real]).astype(np.int64))
        real = T(np.asarray(chain[:K_real], np.int64))
        upd = real[free]
        ss = self.store.state
        kf_R, kf_t = ss.kf_R.clone(), ss.kf_t.clone()
        kf_R[upd], kf_t[upd] = Rcw[free], tcw[free]
        kf_vel, kf_bg, kf_ba = ss.kf_vel.clone(), ss.kf_bias_g.clone(), ss.kf_bias_a.clone()
        kf_vel[real] = res.state.v[:K_real]
        kf_bg[real] = res.state.bg[:K_real]
        kf_ba[real] = res.state.ba[:K_real]
        self.store.state = ss._replace(
            kf_R=kf_R, kf_t=kf_t, kf_vel=kf_vel, kf_bias_g=kf_bg, kf_bias_a=kf_ba,
            mp_pos=torch.where(win_mask[:, None], res.points, ss.mp_pos))
        self.store.bump()
