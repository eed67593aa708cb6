"""Structure-of-arrays map store on torch tensors — the port of
`orbslam3_tpu/atlas/store.py` that the monocular path runs: `MapState`,
`empty_map`, the derived structures (`obs_indicator`, `covisibility`,
`point_observers`, `observer_table`), the mutations (`add_keyframe`,
`add_points`, `erase_points`, `replace_points`, `refresh_points`,
`erase_keyframe`, `update_poses_points`), the found/visible bookkeeping,
and the host wrapper `MapStore` (slot allocation, timestamps, host mirrors
keyed by `change_index`). Field names, shapes and dtypes are the
reference's, so `convert.to_torch(np_state, device, MapState)` carries a
JAX map across. Mutations return a new state and leave their input as it
was, as the reference's do.

Scatters with duplicate indices (fault C6). The reference writes
``x.at[clip(idx, 0)].set(where(valid, v, x[clip(idx, 0)]))``: every invalid
row clips to index 0 (or to the last slot) and writes the old value back,
so on JAX's CPU backend a valid write there is lost unless it comes last,
and on CUDA `index_put_` gives duplicate indices no order at all. The port
scatters the valid rows only (`scatter_rows`, `flag`): invalid rows go to
one extra slot that is dropped. Results therefore equal the reference's
everywhere except, at most, at the slots the invalid rows clip to.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.device import require_cuda
from orbslam3_tpu_torch.ops import matching


class MapState(NamedTuple):
    """Device-resident SLAM map (one Atlas map)."""

    # --- keyframes -------------------------------------------------------
    kf_R: torch.Tensor  # (K,3,3) Tcw
    kf_t: torch.Tensor  # (K,3)
    kf_valid: torch.Tensor  # (K,) bool
    kf_uv: torch.Tensor  # (K,Nf,2) level-0 pixels
    kf_ur: torch.Tensor  # (K,Nf) stereo right-u; <0 mono
    kf_octave: torch.Tensor  # (K,Nf) int32
    kf_angle: torch.Tensor  # (K,Nf) float32
    kf_desc: torch.Tensor  # (K,Nf,32) uint8
    kf_feat_valid: torch.Tensor  # (K,Nf) bool
    kf_mp: torch.Tensor  # (K,Nf) int32 map-point id, -1 = none
    kf_vel: torch.Tensor  # (K,3)
    kf_bias_g: torch.Tensor  # (K,3)
    kf_bias_a: torch.Tensor  # (K,3)
    kf_prev: torch.Tensor  # (K,) int32 temporal chain (-1 none)
    # --- map points ------------------------------------------------------
    mp_pos: torch.Tensor  # (P,3)
    mp_valid: torch.Tensor  # (P,) bool
    mp_desc: torch.Tensor  # (P,32) distinctive descriptor
    mp_normal: torch.Tensor  # (P,3) mean viewing direction
    mp_min_dist: torch.Tensor  # (P,) scale-invariance band
    mp_max_dist: torch.Tensor  # (P,)
    mp_first_kf: torch.Tensor  # (P,) int32 creating KF
    mp_found: torch.Tensor  # (P,) int32 tracking "found" counter
    mp_visible: torch.Tensor  # (P,) int32 tracking "visible" counter

    @property
    def Kmax(self):
        return self.kf_R.shape[0]

    @property
    def Pmax(self):
        return self.mp_pos.shape[0]

    @property
    def Nf(self):
        return self.kf_uv.shape[1]


def scatter_rows(base: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """Copy of `base` with base[idx[r]] = values[r] for the valid rows r
    only (valid idx are unique); invalid rows land in a dropped extra slot."""
    n = base.shape[0]
    buf = torch.cat([base, base[:1]])
    slot = torch.where(valid, idx.to(torch.int64), n)
    buf[slot] = values.to(base.dtype)
    return buf[:n]


def flag(n: int, idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(n,) bool, True at idx[r] for every valid row r."""
    buf = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    # index_fill_ takes the scalar as is; `buf[i] = True` would first copy
    # it to the device, a host synchronisation.
    buf.index_fill_(0, torch.where(valid, idx.to(torch.int64), n), True)
    return buf[:n]


def row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without a host read (indexing with a 0-d
    tensor reads it on the host)."""
    return x.index_select(0, i.reshape(1).to(torch.int64))[0]


def empty_map(Kmax: int = 256, Pmax: int = 16384, Nf: int = 1024, device=None) -> MapState:
    f, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_R=torch.eye(3, dtype=f, device=device).repeat(Kmax, 1, 1),
        kf_t=full((Kmax, 3), 0.0, f),
        kf_valid=full((Kmax,), False, torch.bool),
        kf_uv=full((Kmax, Nf, 2), 0.0, f),
        kf_ur=full((Kmax, Nf), -1.0, f),
        kf_octave=full((Kmax, Nf), 0, i32),
        kf_angle=full((Kmax, Nf), 0.0, f),
        kf_desc=full((Kmax, Nf, 32), 0, torch.uint8),
        kf_feat_valid=full((Kmax, Nf), False, torch.bool),
        kf_mp=full((Kmax, Nf), -1, i32),
        kf_vel=full((Kmax, 3), 0.0, f),
        kf_bias_g=full((Kmax, 3), 0.0, f),
        kf_bias_a=full((Kmax, 3), 0.0, f),
        kf_prev=full((Kmax,), -1, i32),
        mp_pos=full((Pmax, 3), 0.0, f),
        mp_valid=full((Pmax,), False, torch.bool),
        mp_desc=full((Pmax, 32), 0, torch.uint8),
        mp_normal=full((Pmax, 3), 0.0, f),
        mp_min_dist=full((Pmax,), 0.0, f),
        mp_max_dist=full((Pmax,), 1e9, f),
        mp_first_kf=full((Pmax,), -1, i32),
        mp_found=full((Pmax,), 0, i32),
        mp_visible=full((Pmax,), 0, i32),
    )


def bump_found_visible_arrays(state: MapState, visible: torch.Tensor, assoc: torch.Tensor):
    """(mp_found, mp_visible) after one tracked frame: `visible` (P,) bool
    points that passed the frustum test, `assoc` (Nf,) map-point id per
    feature after inlier gating (-1 = unmatched). Adds are
    order-independent, so the clipped -1 rows (adding 0 at index 0) are
    harmless."""
    vis = state.mp_visible + visible.to(torch.int32)
    fnd = state.mp_found.index_add(
        0, torch.clamp(assoc, min=0).to(torch.int64), (assoc >= 0).to(torch.int32)
    )
    return fnd, vis


def update_poses_points(state: MapState, kf_ids, kf_R, kf_t, kf_mask, mp_ids, mp_pos,
                        mp_mask) -> MapState:
    """Write back BA results: poses for kf_ids where kf_mask, positions for
    mp_ids where mp_mask. Only the masked rows are written (C6: the
    reference also writes the old value back through every unmasked row,
    whose clipped ids collide with real ones)."""
    return state._replace(
        kf_R=scatter_rows(state.kf_R, kf_ids, kf_mask, kf_R),
        kf_t=scatter_rows(state.kf_t, kf_ids, kf_mask, kf_t),
        mp_pos=scatter_rows(state.mp_pos, mp_ids, mp_mask, mp_pos),
    )


# ---------------------------------------------------------------------------
# Derived structures
# ---------------------------------------------------------------------------


def obs_indicator(state: MapState) -> torch.Tensor:
    """(K, P) float32 0/1: keyframe k observes point p. A row may list one
    point twice, so the scatter takes the max."""
    K, Nf = state.kf_mp.shape
    ok = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    flat = (torch.arange(K, device=ok.device)[:, None] * state.Pmax
            + torch.clamp(state.kf_mp, min=0).to(torch.int64))
    ind = torch.zeros(K * state.Pmax, dtype=torch.float32, device=ok.device)
    ind = ind.scatter_reduce(0, flat.reshape(-1), ok.reshape(-1).to(torch.float32), "amax")
    return ind.reshape(K, state.Pmax)


def covisibility(state: MapState) -> torch.Tensor:
    """(K, K) int32 covisibility weights = number of shared map points
    (`KeyFrame::UpdateConnections`), zero on the diagonal. A float32
    product of 0/1 indicators: exact below 2^24 (TF32 is off)."""
    ind = obs_indicator(state)
    W = ind @ ind.T
    W = W * (1.0 - torch.eye(W.shape[0], device=W.device))
    return W.to(torch.int32)


def point_observers(state: MapState) -> torch.Tensor:
    """(P,) int32 — number of keyframes observing each point."""
    return obs_indicator(state).sum(0).to(torch.int32)


# ---------------------------------------------------------------------------
# Mutation (pure: new state out, the input untouched)
# ---------------------------------------------------------------------------


def _set_row(x: torch.Tensor, slot: int, v) -> torch.Tensor:
    y = x.clone()
    y[slot] = v
    return y


def add_keyframe(state: MapState, slot: int, R, t, uv, ur, octave, angle, desc, feat_valid,
                 mp_assoc, vel=None, bias_g=None, bias_a=None, prev_kf: int = -1) -> MapState:
    """Insert a keyframe into the host-allocated `slot`."""
    z3 = torch.zeros(3, dtype=state.kf_t.dtype, device=state.kf_t.device)
    return state._replace(
        kf_R=_set_row(state.kf_R, slot, R),
        kf_t=_set_row(state.kf_t, slot, t),
        kf_valid=_set_row(state.kf_valid, slot, True),
        kf_uv=_set_row(state.kf_uv, slot, uv),
        kf_ur=_set_row(state.kf_ur, slot, ur),
        kf_octave=_set_row(state.kf_octave, slot, octave),
        kf_angle=_set_row(state.kf_angle, slot, angle),
        kf_desc=_set_row(state.kf_desc, slot, desc),
        kf_feat_valid=_set_row(state.kf_feat_valid, slot, feat_valid),
        kf_mp=_set_row(state.kf_mp, slot, mp_assoc),
        kf_vel=_set_row(state.kf_vel, slot, vel if vel is not None else z3),
        kf_bias_g=_set_row(state.kf_bias_g, slot, bias_g if bias_g is not None else z3),
        kf_bias_a=_set_row(state.kf_bias_a, slot, bias_a if bias_a is not None else z3),
        kf_prev=_set_row(state.kf_prev, slot, prev_kf),
    )


def add_points(state: MapState, slots, pos, desc, normal, min_dist, max_dist, first_kf,
               valid) -> MapState:
    """Batch-insert map points into `slots` (M,) at the rows where `valid`.
    The reference writes the invalid rows too (their callers aim them at
    the dump slot, `MapStore.dump_slot`, which no point ever owns); the port
    writes the valid rows only (C6), so the two differ at the dump slot
    alone."""
    one = torch.ones_like(first_kf)
    return state._replace(
        mp_pos=scatter_rows(state.mp_pos, slots, valid, pos),
        mp_valid=scatter_rows(state.mp_valid, slots, valid, valid),
        mp_desc=scatter_rows(state.mp_desc, slots, valid, desc),
        mp_normal=scatter_rows(state.mp_normal, slots, valid, normal),
        mp_min_dist=scatter_rows(state.mp_min_dist, slots, valid, min_dist),
        mp_max_dist=scatter_rows(state.mp_max_dist, slots, valid, max_dist),
        mp_first_kf=scatter_rows(state.mp_first_kf, slots, valid, first_kf),
        mp_found=scatter_rows(state.mp_found, slots, valid, one),
        mp_visible=scatter_rows(state.mp_visible, slots, valid, one),
    )


def erase_points(state: MapState, mp_ids: torch.Tensor, mask: torch.Tensor) -> MapState:
    """Invalidate the points `mp_ids[mask]` and every keyframe association
    to them (`MapPoint::SetBadFlag`)."""
    erased = flag(state.Pmax, mp_ids, mask)
    hit = (state.kf_mp >= 0) & erased[torch.clamp(state.kf_mp, min=0).to(torch.int64)]
    return state._replace(mp_valid=state.mp_valid & ~erased,
                          kf_mp=torch.where(hit, -1, state.kf_mp))


def replace_points(state: MapState, src_ids: torch.Tensor, dst_ids: torch.Tensor,
                   mask: torch.Tensor) -> MapState:
    """Batched `MapPoint::Replace` (via `ORBmatcher::Fuse`): every
    observation of `src_ids[i]` is rewired to `dst_ids[i]` where `mask[i]`,
    except in keyframes that already observe the destination — there the
    source observation is erased. Found/visible counts move onto the
    destination and the sources are invalidated.

    Fault C6, repaired: the reference writes the lookup table and
    `mp_valid` through every row, the padded -1 rows clipped to point 0
    with its old value, so when point 0 is a live source its replacement is
    dropped on JAX's CPU backend (last write wins) and undefined on CUDA.
    The port writes the live rows only (`scatter_rows`)."""
    P = state.Pmax
    live = mask & (src_ids >= 0) & (dst_ids >= 0) & (src_ids != dst_ids)
    src = torch.clamp(src_ids, 0, P - 1).to(torch.int64)
    dst = torch.clamp(dst_ids, 0, P - 1).to(torch.int64)
    lut = scatter_rows(torch.arange(P, dtype=torch.int32, device=src.device), src, live, dst)

    kf_mp = state.kf_mp
    K, Nf = kf_mp.shape
    mapped = torch.where(kf_mp >= 0, lut[torch.clamp(kf_mp, min=0).to(torch.int64)], kf_mp)
    rewired = (mapped != kf_mp) & (kf_mp >= 0)
    # One claimant per (row, id) after the rewiring: scatter-min a priority
    # key (incumbents before rewired observations, then feature index).
    cols = torch.arange(Nf, dtype=torch.int32, device=src.device)[None, :].expand(K, Nf)
    key = torch.where(rewired, cols + Nf, cols)
    BIG = 2 * Nf + 1
    flat = (torch.arange(K, device=src.device)[:, None] * P
            + torch.clamp(mapped, min=0).to(torch.int64))
    winner = torch.full((K * P,), BIG, dtype=torch.int32, device=src.device)
    winner = winner.scatter_reduce(0, flat.reshape(-1),
                                   torch.where(mapped >= 0, key, BIG).reshape(-1), "amin")
    keep = (mapped >= 0) & (winner[flat] == key)
    new_kf_mp = torch.where(keep, mapped, torch.where(mapped >= 0, -1, mapped))

    zero = torch.zeros_like(state.mp_found[src])
    mp_found = state.mp_found.index_add(0, dst, torch.where(live, state.mp_found[src], zero))
    mp_visible = state.mp_visible.index_add(0, dst, torch.where(live, state.mp_visible[src], zero))
    mp_valid = scatter_rows(state.mp_valid, src, live, torch.zeros_like(live))
    return state._replace(kf_mp=new_kf_mp, mp_valid=mp_valid, mp_found=mp_found,
                          mp_visible=mp_visible)


MAXOBS = 16  # observer cap for the descriptor/normal refresh


def observer_table(state: MapState):
    """(P, MAXOBS) observing-keyframe ids (-1 pad) and feature indices per
    map point, the first MAXOBS in keyframe order (`MapPoint::mObservations`):
    a stable sort of the flattened `kf_mp` by point id, each entry's rank in
    its point's run, and a scatter of the first MAXOBS."""
    K, Nf = state.kf_mp.shape
    P = state.Pmax
    ok = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None]
    flat_p = torch.where(ok, state.kf_mp, P).reshape(-1)
    order = torch.argsort(flat_p, stable=True)
    sp = flat_p[order]
    first = torch.searchsorted(sp, torch.arange(P + 1, dtype=sp.dtype, device=sp.device))
    rank = torch.arange(sp.shape[0], device=sp.device) - first[torch.clamp(sp, 0, P).to(torch.int64)]
    valid = (sp < P) & (rank < MAXOBS)
    cell = torch.clamp(sp, 0, P - 1).to(torch.int64) * MAXOBS + torch.clamp(rank, 0, MAXOBS - 1)
    tab_kf = scatter_rows(torch.full((P * MAXOBS,), -1, dtype=torch.int32, device=sp.device),
                          cell, valid, order // Nf)
    tab_ff = scatter_rows(torch.zeros(P * MAXOBS, dtype=torch.int32, device=sp.device),
                          cell, valid, order % Nf)
    return tab_kf.reshape(P, MAXOBS), tab_ff.reshape(P, MAXOBS)


def _refresh_kernel(state: MapState, cand_ids, obs_kf, obs_feat, scale_table) -> MapState:
    """Distinctive descriptor (`ComputeDistinctiveDescriptors`: the
    observation with the least median Hamming distance to the others) and
    normal + scale band (`UpdateNormalAndDepth`) of the candidates (M,),
    from their observers (M, MAXOBS)."""
    ok = obs_kf >= 0
    kfc = torch.clamp(obs_kf, min=0).to(torch.int64)
    ff = obs_feat.to(torch.int64)
    cid = torch.clamp(cand_ids, min=0).to(torch.int64)
    descs = state.kf_desc[kfc, ff]  # (M, O, 32)
    d = matching.hamming_matrix(descs, descs).to(torch.int32)  # (M, O, O), exact
    BIG = 10000
    d = torch.where(ok[:, :, None] & ok[:, None, :], d, BIG)
    ds = torch.sort(d, dim=-1)[0]
    nv = ok.to(torch.int32).sum(-1)
    med_idx = torch.clamp((nv - 1) // 2, 0, MAXOBS - 1).to(torch.int64)
    med = torch.gather(ds, 2, med_idx[:, None, None].expand(-1, MAXOBS, 1))[..., 0]
    med = torch.where(ok, med, BIG)
    best = torch.argmin(med, dim=-1)
    aM = torch.arange(cand_ids.shape[0], device=cid.device)
    new_desc = descs[aM, best]

    Rk = state.kf_R[kfc]  # (M, O, 3, 3)
    tk = state.kf_t[kfc]
    Ow = -torch.einsum("moji,moj->moi", Rk, tk)
    X = state.mp_pos[cid]
    v = X[:, None] - Ow
    vn = v / (torch.linalg.norm(v, dim=-1, keepdim=True) + 1e-12)
    nsum = torch.where(ok[..., None], vn, 0.0).sum(1)
    normal = nsum / (torch.linalg.norm(nsum, dim=-1, keepdim=True) + 1e-12)

    ref_o = torch.argmax(ok.to(torch.uint8), dim=-1)  # the first observer
    dist = torch.linalg.norm(X - Ow[aM, ref_o], dim=-1)
    oct_ref = state.kf_octave[kfc[aM, ref_o], ff[aM, ref_o]]
    L = scale_table.shape[0]
    max_d = dist * scale_table[torch.clamp(oct_ref, 0, L - 1).to(torch.int64)]
    min_d = max_d / scale_table[-1]

    upd = (nv > 0) & state.mp_valid[cid] & (cand_ids >= 0)
    return state._replace(
        mp_desc=scatter_rows(state.mp_desc, cid, upd, new_desc),
        mp_normal=scatter_rows(state.mp_normal, cid, upd, normal),
        mp_min_dist=scatter_rows(state.mp_min_dist, cid, upd, min_d),
        mp_max_dist=scatter_rows(state.mp_max_dist, cid, upd, max_d),
    )


def refresh_points(store: "MapStore", cand_ids: np.ndarray, scale_table: torch.Tensor,
                   cap: int = 1024) -> None:
    """Recompute the distinctive descriptors, normals and scale bands of the
    candidate points (after new observations or a fuse), in chunks of `cap`
    padded with the dump slot."""
    dump = store.dump_slot
    cand_ids = np.unique(np.asarray(cand_ids))
    cand_ids = cand_ids[(cand_ids >= 0) & (cand_ids < dump)]
    if len(cand_ids) == 0:
        return
    tab_kf, tab_ff = observer_table(store.state)
    for start in range(0, len(cand_ids), cap):
        chunk = cand_ids[start : start + cap]
        pad = cap - len(chunk)
        ids = store.tensor(np.concatenate([chunk, np.full(pad, dump)]).astype(np.int32))
        lane_ok = store.tensor(np.arange(cap) < len(chunk))
        rows = ids.to(torch.int64)
        store.state = _refresh_kernel(store.state, ids,
                                      torch.where(lane_ok[:, None], tab_kf[rows], -1),
                                      tab_ff[rows], scale_table)


def erase_keyframe(state: MapState, slot: int) -> MapState:
    """Invalidate a keyframe and its observations (`KeyFrame::SetBadFlag`)."""
    return state._replace(
        kf_valid=_set_row(state.kf_valid, slot, False),
        kf_mp=_set_row(state.kf_mp, slot, -1),
        kf_feat_valid=_set_row(state.kf_feat_valid, slot, False),
    )


# ---------------------------------------------------------------------------
# Host wrapper: slot allocation and bookkeeping
# ---------------------------------------------------------------------------


class MapStore:
    """Host-side owner of one map on `device` (None: the first CUDA card,
    raising where there is none): slot allocation, keyframe timestamps, and
    host mirrors of derived structures, each cached until `change_index`
    moves (`bump`)."""

    def __init__(self, Kmax: int = 256, Pmax: int = 16384, Nf: int = 1024, device=None):
        self.device = require_cuda() if device is None else torch.device(device)
        self.state = empty_map(Kmax, Pmax, Nf, device=self.device)
        self.n_kf = 0
        self.n_mp = 0
        self.kf_ts = np.zeros(Kmax, np.float64)
        self.free_mp_slots: list[int] = []
        self.free_kf_slots: list[int] = []
        self.change_index = 0  # ref Map::GetMapChangeIndex
        self._mirrors: dict = {}

    def tensor(self, x) -> torch.Tensor:
        """A host array as a tensor on the store's device (no host sync)."""
        return convert.tensor(x, self.device)

    def _mirror(self, name: str, compute):
        hit = self._mirrors.get(name)
        if hit is None or hit[0] != self.change_index:
            hit = (self.change_index, compute().cpu().numpy())
            self._mirrors[name] = hit
        return hit[1]

    def covisibility_np(self) -> np.ndarray:
        """Host copy of `covisibility(state)` for this map version."""
        return self._mirror("covis", lambda: covisibility(self.state))

    def point_observers_np(self) -> np.ndarray:
        """Host copy of `point_observers(state)` for this map version."""
        return self._mirror("observers", lambda: point_observers(self.state))

    def kf_mp_np(self) -> np.ndarray:
        """Host copy of the (K, Nf) feature -> map-point table for this map
        version."""
        return self._mirror("kf_mp", lambda: self.state.kf_mp)

    # -- allocation -----------------------------------------------------
    def alloc_kf(self) -> int:
        if self.free_kf_slots:
            return self.free_kf_slots.pop()
        slot = self.n_kf
        if slot >= self.state.Kmax:
            raise RuntimeError("keyframe capacity exhausted; raise Kmax")
        self.n_kf += 1
        return slot

    def alloc_mps(self, n: int) -> np.ndarray:
        slots = []
        while self.free_mp_slots and len(slots) < n:
            slots.append(self.free_mp_slots.pop())
        remaining = n - len(slots)
        # The last slot is the dump of padded fixed-size inserts.
        if self.n_mp + remaining > self.state.Pmax - 1:
            raise RuntimeError("map-point capacity exhausted; raise Pmax")
        slots.extend(range(self.n_mp, self.n_mp + remaining))
        self.n_mp += remaining
        return np.asarray(slots, np.int32)

    @property
    def dump_slot(self) -> int:
        return self.state.Pmax - 1

    def bump(self):
        self.change_index += 1
