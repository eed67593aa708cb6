"""Structure-of-arrays map store on torch tensors — the main path's subset
of `orbslam3_tpu/atlas/store.py`: `MapState`, `empty_map`, the
found/visible bookkeeping and the BA write-back `update_poses_points`.
Field names, shapes and dtypes are the reference's, so
`convert.to_torch(np_state, device, MapState)` carries a JAX map across.

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

import torch


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
