"""Structure-of-arrays map store on torch tensors — the tracking slice's
subset of `orbslam3_tpu/atlas/store.py`: `MapState`, `empty_map` and the
found/visible bookkeeping. Field names, shapes and dtypes are the
reference's, so `convert.to_torch(np_state, device, MapState)` carries a
JAX map across."""

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
