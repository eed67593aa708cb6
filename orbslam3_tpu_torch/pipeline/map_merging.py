"""Map merging on torch tensors — the port of
`orbslam3_tpu/pipeline/map_merging.py` (`LoopClosing::MergeLocal`'s map
migration, `LoopClosing.cc:1550-1800`): the active map, moved by the
measured world Sim3 into a stored map's frame, is copied into it.

`transform_map` applies the Sim3 to every pose, velocity, point, normal and
scale band as plain tensor ops. `merge_maps` allocates the target's slots on
the host (one read of the source's keyframe and point validity and its
temporal chain) and copies the source's rows in one scatter per field; the
feature -> point table and the points' first keyframes are remapped on the
device through (Pmax + 1) and (Kmax + 1) lookup tables. The caller welds
the seam (`pipeline/multimap.py`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.pipeline.tracking import fetch_bundle


def transform_map(state: st.MapState, R: torch.Tensor, t: torch.Tensor, s: float) -> st.MapState:
    """Apply the world Sim3 x' = s R x + t to every pose and point. A camera
    keeps its centre's image c' = S(c) and turns with the world:
    Rcw' = Rcw R^T, tcw' = s tcw - Rcw R^T t. Velocities rotate and scale."""
    RRt = state.kf_R @ R.T[None]
    return state._replace(
        kf_R=RRt,
        kf_t=s * state.kf_t - torch.einsum("kij,j->ki", RRt, t),
        kf_vel=s * torch.einsum("ij,kj->ki", R, state.kf_vel),
        mp_pos=s * torch.einsum("ij,pj->pi", R, state.mp_pos) + t[None],
        mp_normal=torch.einsum("ij,pj->pi", R, state.mp_normal),
        mp_min_dist=state.mp_min_dist * s,
        mp_max_dist=state.mp_max_dist * s,
    )


_KF_ROWS = ("kf_R", "kf_t", "kf_uv", "kf_ur", "kf_octave", "kf_angle", "kf_desc",
            "kf_feat_valid", "kf_vel", "kf_bias_g", "kf_bias_a")


def merge_maps(target: st.MapStore, source: st.MapStore, R: np.ndarray, t: np.ndarray,
               s: float) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Copy `source`, transformed by the Sim3 into the target's frame, into
    `target`. Returns (kf_remap, mp_remap): source slot -> target slot. The
    keyframes take the slots `alloc_kf` gives in source order, the points
    those of one `alloc_mps`, as the reference's; their timestamps and frame
    numbers come along, and the temporal chain, the feature -> point table
    and the points' first keyframes are remapped (a link to a keyframe or
    point that did not move becomes -1)."""
    dev = target.device
    src = transform_map(source.state, torch.as_tensor(np.asarray(R, np.float32), device=dev),
                        torch.as_tensor(np.asarray(t, np.float32), device=dev), float(s))
    h = fetch_bundle(dict(kf_valid=src.kf_valid, mp_valid=src.mp_valid, kf_prev=src.kf_prev))
    src_kf = [k for k in range(source.n_kf) if h["kf_valid"][k]]
    src_mp = np.flatnonzero(h["mp_valid"])
    kf_remap = {k: target.alloc_kf() for k in src_kf}
    mp_slots = target.alloc_mps(len(src_mp))
    mp_remap = {int(p): int(slot) for p, slot in zip(src_mp, mp_slots)}

    T = target.tensor
    kf_lut = np.full(src.Kmax + 1, -1, np.int32)  # entry Kmax: the -1 links
    kf_lut[src_kf] = [kf_remap[k] for k in src_kf]
    mp_lut = np.full(src.Pmax + 1, -1, np.int32)  # entry Pmax: the -1 links
    mp_lut[src_mp] = mp_slots
    kf_lut_t, mp_lut_t = T(kf_lut), T(mp_lut)

    tgt = target.state
    if src_kf:
        s_ids = T(np.asarray(src_kf, np.int64))
        t_ids = T(np.asarray([kf_remap[k] for k in src_kf], np.int64))
        rows = {}
        for name in _KF_ROWS:
            x = getattr(tgt, name).clone()
            x[t_ids] = getattr(src, name)[s_ids]
            rows[name] = x
        kf_mp = src.kf_mp[s_ids].to(torch.int64)
        new_mp = mp_lut_t[torch.where(kf_mp >= 0, kf_mp, src.Pmax)]
        kf_mp_t = tgt.kf_mp.clone()
        kf_mp_t[t_ids] = new_mp
        prev = np.asarray([kf_lut[p] if p >= 0 else -1 for p in h["kf_prev"][src_kf]],
                          np.int32)
        kf_prev = tgt.kf_prev.clone()
        kf_prev[t_ids] = T(prev)
        kf_valid = tgt.kf_valid.clone()
        kf_valid[t_ids] = True
        tgt = tgt._replace(kf_mp=kf_mp_t, kf_prev=kf_prev, kf_valid=kf_valid, **rows)
        for k in src_kf:
            target.kf_ts[kf_remap[k]] = source.kf_ts[k]
            target.kf_frame_id[kf_remap[k]] = source.kf_frame_id[k]

    if len(src_mp):
        ids = T(src_mp.astype(np.int64))
        first = src.mp_first_kf[ids].to(torch.int64)
        first = kf_lut_t[torch.where(first >= 0, first, src.Kmax)]
        tgt = st.add_points(tgt, T(mp_slots), src.mp_pos[ids], src.mp_desc[ids],
                            src.mp_normal[ids], src.mp_min_dist[ids], src.mp_max_dist[ids],
                            first, torch.ones(len(src_mp), dtype=torch.bool, device=dev))
    target.state = tgt
    target.bump()
    return kf_remap, mp_remap
