"""The Atlas on torch tensors — the port of `orbslam3_tpu/atlas/atlas.py`
(`Atlas.cc`): a set of maps, one of them active. A hard tracking loss
stores the active map and starts a fresh one (`create_new_map`,
`Atlas::CreateNewMap`); place recognition may later merge them
(`pipeline/multimap.py`).

Every map lives on the atlas's `device`. `save(path)` writes the JAX
package's own format: `map{i}.npz` holds the `MapState` fields as numpy
arrays, `atlas.json` the dims, the active index, the IMU flag and each map's
host bookkeeping (`n_kf`, `n_mp`, `kf_ts`, `kf_frame_id`, the free slots,
`change_index`). An atlas saved by either package loads in the other;
`load(path, device)` puts every map on `device`.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from orbslam3_tpu_torch.atlas.store import MapState, MapStore
from orbslam3_tpu_torch.device import require_cuda


class Atlas:
    def __init__(self, Kmax: int = 256, Pmax: int = 16384, Nf: int = 1024, device=None,
                 maps: Optional[List[MapStore]] = None):
        """An atlas of `maps` (the first active), or of one fresh map when
        None; every map on `device` (None: the first CUDA card)."""
        self._dims = (Kmax, Pmax, Nf)
        self.device = require_cuda() if device is None else torch.device(device)
        self.maps: List[MapStore] = (list(maps) if maps is not None
                                     else [MapStore(Kmax, Pmax, Nf, device=self.device)])
        self.active_idx = 0
        self.imu_initialized = False

    @property
    def active(self) -> MapStore:
        return self.maps[self.active_idx]

    def create_new_map(self) -> MapStore:
        """`Atlas::CreateNewMap`: keep the current map, start a fresh one."""
        self.maps.append(MapStore(*self._dims, device=self.device))
        self.active_idx = len(self.maps) - 1
        return self.active

    def change_map(self, idx: int):
        self.active_idx = idx

    def remove_bad_maps(self, min_kfs: int = 5):
        """Drop the maps other than the active one with fewer than `min_kfs`
        keyframes (`Atlas::RemoveBadMaps`)."""
        act = self.active
        self.maps = [m for m in self.maps if m is act or m.n_kf >= min_kfs]
        self.active_idx = self.maps.index(act)

    @property
    def n_maps(self) -> int:
        return len(self.maps)

    # -- checkpoint / resume (`System::SaveAtlas` / `LoadAtlas`) ---------
    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        meta = {"dims": self._dims, "active_idx": self.active_idx,
                "imu_initialized": self.imu_initialized, "maps": []}
        for i, m in enumerate(self.maps):
            arrays = {k: v.cpu().numpy() for k, v in m.state._asdict().items()}
            np.savez_compressed(os.path.join(path, f"map{i}.npz"), **arrays)
            meta["maps"].append({
                "n_kf": m.n_kf,
                "n_mp": m.n_mp,
                "kf_ts": m.kf_ts.tolist(),
                "kf_frame_id": m.kf_frame_id.tolist(),
                "free_mp_slots": [int(x) for x in m.free_mp_slots],
                "free_kf_slots": [int(x) for x in m.free_kf_slots],
                "change_index": m.change_index,
            })
        with open(os.path.join(path, "atlas.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device=None) -> "Atlas":
        """The atlas saved at `path`, every map on `device` (None: the first
        CUDA card)."""
        with open(os.path.join(path, "atlas.json")) as f:
            meta = json.load(f)
        atlas = cls(*meta["dims"], device=device, maps=[])
        for i, m_meta in enumerate(meta["maps"]):
            store = MapStore(*meta["dims"], device=atlas.device)
            with np.load(os.path.join(path, f"map{i}.npz")) as data:
                store.state = MapState(**{k: torch.from_numpy(data[k]).to(atlas.device)
                                          for k in MapState._fields})
            store.n_kf = m_meta["n_kf"]
            store.n_mp = m_meta["n_mp"]
            store.kf_ts = np.asarray(m_meta["kf_ts"], np.float64)
            store.kf_frame_id = np.asarray(m_meta["kf_frame_id"], np.int64)
            store.free_mp_slots = list(m_meta["free_mp_slots"])
            store.free_kf_slots = list(m_meta["free_kf_slots"])
            store.change_index = m_meta["change_index"]
            atlas.maps.append(store)
        atlas.active_idx = meta["active_idx"]
        atlas.imu_initialized = meta["imu_initialized"]
        return atlas
