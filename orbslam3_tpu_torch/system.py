"""The public entry of the port — `System` of `orbslam3_tpu/system.py`
(`ORB_SLAM3::System`) for a monocular pinhole camera.

`System(Sensor.MONOCULAR, CameraModel.PINHOLE, params, (W, H), orb, device)`
wires a `Tracker` and a synchronous `LocalMapper` over one `MapStore` on
`device`: the first CUDA card when `device` is None (it raises where there
is none and never falls back), the CPU (the kernels' plain versions) only
when the caller asks for it with `device="cpu"`.
`track_monocular(img, timestamp)` runs a frame (and, on a new
keyframe, its mapping pass; a frame older than the last one first resets
the active map) and `get_trajectory()` reads the camera centres back
through the current keyframe poses. Not ported yet: the other sensors
(stereo and RGB-D A10, inertial A11), the fisheye model (A12), place
recognition and loop closing (A9), multi-map, atlas save/load and the
trajectory writers (A13, A14), asynchronous mapping and localization mode
(A14).
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np
import torch

from orbslam3_tpu_torch.atlas.store import MapStore
from orbslam3_tpu_torch.device import require_cuda
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.pipeline.local_mapping import LocalMapper
from orbslam3_tpu_torch.pipeline.tracking import Tracker, TrackState


class Sensor(enum.Enum):
    """`System::eSensor`."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


_NOT_PORTED = {
    Sensor.STEREO: "A10", Sensor.RGBD: "A10", Sensor.IMU_MONOCULAR: "A11",
    Sensor.IMU_STEREO: "A11",
}


class System:
    def __init__(self, sensor: Sensor, camera_model: cam.CameraModel, camera_params,
                 img_wh: Tuple[int, int], orb_params: feat.OrbParams = feat.OrbParams(),
                 device=None, Kmax: int = 256, Pmax: int = 16384, fps: float = 20.0):
        if sensor in _NOT_PORTED:
            raise NotImplementedError(f"{sensor.name} is ROADMAP {_NOT_PORTED[sensor]}")
        if camera_model != cam.CameraModel.PINHOLE:
            raise NotImplementedError("the Kannala-Brandt model is ROADMAP A12")
        self.sensor = sensor
        self.device = require_cuda() if device is None else torch.device(device)
        self.store = MapStore(Kmax=Kmax, Pmax=Pmax, Nf=sum(feat.level_budgets(orb_params)),
                              device=self.device)
        params = torch.from_numpy(np.array(camera_params, np.float32)).to(self.device)
        self.tracker = Tracker(camera_model, params, img_wh, self.store, orb_params, fps=fps)
        self.mapper = LocalMapper(camera_model, params, img_wh, self.store, orb_params)
        self.mapper.tracker = self.tracker
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.anomaly_cb = self._on_timestamp_anomaly
        self._lost_streak = 0

    def _on_new_keyframe(self, slot: int, initial: bool = False):
        self.mapper.process_keyframe(slot, initial=initial)

    def _on_timestamp_anomaly(self, kind: str):
        """`Tracking::Track` (Tracking.cc:987-996): a reordered frame
        (`kind` "reorder", the only anomaly of the visual sensors) resets
        the active map."""
        self.reset_active_map()

    def track_monocular(self, img: np.ndarray, timestamp: float):
        """`System::TrackMonocular`: one grey image (H, W) and its time in
        seconds. Returns the frame's `FrameData`."""
        out = self.tracker.process_frame(img, timestamp)
        self._post_frame()
        return out

    def _post_frame(self):
        self._lost_recovery_fallback()

    def _lost_recovery_fallback(self):
        """Hard-LOST policy without a multi-map atlas: a map of <= 10
        keyframes that stays LOST for 5 frames is discarded and
        initialization restarts; a larger one waits for relocalization."""
        if self.tracker.state != TrackState.LOST:
            self._lost_streak = 0
            return
        self._lost_streak += 1
        if self._lost_streak >= 5 and self.store.n_kf <= 10:
            self.reset_active_map()
            self._lost_streak = 0

    def reset(self):
        """`System::Reset`: drop the map and the trajectory."""
        self.tracker.reset_map_state(full=True)
        self._swap_fresh_store()

    def reset_active_map(self):
        """`System::ResetActiveMap`: drop the map and its trajectory entries."""
        self.tracker.reset_map_state(full=False)
        self._swap_fresh_store()

    def _swap_fresh_store(self):
        s = self.store.state
        new = MapStore(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device=self.device)
        self.store = new
        self.tracker.store = new
        self.mapper.store = new
        self.mapper.recent_mp = []

    @property
    def tracking_state(self) -> TrackState:
        return self.tracker.state

    @property
    def n_keyframes(self) -> int:
        return self.store.n_kf

    @property
    def n_map_points(self) -> int:
        """Valid map points (a host read)."""
        return int(self.store.state.mp_valid.sum())

    def get_trajectory(self):
        """(timestamps (N,), camera centres (N, 3)) of the tracked frames,
        chained through the current keyframe poses."""
        rows = self.tracker.reconstructed_trajectory()
        return np.asarray([r[0] for r in rows]), np.asarray([r[2] for r in rows])
