"""The public entry of the port — `System` of `orbslam3_tpu/system.py`
(`ORB_SLAM3::System`) for a monocular, monocular-inertial, rectified stereo
or RGB-D pinhole camera.

`System(sensor, CameraModel.PINHOLE, params, (W, H), orb, device, bf=...)`
wires a `Tracker` and a synchronous `LocalMapper` over one `MapStore` on
`device`: the first CUDA card when `device` is None (it raises where there
is none and never falls back), the CPU (the kernels' plain versions) only
when the caller asks for it with `device="cpu"`. `bf` is the stereo
baseline times fx (ORB-SLAM3's `Camera.bf`), for `Sensor.STEREO` and
`Sensor.RGBD`; `imu_calib` (`ops/imu.py::ImuCalib`) the IMU's extrinsics
and noise, for `Sensor.IMU_MONOCULAR`. `track_monocular(img, t[,
imu_measurements])`, `track_stereo(left, right, t)` and `track_rgbd(img,
depth, t)` run a frame (and, on a new keyframe, its mapping pass, then the
keyframe's hand-off to loop closing; a frame older than the last one first
resets the active map, and so does an inertial gap of more than 1 s, or
the bad-IMU watchdog) and `get_trajectory()` reads the camera centres back
through the current keyframe poses.
`enable_rectification(left, right)` remaps raw stereo pairs on the device
before `track_stereo`. `enable_place_recognition(vocabulary)` attaches a
keyframe database and a `LoopCloser` (relocalization of a lost map, loop
closing, the background global BA, one chunk of it after each frame), all
on the system's device (an inertial one closes loops with the scale fixed
and the 4-DoF essential graph). Not ported yet: IMU_STEREO, the fisheye
model and the two-camera rig (A12), multi-map, atlas save/load and the
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
from orbslam3_tpu_torch.ops import imu as imu_ops
from orbslam3_tpu_torch.pipeline.inertial_support import ImuInitializer
from orbslam3_tpu_torch.pipeline.local_mapping import LocalMapper
from orbslam3_tpu_torch.pipeline.tracking import Tracker, TrackState


class Sensor(enum.Enum):
    """`System::eSensor`."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4


_NOT_PORTED = {Sensor.IMU_STEREO: "A12"}


class System:
    def __init__(self, sensor: Sensor, camera_model: cam.CameraModel, camera_params,
                 img_wh: Tuple[int, int], orb_params: feat.OrbParams = feat.OrbParams(),
                 device=None, bf: float = 0.0, camera2=None, Kmax: int = 256,
                 Pmax: int = 16384, fps: float = 20.0, imu_calib: imu_ops.ImuCalib | None = None):
        if sensor in _NOT_PORTED:
            raise NotImplementedError(f"{sensor.name} is ROADMAP {_NOT_PORTED[sensor]}")
        if camera_model != cam.CameraModel.PINHOLE:
            raise NotImplementedError("the Kannala-Brandt model is ROADMAP A12")
        if camera2 is not None:
            raise NotImplementedError("the two-camera rig (camera2) is ROADMAP A12")
        inertial = sensor == Sensor.IMU_MONOCULAR
        if inertial and imu_calib is None:
            raise ValueError("IMU_MONOCULAR needs imu_calib")
        self.sensor = sensor
        self.device = require_cuda() if device is None else torch.device(device)
        if inertial:  # the calibration on the system's device
            imu_calib = imu_ops.ImuCalib(*(x.to(self.device) for x in imu_calib))
        self.store = MapStore(Kmax=Kmax, Pmax=Pmax, Nf=sum(feat.level_budgets(orb_params)),
                              device=self.device)
        params = torch.from_numpy(np.array(camera_params, np.float32)).to(self.device)
        self.tracker = Tracker(camera_model, params, img_wh, self.store, orb_params, bf=bf,
                               fps=fps, imu_calib=imu_calib if inertial else None)
        self.mapper = LocalMapper(camera_model, params, img_wh, self.store, orb_params, bf=bf,
                                  imu_calib=imu_calib if inertial else None, mono=True)
        # Metric-depth sensors keep every observation in the local BA.
        stereo_like = sensor in (Sensor.STEREO, Sensor.RGBD)
        self.tracker.is_stereo_like = stereo_like
        self.mapper.stereo_like = stereo_like
        self.mapper.tracker = self.tracker
        self.rectifier = None
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.anomaly_cb = self._on_timestamp_anomaly
        self.loop_closer = None
        # Consumers of a keyframe after its mapping pass (the LocalMapping ->
        # LoopClosing hand-off, `LocalMapping.cc:280`).
        self._kf_downstream = []
        self._lost_streak = 0

    def _on_new_keyframe(self, slot: int, initial: bool = False, preint=None) -> bool:
        """The keyframe's mapping pass (with its preintegration from the
        previous keyframe), then its hand-off to loop closing. Returns
        whether a loop correction moved the map (fault C12)."""
        self.mapper.process_keyframe(slot, initial=initial, preint=preint)
        loops = self.n_loops_closed
        for d in self._kf_downstream:
            d(slot)
        return self.n_loops_closed > loops

    def enable_place_recognition(self, vocabulary, run_gba: bool = True,
                                 min_bow_matches: int = 20, min_sim3_inliers: int = 20,
                                 consecutive: int = 3, async_gba: bool = True):
        """Attach a vocabulary (`ops/bow.py::Vocabulary`, moved to the
        system's device): a keyframe database for relocalization and a
        `LoopCloser` fed every keyframe after its mapping pass
        (`System.cc:83-95`). `consecutive` keyframes must confirm a loop
        (`LoopClosing.cc:367`); `async_gba` runs the global BA in chunks
        after the frames instead of at once. An IMU_MONOCULAR system's loop
        closer is inertial: Sim3 steps with the scale fixed, the 4-DoF
        essential graph."""
        from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB
        from orbslam3_tpu_torch.ops import bow
        from orbslam3_tpu_torch.pipeline.gba import AsyncGBA
        from orbslam3_tpu_torch.pipeline.loop_closing import LoopCloser

        voc = bow.to_device(vocabulary, self.device)
        kfdb = KeyFrameDB(voc, Kmax=self.store.state.Kmax)
        self.tracker.kfdb = kfdb
        t = self.tracker
        self.loop_closer = LoopCloser(
            t.model, t.params, self.store, kfdb, t.sigma2_table, run_gba=run_gba,
            min_bow_matches=min_bow_matches, min_sim3_inliers=min_sim3_inliers,
            consecutive=consecutive, inertial=self.sensor == Sensor.IMU_MONOCULAR,
            img_wh=t.img_wh_t, scale_table=t.scale_table, mapper=self.mapper, bf=t.bf)
        if run_gba and async_gba:
            self.loop_closer.gba_async = AsyncGBA(t.model, t.params, t.sigma2_table, bf=t.bf)
        self._kf_downstream.append(self.loop_closer.process_keyframe)

    @property
    def n_loops_closed(self) -> int:
        return 0 if self.loop_closer is None else self.loop_closer.n_loops_closed

    def shutdown(self):
        """`System::Shutdown` (`System.cc:474`): run a background GBA to its
        end."""
        lc = self.loop_closer
        if lc is not None and lc.gba_async is not None:
            lc.gba_async.join(self.store)

    def _on_timestamp_anomaly(self, kind: str):
        """`Tracking::Track` (Tracking.cc:987-1031): a reordered frame
        ("reorder") or an inertial gap of more than 1 s ("gap_uninit",
        "gap_init") resets the active map. With a multi-map atlas (A13) the
        reference keeps an initialized map on "gap_init" and starts a new
        one; without one, as here, it resets."""
        self.reset_active_map()

    def enable_rectification(self, rect_left, rect_right):
        """Raw (unrectified) pinhole stereo: the reference's LEFT./RIGHT.
        K/D/R/P blocks (any objects with K, D, R, P, width and height). The
        grids are built once on the host; `track_stereo` then remaps each
        raw pair on the device before extraction. Returns the rectifier."""
        from orbslam3_tpu_torch.ops.rectify import StereoRectifier

        if self.sensor != Sensor.STEREO:
            raise ValueError(f"rectification needs Sensor.STEREO, not {self.sensor.name}")
        self.rectifier = StereoRectifier(rect_left, rect_right, self.device)
        return self.rectifier

    def track_monocular(self, img: np.ndarray, timestamp: float, imu_measurements=None):
        """`System::TrackMonocular`: one grey image (H, W) and its time in
        seconds; for IMU_MONOCULAR, the IMU samples since the last frame as
        (t, acc (3,), gyro (3,)) tuples. Returns the frame's `FrameData`."""
        if self.sensor not in (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR):
            self._require(Sensor.MONOCULAR)
        if imu_measurements and self.sensor != Sensor.IMU_MONOCULAR:
            raise ValueError(f"a {self.sensor.name} System takes no IMU samples")
        for t, acc, gyro in imu_measurements or ():
            self.tracker.grab_imu(t, acc, gyro)
        out = self.tracker.process_frame(img, timestamp)
        self._post_frame()
        return out

    def track_stereo(self, img_left, img_right, timestamp: float):
        """`System::TrackStereo`: a rectified grey pair (H, W), remapped
        first when `enable_rectification` was called. Returns the left
        frame's `FrameData`."""
        self._require(Sensor.STEREO)
        if self.rectifier is not None:
            img_left, img_right = self.rectifier(img_left, img_right)
        out = self.tracker.process_stereo_frame(img_left, img_right, timestamp)
        self._post_frame()
        return out

    def track_rgbd(self, img, depth_map, timestamp: float):
        """`System::TrackRGBD`: a grey image and its registered depth map
        (H, W) in metres, <= 0 where there is none."""
        self._require(Sensor.RGBD)
        out = self.tracker.process_rgbd_frame(img, depth_map, timestamp)
        self._post_frame()
        return out

    def _require(self, sensor: Sensor):
        if self.sensor != sensor:
            raise ValueError(f"a {self.sensor.name} System takes no {sensor.name} frame")

    def _post_frame(self):
        self._tick_gba()
        if self.mapper.bad_imu:
            # The watchdog fired during mapping: too little motion to ever
            # initialize the IMU (`LocalMapping.cc:183-192`).
            self.reset_active_map()
        else:
            self._lost_recovery_fallback()

    def _tick_gba(self):
        """One chunk of a running background GBA after each frame (the
        reference's transient GBA thread, time-sliced)."""
        lc = self.loop_closer
        if lc is not None and lc.gba_async is not None and lc.gba_async.running:
            lc.gba_async.tick(self.store)

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
        self.mapper.preints = {}
        self.mapper.bad_imu = False
        if self.mapper.imu_init is not None:
            self.mapper.imu_init = ImuInitializer(self.mapper.imu_calib, mono=True)
        lc = self.loop_closer
        if lc is not None:  # a fresh database for the fresh map
            from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB

            kfdb = KeyFrameDB(lc.kfdb.voc, Kmax=new.state.Kmax)
            lc.kfdb = kfdb
            lc.store = new
            lc._pending = None
            lc.last_loop_kf = -10_000
            lc.loop_edges = []
            self.tracker.kfdb = kfdb

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
