"""The public entry of the port — `System` of `orbslam3_tpu/system.py`
(`ORB_SLAM3::System`) for every sensor of ORB-SLAM3: monocular, rectified
stereo, RGB-D, monocular-inertial and stereo-inertial, with a pinhole or a
Kannala-Brandt 8 (fisheye) camera, and for stereo a two-camera rig.

`System(sensor, camera_model, params, (W, H), orb, device, bf=...)`
wires a `Tracker` and a synchronous `LocalMapper` over one `MapStore` on
`device`: the first CUDA card when `device` is None (it raises where there
is none and never falls back), the CPU (the kernels' plain versions) only
when the caller asks for it with `device="cpu"`. `bf` is the stereo
baseline times fx (ORB-SLAM3's `Camera.bf`), for a rectified pair and
RGB-D; `camera2 = (params2, Tlr, lap1, lap2)` makes the stereo sensors a
two-camera rig (ORB-SLAM3's `Camera2.*`, the right camera's pose in the
left camera's frame, 4x4, and each camera's lapping area, a (u_lo, u_hi)
range or None for the whole width): its frames are matched in the lapping
areas and triangulated, and its pose solves gain right-camera rows;
`imu_calib` (`ops/imu.py::ImuCalib`) the IMU's extrinsics and noise, for
`Sensor.IMU_MONOCULAR` and `Sensor.IMU_STEREO` (whose IMU initialization
keeps the scale the stereo depth fixed). `track_monocular(img, t[,
imu_measurements])`, `track_stereo(left, right, t[, imu_measurements])` and
`track_rgbd(img, depth, t)` run a frame (and, on a new keyframe, its mapping
pass, then the keyframe's hand-off to loop closing; a frame older than the
last one first resets the active map, and so does an inertial gap of more
than 1 s, or the bad-IMU watchdog) and `get_trajectory()` reads the camera
centres back through the current keyframe poses.
`enable_rectification(left, right)` remaps raw stereo pairs on the device
before `track_stereo`. `enable_place_recognition(vocabulary)` attaches a
keyframe database and a `LoopCloser` (relocalization of a lost map, loop
closing, the background global BA, one chunk of it after each frame), all
on the system's device (an inertial one closes loops with the scale fixed
and the 4-DoF essential graph). `enable_multimap(vocabulary)` adds the
Atlas (`pipeline/multimap.py`): a map that stays LOST is stored and a
fresh one starts (an inertial gap after the IMU initialization does the
same), and place recognition merges the active map back into a stored one
(the weld fuse, the weld BA, the essential graph, the post-merge GBA).
`save_atlas(path)` / `load_atlas(path)` write and read every map in the JAX
package's format (a loaded atlas goes onto the system's device, and
tracking relocalizes into it); `activate_localization_mode()` tracks
against a frozen map (no keyframes, so no mapping, loop closing or map
storing); `save_trajectory_tum`, `_kitti`, `_euroc` and
`save_keyframe_trajectory_tum`, `_euroc` write the trajectory files
(`io/trajectory.py`). `enable_async_mapping()` slices each keyframe's
mapping pass over the frames after it (`pipeline/async_mapping.py`), and
`enable_viewer(port)` serves the live viewer (`viz/server.py`);
`shutdown()` drains both and a background GBA. The settings files, the
dataset loaders, the sequence runner and the stream server are
`config.py`, `io/datasets.py`, `run_sequence.py` and `serve_stream.py`.
`enable_distributed(group)` makes the system one SPMD replica of a
`torch.distributed` group (BASELINE config 5): every rank replays the same
frames, the global BA (background chunks, the loop closer's synchronous
one, the post-merge one) runs point-partitioned over the group and the
Atlas's merge queries are scored shard-wise (`parallel/`).
"""

from __future__ import annotations

import enum
from typing import Tuple

import numpy as np
import torch

from orbslam3_tpu_torch import spans
from orbslam3_tpu_torch.atlas.store import MapStore
from orbslam3_tpu_torch.device import require_cuda
from orbslam3_tpu_torch.io import trajectory as traj_io
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


_INERTIAL = (Sensor.IMU_MONOCULAR, Sensor.IMU_STEREO)
_STEREO = (Sensor.STEREO, Sensor.IMU_STEREO)


class System:
    def __init__(self, sensor: Sensor, camera_model: cam.CameraModel, camera_params,
                 img_wh: Tuple[int, int], orb_params: feat.OrbParams = feat.OrbParams(),
                 device=None, bf: float = 0.0, camera2=None, Kmax: int = 256,
                 Pmax: int = 16384, fps: float = 20.0, imu_calib: imu_ops.ImuCalib | None = None):
        inertial = sensor in _INERTIAL
        if inertial and imu_calib is None:
            raise ValueError(f"{sensor.name} needs imu_calib")
        if camera2 is not None and sensor not in _STEREO:
            raise ValueError(f"a two-camera rig (camera2) is a stereo sensor, not {sensor.name}")
        self.sensor = sensor
        self.device = require_cuda() if device is None else torch.device(device)
        if inertial:  # the calibration on the system's device
            imu_calib = imu_ops.ImuCalib(*(x.to(self.device) for x in imu_calib))
        self.store = MapStore(Kmax=Kmax, Pmax=Pmax, Nf=sum(feat.level_budgets(orb_params)),
                              device=self.device)
        params = torch.from_numpy(np.array(camera_params, np.float32)).to(self.device)
        self.tracker = Tracker(camera_model, params, img_wh, self.store, orb_params, bf=bf,
                               fps=fps, imu_calib=imu_calib if inertial else None,
                               camera2=camera2)
        self.mapper = LocalMapper(camera_model, params, img_wh, self.store, orb_params, bf=bf,
                                  imu_calib=imu_calib if inertial else None,
                                  mono=sensor == Sensor.IMU_MONOCULAR)
        # Metric-depth sensors (a rectified pair, RGB-D, a two-camera rig)
        # keep every observation in the local BA.
        stereo_like = sensor in (Sensor.STEREO, Sensor.RGBD, Sensor.IMU_STEREO)
        self.tracker.is_stereo_like = stereo_like
        self.mapper.stereo_like = stereo_like
        self.mapper.tracker = self.tracker
        self.rectifier = None
        self.tracker.new_kf_callback = self._on_new_keyframe
        self.tracker.anomaly_cb = self._on_timestamp_anomaly
        self.loop_closer = None
        self.multimap = None  # MultiMapManager (enable_multimap)
        # Consumers of a keyframe after its mapping pass (the LocalMapping ->
        # LoopClosing hand-off, `LocalMapping.cc:280`).
        self._kf_downstream = []
        self._lost_streak = 0
        self.async_mapper = None  # AsyncMapper (enable_async_mapping)
        self.viewer = None  # LiveViewer (enable_viewer)
        self.dist = None  # DistributedContext (enable_distributed)

    def _on_new_keyframe(self, slot: int, initial: bool = False, preint=None) -> bool:
        """The keyframe's mapping pass (with its preintegration from the
        previous keyframe), then its hand-off to loop closing; with
        asynchronous mapping, its submission to the mapper (the initial map's
        pass still runs at once). Returns whether a loop correction moved the
        map (fault C12)."""
        loops = self.n_loops_closed
        if self.async_mapper is not None:
            self.async_mapper.submit(slot, initial=initial, preint=preint)
            return self.n_loops_closed > loops
        self.mapper.process_keyframe(slot, initial=initial, preint=preint)
        for d in self._kf_downstream:
            d(slot)
        return self.n_loops_closed > loops

    def enable_async_mapping(self):
        """Overlap mapping with tracking (ORB-SLAM3's LocalMapping thread,
        `System.cc:138`): a keyframe's mapping pass runs sliced, one stage
        after each tracked frame, and loop closing and the Atlas see the
        keyframe when its pass completes (`pipeline/async_mapping.py`)."""
        from orbslam3_tpu_torch.pipeline.async_mapping import AsyncMapper

        self.async_mapper = AsyncMapper(self.mapper, self._kf_downstream)
        self.tracker.mapper_idle_query = self.async_mapper.idle
        self.tracker.mapping_interrupt = self.async_mapper.interrupt
        self.tracker.mapping_queue_len = self.async_mapper.queue_len
        return self.async_mapper

    def enable_viewer(self, port: int = 0, **kw):
        """Serve the live viewer over HTTP (ORB-SLAM3's Viewer, FrameDrawer
        and MapDrawer, `System.cc:175-177`; `viz/server.py`). Its HTTP
        threads read only the host snapshot that each frame leaves. Returns
        the viewer; `viewer.port` is the bound port (0 asks for a free one)."""
        from orbslam3_tpu_torch.viz.server import LiveViewer

        self.viewer = LiveViewer(self, port=port, **kw)
        return self.viewer

    def enable_place_recognition(self, vocabulary, run_gba: bool = True,
                                 min_bow_matches: int = 20, min_sim3_inliers: int = 20,
                                 consecutive: int = 3, async_gba: bool = True):
        """Attach a vocabulary (`ops/bow.py::Vocabulary`, moved to the
        system's device): a keyframe database for relocalization and a
        `LoopCloser` fed every keyframe after its mapping pass
        (`System.cc:83-95`). `consecutive` keyframes must confirm a loop
        (`LoopClosing.cc:367`); `async_gba` runs the global BA in chunks
        after the frames instead of at once. An inertial system's loop closer
        is inertial: Sim3 steps with the scale fixed, the 4-DoF essential
        graph."""
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
            consecutive=consecutive, inertial=self.sensor in _INERTIAL,
            img_wh=t.img_wh_t, scale_table=t.scale_table, mapper=self.mapper, bf=t.bf)
        self.loop_closer.dist = self.dist
        if run_gba and async_gba:
            self.loop_closer.gba_async = AsyncGBA(t.model, t.params, t.sigma2_table, bf=t.bf,
                                                  dist=self.dist)
        self._kf_downstream.append(self.loop_closer.process_keyframe)

    def enable_distributed(self, group=None):
        """Dispatch the whole-map work over a `torch.distributed` group (the
        world group by default; BASELINE config 5, "map merging + global BA
        across 2 hosts"): the global BA (the background chunks, the loop
        closer's synchronous one, the post-merge one) runs the
        point-partitioned dense-Schur solve of `parallel/ba_sharded.py` (one
        all-reduce of the reduced camera system per LM iteration), and the
        Atlas's merge queries the sharded keyframe-database query of
        `parallel/kfdb_sharded.py`. Every rank must replay the same frames
        (SPMD replicas) and reach each collective together. Any order
        relative to `enable_place_recognition` / `enable_multimap`. Returns
        the `DistributedContext`."""
        from orbslam3_tpu_torch.parallel.context import DistributedContext

        self.dist = DistributedContext(group)
        lc = self.loop_closer
        if lc is not None:
            lc.dist = self.dist
            if lc.gba_async is not None:
                lc.gba_async.dist = self.dist
        return self.dist

    def enable_multimap(self, vocabulary, **kw):
        """The Atlas's multi-map (`Tracking::CreateMapInAtlas`,
        `LoopClosing::MergeLocal`): a map that stays LOST is stored and a
        fresh one starts; a stored map found again by place recognition
        takes the active map in. The vocabulary goes to the system's device;
        `kw` are `MultiMapManager`'s thresholds."""
        from orbslam3_tpu_torch.pipeline.multimap import MultiMapManager

        self.multimap = MultiMapManager(self, vocabulary, **kw)
        self._kf_downstream.append(self.multimap.on_new_keyframe)

    @property
    def n_loops_closed(self) -> int:
        return 0 if self.loop_closer is None else self.loop_closer.n_loops_closed

    def activate_localization_mode(self):
        """`System::ActivateLocalizationMode`: tracking goes on against the
        frozen map; no keyframes, so no mapping and no loop closing."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """`System::DeactivateLocalizationMode`."""
        self.tracker.only_tracking = False

    def shutdown(self):
        """`System::Shutdown` (`System.cc:474`): drain the asynchronous
        mapper, run a background GBA to its end, close the viewer."""
        if self.async_mapper is not None:
            self.async_mapper.flush()
        lc = self.loop_closer
        if lc is not None and lc.gba_async is not None:
            lc.gba_async.join(self.store)
        if self.viewer is not None:
            self.viewer.close()

    def _on_timestamp_anomaly(self, kind: str):
        """`Tracking::Track` (Tracking.cc:987-1031): a reordered frame
        ("reorder") or an inertial gap of more than 1 s before the IMU
        initialization ("gap_uninit") resets the active map; a gap after it
        ("gap_init") keeps the gravity-aligned map in the Atlas and starts a
        new one, or resets without an Atlas."""
        if kind == "gap_init" and self.multimap is not None:
            self.multimap._create_map()
        else:
            self.reset_active_map()

    def enable_rectification(self, rect_left, rect_right):
        """Raw (unrectified) pinhole stereo: the reference's LEFT./RIGHT.
        K/D/R/P blocks (any objects with K, D, R, P, width and height). The
        grids are built once on the host; `track_stereo` then remaps each
        raw pair on the device before extraction. Returns the rectifier."""
        from orbslam3_tpu_torch.ops.rectify import StereoRectifier

        if self.sensor not in _STEREO:
            raise ValueError(f"rectification needs a stereo sensor, not {self.sensor.name}")
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
        with spans.span("frame"):
            for t, acc, gyro in imu_measurements or ():
                self.tracker.grab_imu(t, acc, gyro)
            out = self.tracker.process_frame(img, timestamp)
            self._post_frame(img)
        return out

    def track_stereo(self, img_left, img_right, timestamp: float, imu_measurements=None):
        """`System::TrackStereo`: a grey pair (H, W), rectified (remapped
        first when `enable_rectification` was called) or, with `camera2`, a
        two-camera rig's pair; for IMU_STEREO, the IMU samples since the
        last frame as (t, acc (3,), gyro (3,)) tuples. Returns the left
        frame's `FrameData`."""
        if self.sensor not in _STEREO:
            self._require(Sensor.STEREO)
        if imu_measurements and self.sensor != Sensor.IMU_STEREO:
            raise ValueError(f"a {self.sensor.name} System takes no IMU samples")
        with spans.span("frame"):
            for t, acc, gyro in imu_measurements or ():
                self.tracker.grab_imu(t, acc, gyro)
            if self.rectifier is not None:
                img_left, img_right = self.rectifier(img_left, img_right)
            if self.tracker.camera2 is not None:
                out = self.tracker.process_stereo_fisheye_frame(img_left, img_right, timestamp)
            else:
                out = self.tracker.process_stereo_frame(img_left, img_right, timestamp)
            self._post_frame(img_left)
        return out

    def track_rgbd(self, img, depth_map, timestamp: float):
        """`System::TrackRGBD`: a grey image and its registered depth map
        (H, W) in metres, <= 0 where there is none."""
        self._require(Sensor.RGBD)
        with spans.span("frame"):
            out = self.tracker.process_rgbd_frame(img, depth_map, timestamp)
            self._post_frame(img)
        return out

    def _require(self, sensor: Sensor):
        if self.sensor != sensor:
            raise ValueError(f"a {self.sensor.name} System takes no {sensor.name} frame")

    def _post_frame(self, img):
        self._tick_gba()
        if self.mapper.bad_imu:
            # The watchdog fired during mapping: too little motion to ever
            # initialize the IMU (`LocalMapping.cc:183-192`).
            self.reset_active_map()
        elif self.multimap is not None:
            self.multimap.on_frame_done()
        else:
            self._lost_recovery_fallback()
        if self.viewer is not None:
            self.viewer.update(img, self.tracker.last_frame)

    def _tick_gba(self):
        """After each frame, one stage of an asynchronous mapping pass (the
        reference's LocalMapping thread, time-sliced) and one chunk of a
        running background GBA (its transient GBA thread). Where the stage
        completed an IMU stage (the initialization, VIBA1, VIBA2, a scale
        refinement), the last frame's pose and velocity are re-predicted from
        its keyframe's new state (`Tracker.update_frame_imu`, fault C20), and
        so it is after a loop correction of an IMU-initialized map (its
        keyframes' poses and velocities turned, `LoopCloser._correct_loop`);
        where else the stage, or the loop closing or merge after it, moved the
        map, the last frame follows it (`Tracker.follow_map`, fault C17)."""
        with spans.span("after-frame tick"):
            am = self.async_mapper
            if am is not None and not am.idle():
                tr = self.tracker
                loops, store, tr._map_transformed = self.n_loops_closed, self.store, False
                stages = self.mapper.n_imu_stages
                am.tick()
                staged = self.mapper.n_imu_stages > stages or self.n_loops_closed > loops
                if staged and self.store is store and tr.imu_ready:
                    tr.update_frame_imu()
                elif self.n_loops_closed > loops or tr._map_transformed or self.store is not store:
                    tr.follow_map()
            lc = self.loop_closer
            if lc is not None and lc.gba_async is not None and lc.gba_async.running:
                lc.gba_async.tick(self.store)

    def _lost_recovery_fallback(self):
        """Hard-LOST policy without a multi-map atlas: a map of <= 10
        keyframes that stays LOST for 5 frames is discarded and
        initialization restarts; a larger one waits for relocalization.
        Localization mode never changes the map."""
        if self.tracker.state != TrackState.LOST or self.tracker.only_tracking:
            self._lost_streak = 0
            return
        self._lost_streak += 1
        if self._lost_streak >= 5 and self.store.n_kf <= 10:
            self.reset_active_map()
            self._lost_streak = 0

    def reset(self):
        """`System::Reset`: drop every map, database and the trajectory."""
        self.tracker.reset_map_state(full=True)
        self._swap_fresh_store()
        if self.multimap is not None:
            self.multimap.atlas.maps = [self.store]
            self.multimap.atlas.active_idx = 0
            self.multimap.kfdbs = {}
            self.multimap.lost_streak = 0

    def reset_active_map(self):
        """`System::ResetActiveMap`: drop the active map and its trajectory
        entries; the Atlas's stored maps and their entries stay."""
        old = self.store
        self.tracker.reset_map_state(full=False)
        self._swap_fresh_store()
        if self.multimap is not None:
            maps = self.multimap.atlas.maps
            maps[maps.index(old)] = self.store
            self.multimap.kfdbs.pop(old, None)
            self.multimap.lost_streak = 0

    def _swap_fresh_store(self):
        s = self.store.state
        self._attach_store(MapStore(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device=self.device))

    def _point_at(self, store: MapStore):
        """The one place that points the tracker, the mapper and the loop
        closer at `store` as the active map."""
        self.store = store
        self.tracker.store = store
        self.mapper.store = store
        self.mapper._covis_pin = None
        if self.loop_closer is not None:
            self.loop_closer.store = store

    def _attach_store(self, new: MapStore):
        """Make `new` the active map with fresh per-map state: the mapper's
        recent points, preintegrations and IMU initialization, and the loop
        closer's keyframe database (the tracker's too), pending loop and
        loop edges. A background GBA of the previous map is aborted here
        (`AsyncGBA.tick` folds into the map it is given and checks nothing)."""
        if self.async_mapper is not None:  # its in-flight keyframes are stale
            self.async_mapper.abort()
        self._point_at(new)
        self.mapper.recent_mp = []
        self.mapper.preints = {}
        self.mapper.bad_imu = False
        if self.mapper.imu_init is not None:
            self.mapper.imu_init = ImuInitializer(self.mapper.imu_calib,
                                                  mono=self.sensor == Sensor.IMU_MONOCULAR)
        lc = self.loop_closer
        if lc is not None:  # a fresh database for the fresh map
            from orbslam3_tpu_torch.atlas.kfdb import KeyFrameDB

            kfdb = KeyFrameDB(lc.kfdb.voc, Kmax=new.state.Kmax)
            lc.kfdb = kfdb
            lc._pending = None
            lc.last_loop_kf = -10_000
            lc.loop_edges = []
            self.tracker.kfdb = kfdb
            if lc.gba_async is not None:
                lc.gba_async.abort()

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

    # -- Atlas checkpoint and resume (`System::SaveAtlas` / `LoadAtlas`) ---
    def save_atlas(self, path: str):
        """Write every map: the Atlas's with `enable_multimap`, else the
        active map as an Atlas of one."""
        from orbslam3_tpu_torch.atlas.atlas import Atlas

        if self.multimap is not None:
            atlas = self.multimap.atlas
        else:
            s = self.store.state
            atlas = Atlas(Kmax=s.Kmax, Pmax=s.Pmax, Nf=s.Nf, device=self.device,
                          maps=[self.store])
        atlas.imu_initialized = bool(self.tracker.imu_ready)
        atlas.save(path)

    def load_atlas(self, path: str):
        """Read a saved Atlas onto the system's device and make its active map
        the system's; the keyframe databases are rebuilt from the stored
        descriptors (derived state, as the reference's PostLoad rewiring,
        `KeyFrameDatabase.cc:899-927`), and tracking drops to LOST so that
        relocalization attaches the next frames to the loaded map."""
        from orbslam3_tpu_torch.atlas.atlas import Atlas

        atlas = Atlas.load(path, self.device)
        act = atlas.active
        self._attach_store(act)
        if self.loop_closer is not None:
            self._reindex_kfdb(self.loop_closer.kfdb, act)
        if self.multimap is not None:
            self.multimap.atlas = atlas
            self.multimap.kfdbs = {}
            self.multimap.lost_streak = 0
            for m in atlas.maps:
                self._reindex_kfdb(self.multimap._kfdb(m), m)
        tr = self.tracker
        tr.last_frame = None
        tr.init_frame = None
        tr.ref_kf = -1
        tr.last_kf_id = -1
        tr.velocity = None
        tr.pre_from_kf = None
        tr.frame_prior = None
        tr._ref_pose = None
        tr.imu_ready = bool(atlas.imu_initialized) and tr.imu_calib is not None
        tr.state = TrackState.LOST if act.n_kf > 0 else TrackState.NOT_INITIALIZED

    @staticmethod
    def _reindex_kfdb(db, store: MapStore):
        s = store.state
        kf_valid = s.kf_valid.cpu().numpy()
        for k in range(store.n_kf):
            if kf_valid[k]:
                db.add(k, s.kf_desc[k], s.kf_feat_valid[k])

    # -- trajectory files (`System::SaveTrajectory*`, System.cc:524-1010) --
    def _largest_map(self) -> MapStore:
        maps = [self.store] if self.multimap is None else list(self.multimap.atlas.maps)
        return max(maps, key=lambda m: int(m.state.kf_valid[: max(m.n_kf, 1)].sum()))

    def save_trajectory_tum(self, path: str):
        """`System::SaveTrajectoryTUM`: every tracked frame's Twc."""
        rows = self.tracker.reconstructed_trajectory()
        traj_io.save_tum(path, [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])

    def save_trajectory_kitti(self, path: str):
        """`System::SaveTrajectoryKITTI`: one 3x4 row-major Twc per line."""
        rows = self.tracker.reconstructed_trajectory()
        traj_io.save_kitti(path, [r[1] for r in rows], [r[2] for r in rows])

    def save_trajectory_euroc(self, path: str):
        """`System::SaveTrajectoryEuRoC` (`System.cc:599-712`): the frames
        tracked in the Atlas's largest map (by keyframes), re-rooted at its
        first keyframe, as body-frame poses through Tbc for the inertial
        sensors and camera poses otherwise. Trajectory entries always name a
        live keyframe (culling re-roots them), so no parent chain is walked."""
        big = self._largest_map()
        kv = big.state.kf_valid[: big.n_kf].cpu().numpy()
        if not kv.any():
            open(path, "w").close()
            return
        first = int(np.flatnonzero(kv)[0])
        kf_R = big.state.kf_R.cpu().numpy()
        kf_t = big.state.kf_t.cpu().numpy()
        R0wc = kf_R[first].T  # the first keyframe's Twc: the new world frame
        t0wc = -R0wc @ kf_t[first]
        tr = self.tracker
        inertial = tr.imu_calib is not None
        rows_ts, rows_R, rows_t = [], [], []
        for ts, store_e, ref, R_cr, t_cr in tr.trajectory:
            if store_e is not big:
                continue
            if ref >= 0:
                R_cw = R_cr @ kf_R[ref]
                t_cw = R_cr @ kf_t[ref] + t_cr
            else:
                R_cw, t_cw = R_cr, t_cr
            R_cw2 = R_cw @ R0wc  # Tcw' = Tcw Twc(first)
            t_cw2 = R_cw @ t0wc + t_cw
            if inertial:
                R_cw2, t_cw2 = tr.Rbc @ R_cw2, tr.Rbc @ t_cw2 + tr.tbc
            Rw = R_cw2.T
            rows_R.append(Rw)
            rows_t.append(-Rw @ t_cw2)
            rows_ts.append(ts)
        traj_io.save_euroc(path, rows_ts, rows_R, rows_t)

    def save_keyframe_trajectory_tum(self, path: str):
        """`System::SaveKeyFrameTrajectoryTUM`: the active map's keyframes in
        slot order."""
        s = self.store.state
        ids = np.flatnonzero(s.kf_valid.cpu().numpy()[: self.store.n_kf])
        kf_R = s.kf_R.cpu().numpy()
        kf_t = s.kf_t.cpu().numpy()
        traj_io.save_tum(path, self.store.kf_ts[ids], [kf_R[i].T for i in ids],
                         [-kf_R[i].T @ kf_t[i] for i in ids])

    def save_keyframe_trajectory_euroc(self, path: str):
        """`System::SaveKeyFrameTrajectoryEuRoC` (`System.cc:722`): the
        largest map's keyframes in slot order, body frame for the inertial
        sensors."""
        big = self._largest_map()
        s = big.state
        ids = np.flatnonzero(s.kf_valid.cpu().numpy()[: big.n_kf])
        kf_R = s.kf_R.cpu().numpy()
        kf_t = s.kf_t.cpu().numpy()
        tr = self.tracker
        Rwl, twl = [], []
        for i in ids:
            R_cw, t_cw = kf_R[i], kf_t[i]
            if tr.imu_calib is not None:
                R_cw, t_cw = tr.Rbc @ R_cw, tr.Rbc @ t_cw + tr.tbc
            Rwl.append(R_cw.T)
            twl.append(-R_cw.T @ t_cw)
        traj_io.save_euroc(path, big.kf_ts[ids], Rwl, twl)
