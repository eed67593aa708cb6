"""The system under test, driven by sessions of one recording.

`Replay(cell, seed, device)` builds the port's `System` from the cell's
configuration the way `orbslam3_tpu_torch.run_sequence.main` builds it at
its defaults (asynchronous mapping, place recognition and the Atlas on the
shipped vocabulary, the configuration's Kmax and Pmax), makes the
traffic's recording from the seed (`synth.record`; the noise-free views are
ray-cast on a checkout's first run and kept in `.bench_cache/views`), and
cuts the per-frame IMU batches. The configuration's `sensor` picks the
entry the window drives: `System.track_monocular` for a monocular sensor,
`System.track_stereo` for a rectified pair (its right camera at
`camera.bf / camera.fx` m). `warm()` replays the traffic's warm-up extent
once; `window(seconds)` replays the recording back to back in a closed
loop, a fresh map (a new System on the loaded vocabulary) at each session's
start, each frame handed in when the previous one returned, until the
window's seconds have passed.

What the judge needs of each session is kept as it ends, without a host
read: the trajectory's host entries and a device copy of each map's
keyframes, points and IMU state (a few MB). A reservoir sample of the
window's frames, drawn from the seed, keeps the features each returned and
the inputs and outputs of every B1 call made while it ran.
"""

from __future__ import annotations

import gc
import time
from contextlib import nullcontext
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from benchmark import synth
from benchmark.cell import ROOT

JUDGE_FRAMES = 8  # window frames the judge samples
VIEWS = ROOT / ".bench_cache" / "views"  # the recordings' noise-free views
SENSORS = {  # configuration's sensor -> (the System's Sensor, a rectified pair)
    "monocular": ("MONOCULAR", False), "monocular_inertial": ("IMU_MONOCULAR", False),
    "stereo": ("STEREO", True), "stereo_inertial": ("IMU_STEREO", True)}


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for `seed` (any integer) and a stream number."""
    return np.random.default_rng([int(seed) % 2**64, stream])


def load_vocabulary(config: dict, device):
    """The configuration's vocabulary on `device` (None without place
    recognition), loaded once and shared by every session's System."""
    from orbslam3_tpu_torch.io import vocab_io

    s = config["system"]
    if not s["place_recognition"]:
        return None
    return vocab_io.load_binary_vocabulary(str(ROOT / s["vocabulary"]), device)


def build_system(config: dict, device, voc):
    """The System of `config` on `device` (the runner's defaults) with the
    loaded vocabulary `voc`."""
    from orbslam3_tpu_torch.ops import cameras as cam
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.system import Sensor, System

    c, o, s = config["camera"], config["orb"], config["system"]
    sensor = Sensor[SENSORS[config["sensor"]][0]]
    calib = None
    if config.get("imu") is not None:
        i = config["imu"]
        Tbc = np.asarray(i["tbc"], np.float64)
        calib = imu_ops.ImuCalib.create(
            Rbc=Tbc[:3, :3], tbc=Tbc[:3, 3], noise_gyro=i["noise_gyro"],
            noise_acc=i["noise_acc"], walk_gyro=i["walk_gyro"], walk_acc=i["walk_acc"],
            freq=i["frequency"], device=device)
    orb = feat.OrbParams(n_features=o["n_features"], n_levels=o["n_levels"],
                         scale_factor=o["scale_factor"], ini_th=float(o["ini_th_fast"]),
                         min_th=float(o["min_th_fast"]))
    slam = System(sensor, cam.CameraModel.PINHOLE,
                  [c["fx"], c["fy"], c["cx"], c["cy"], c["k1"], c["k2"], c["p1"], c["p2"]],
                  (c["width"], c["height"]), orb_params=orb, device=device,
                  bf=float(c.get("bf", 0.0)), Kmax=s["kmax"], Pmax=s["pmax"], fps=c["fps"],
                  imu_calib=calib)
    if s["async_mapping"]:
        slam.enable_async_mapping()
    if s["place_recognition"]:
        slam.enable_place_recognition(voc)
        if s["atlas"]:
            slam.enable_multimap(voc)
    return slam


class B1Call(NamedTuple):
    """One B1 call: its inputs and outputs as device copies."""

    desc_a: torch.Tensor
    desc_b: torch.Tensor
    valid_b: Optional[torch.Tensor]
    window: Optional[tuple]  # (uv_q, uv_k, radius, octave_k, octave_lo, octave_hi)
    out: tuple  # (best, second, argbest)


def _copy(x):
    return None if x is None else x.detach().clone()


class Probe:
    """Wraps the two kernel entry points wherever the port's modules look
    them up (`ops.cuda_match.hamming_top2`, `ops.cuda_fast.fast_score_nms`)
    and hands each call to the listeners that are on: `judge_calls` while a
    sampled frame runs, `tracer` while the profiler runs."""

    def __init__(self):
        from orbslam3_tpu_torch.ops import cuda_fast, cuda_match

        self._mods = (cuda_match, cuda_fast)
        self._orig = (cuda_match.hamming_top2, cuda_fast.fast_score_nms)
        self.judge_calls: Optional[list] = None
        self.tracer = None
        probe = self

        def hamming_top2(desc_a, desc_b, valid_b=None, window=None):
            out = probe._orig[0](desc_a, desc_b, valid_b, window)
            if desc_a.shape[0] and (probe.judge_calls is not None or probe.tracer is not None):
                probe._b1(desc_a, desc_b, valid_b, window, out)
            return out

        def fast_score_nms(img, min_th, ini_th):
            out = probe._orig[1](img, min_th, ini_th)
            if probe.tracer is not None:
                probe.tracer.on_b2(tuple(img.shape))
            return out

        cuda_match.hamming_top2 = hamming_top2
        cuda_fast.fast_score_nms = fast_score_nms

    def _b1(self, desc_a, desc_b, valid_b, window, out):
        win = None if window is None else tuple(window)
        if self.tracer is not None:
            self.tracer.on_b1(desc_a.shape[0], desc_b.shape[0], valid_b, win)
        if self.judge_calls is not None:
            with self.tracer.harness_work() if self.tracer is not None else nullcontext():
                self.judge_calls.append(B1Call(
                    _copy(desc_a), _copy(desc_b), _copy(valid_b),
                    None if win is None else tuple(_copy(x) for x in win),
                    tuple(_copy(x) for x in out)))

    def close(self):
        self._mods[0].hamming_top2, self._mods[1].fast_score_nms = self._orig


class Sample(NamedTuple):
    """A sampled frame of the window: the image index, what it returned
    and the B1 calls made while it ran."""

    frame: int  # index into the recording
    features: object  # the returned FrameData's Features
    b1: list


class Session(NamedTuple):
    """What one session left for the judge."""

    index: int
    n_frames: int  # frames handed in
    states: list  # tracking state name per frame
    trajectory: list  # the tracker's host entries (ts, id(store), ref, R_cr, t_cr)
    maps: dict  # id(store) -> device copies of its keyframes, points and IMU state
    imu_initialized: bool
    viba1: bool  # the IMU state's first refinement (VIBA1) has run
    imu_init_frame: Optional[int]
    loop_frames: list  # frames after which a loop closed


def snapshot_map(store) -> dict:
    s = store.state
    out = {k: getattr(s, k).detach().clone() for k in (
        "kf_R", "kf_t", "kf_valid", "kf_vel", "kf_bias_g", "mp_pos", "mp_valid")}
    out["n_kf"] = int(store.n_kf)
    out["kf_ts"] = np.array(store.kf_ts, copy=True)
    return out


class Replay:
    def __init__(self, cell, seed: int, device, tracer=None):
        self.cell, self.seed, self.device, self.tracer = cell, int(seed), device, tracer
        tr, cam = cell.traffic, cell.config["camera"]
        self.n = int(tr["session_frames"])
        self.stereo = SENSORS[cell.config["sensor"]][1]
        self.setup_parts = {}  # seconds of each part of the set-up
        t0 = time.perf_counter()
        self.rec = synth.record(
            self.seed % 2**64, self.n, t_loop=float(tr["lap_seconds"]), imu=bool(tr["imu"]),
            density=float(tr["texture_density"]), wh=(cam["width"], cam["height"]),
            intr=(cam["fx"], cam["fy"], cam["cx"], cam["cy"]),
            baseline=cam["bf"] / cam["fx"] if self.stereo else None,
            kidnap=tr.get("kidnap"), blind=tr.get("blind"), cache_dir=VIEWS)
        self.batches = (synth.imu_batches(self.rec.ts, self.rec.imu) if tr["imu"]
                        else [None] * self.n)
        t1 = time.perf_counter()
        self.voc = load_vocabulary(cell.config, device)
        self.slam = build_system(cell.config, device, self.voc)
        self.setup_parts.update(recording=t1 - t0, system=time.perf_counter() - t1)
        self.probe = Probe()
        if tracer is not None:
            tracer.attach(self)
        self.sessions: List[Session] = []
        self.samples: List[Sample] = []
        self.frame_ms: List[float] = []  # every frame returned inside the window
        self.failed = 0
        self.window_frames = 0

    # -- one session ---------------------------------------------------------
    def _begin_session(self):
        self._states, self._imu_frame, self._loops = [], None, []
        self._loops0 = self.slam.n_loops_closed

    def _track(self, k: int):
        slam, img, t, imu = self.slam, self.rec.imgs[k], float(self.rec.ts[k]), self.batches[k]
        if self.stereo:
            fd = slam.track_stereo(img[0], img[1], t, imu_measurements=imu or None)
        else:
            fd = slam.track_monocular(img, t, imu_measurements=imu or None)
        self._states.append(slam.tracking_state.name)
        if self._imu_frame is None and slam.mapper.imu_initialized:
            self._imu_frame = k
        if slam.n_loops_closed > self._loops0 + len(self._loops):
            self._loops.append(k)
        return fd

    def _end_session(self, index: int) -> Session:
        slam = self.slam
        stores = {id(e[1]): e[1] for e in slam.tracker.trajectory}
        stores.setdefault(id(slam.store), slam.store)
        traj = [(ts, id(store), ref, R_cr, t_cr)
                for ts, store, ref, R_cr, t_cr in slam.tracker.trajectory]
        return Session(index, len(self._states), self._states, traj,
                       {k: snapshot_map(s) for k, s in stores.items()},
                       bool(slam.mapper.imu_initialized),
                       bool(getattr(slam.mapper.imu_init, "viba1_done", False)),
                       self._imu_frame, self._loops)

    # -- set-up --------------------------------------------------------------
    def warm(self):
        """The traffic's warm-up extent: its first `warm_frames` frames as a
        session of their own; the window starts on a fresh System."""
        t0 = time.perf_counter()
        self._begin_session()
        for k in range(int(self.cell.traffic["warm_frames"])):
            self._track(k)
        self._fresh_system()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.setup_parts["warm"] = time.perf_counter() - t0

    # -- the measured window -------------------------------------------------
    def window(self, seconds: float):
        """Sessions back to back for `seconds`, `JUDGE_FRAMES` frames of them
        kept for the judge. Returns the window's length."""
        rng, n_sample = rng_for(self.seed, 1), JUDGE_FRAMES
        tracer, probe = self.tracer, self.probe
        reservoir: List[Sample] = []
        index, k, i = 0, 0, 0
        self._begin_session()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        while True:
            if k == self.n:  # the session is over: keep it, start the next
                self.sessions.append(self._end_session(index))
                self._fresh_system()
                index, k = index + 1, 0
                self._begin_session()
            slot = i if i < n_sample else int(rng.integers(0, i + 1))
            take = slot < n_sample
            calls = [] if take else None
            probe.judge_calls = calls
            if tracer is not None:
                tracer.before_frame(i)
            t0 = time.perf_counter()
            fd = self._track(k)
            t1 = time.perf_counter()
            probe.judge_calls = None
            if tracer is not None:
                tracer.after_frame(i, self.slam, self._states[-1], (t1 - t0) * 1e3)
            if take:
                s = Sample(k, fd.features, calls)
                if slot < len(reservoir):
                    reservoir[slot] = s
                else:
                    reservoir.append(s)
            if tracer is not None:  # the profiler's own processing is not the window's
                deadline = t_start + seconds + tracer.paused_s
            if t1 > deadline:
                break
            self.frame_ms.append((t1 - t0) * 1e3)
            # A frame fails when tracking is not OK after the session's first OK frame.
            self.failed += self._states[-1] != "OK" and "OK" in self._states
            k, i = k + 1, i + 1
        self.window_frames = i
        self.sessions.append(self._end_session(index))
        self.samples = sorted(reservoir, key=lambda s: s.frame)
        return seconds

    def _fresh_system(self):
        """A new System on the loaded vocabulary for the next session, as the
        runner builds one for each recording: nothing of the last session's
        mapper, loop closer or global BA is left. The old System is freed
        first; its objects refer to each other, so that takes a collection."""
        self.slam = None
        gc.collect()
        self.slam = build_system(self.cell.config, self.device, self.voc)

    def free(self):
        """Drop the program's state (the sessions' copies stay)."""
        self.probe.close()
        self.slam = None
