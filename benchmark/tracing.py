"""The traced run (`--trace 1`): the port's spans, its host syncs, a
profiler trace of a fixed stretch of frames and the kernel calls in it.

- `orbslam3_tpu_torch.spans.Recorder` is active through the window; its
  `frame` is the window's frame index.
- Each frame's host syncs are counted as the runner counts them: PyTorch's
  sync debug mode at "warn", one warning per sync.
- Each frame's kind is classified as `run_sequence.main` classifies it, from
  the System's own counters: "not OK", "keyframe", "mapping stage" (an
  asynchronous mapping stage ran after it), "GBA chunk", "tracked".
- `torch.profiler` traces the traffic's `profile_frames` = (first, count)
  frames of the window, with a synchronize at each end so that the stretch
  holds all of its device work. The port's calls are marked with
  `record_function` ranges (a fixed list of call sites, and every
  `spans.span`), so that each idle gap of the device can be labelled by
  what the host was doing.
- Every B1 and B2 call in the stretch is recorded: B2's atlas shape, and
  B1's sizes with device copies of what its pair count needs. The copies
  run inside a "bench/harness" range, and the device work launched from it
  is left out of the device's busy time.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
import warnings
from typing import List

import torch

HARNESS = "bench/harness"
STRETCH = "bench/stretch"

# Call sites of the port marked in the trace: (module, class, method, label).
MARKED = (
    ("orbslam3_tpu_torch.system", "System", "track_monocular", "frame"),
    ("orbslam3_tpu_torch.system", "System", "_tick_gba", "after-frame tick"),
    ("orbslam3_tpu_torch.pipeline.tracking", "Tracker", "_extract", "extract"),
    ("orbslam3_tpu_torch.pipeline.tracking", "Tracker", "_process_with_features", "track"),
    ("orbslam3_tpu_torch.pipeline.async_mapping", "AsyncMapper", "tick", "mapping stage"),
    ("orbslam3_tpu_torch.pipeline.gba", "AsyncGBA", "tick", "GBA chunk"),
    ("orbslam3_tpu_torch.pipeline.loop_closing", "LoopCloser", "process_keyframe",
     "loop closing"),
    ("orbslam3_tpu_torch.pipeline.multimap", "MultiMapManager", "on_new_keyframe", "atlas"),
    ("orbslam3_tpu_torch.pipeline.multimap", "MultiMapManager", "on_frame_done", "atlas"),
)


def _marked(fn, label):
    @functools.wraps(fn)
    def call(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return call


class Tracer:
    def __init__(self, profile_frames):
        self.p0, self.pn = int(profile_frames[0]), int(profile_frames[1])
        self.frames: List[dict] = []  # per window frame: ms, kind, syncs, state
        self.b1: List[tuple] = []  # (n, m, valid_b, window, radius_shared)
        self.b2: List[tuple] = []  # atlas (H, W)
        self.spans: dict = {}
        self.prof = None
        self.profiled = (0, 0)  # window frames [first, last) the profiler saw
        self.paused_s = 0.0  # seconds the profiler's stop took (left out of the window)
        self._undo = []

    # -- installation ------------------------------------------------------------
    def attach(self, replay):
        import importlib

        from orbslam3_tpu_torch import spans

        self.replay = replay
        for mod, cls, meth, label in MARKED:
            klass = getattr(importlib.import_module(mod), cls)
            orig = klass.__dict__[meth]
            setattr(klass, meth, _marked(orig, label))
            self._undo.append((klass, meth, orig))
        orig_span = spans.span

        @contextlib.contextmanager
        def span(name):
            with torch.profiler.record_function(name), orig_span(name):
                yield

        spans.span = span
        self._undo.append((spans, "span", orig_span))
        self.recorder = spans.Recorder(replay.device.type == "cuda")

    def detach(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo = []

    # -- the window ---------------------------------------------------------------
    def start_window(self):
        self.recorder.__enter__()
        self._warn = warnings.catch_warnings(record=True)
        self._caught = self._warn.__enter__()
        warnings.simplefilter("always")
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode("warn")

    def before_frame(self, i: int):
        slam = self.replay.slam
        am = slam.async_mapper
        lc = slam.loop_closer
        self._busy = am is not None and not am.idle()
        self._gba = lc.gba_async if lc is not None else None
        self._chunks = self._gba.n_chunks if self._gba is not None else 0
        if i == self.p0:
            self._start_profiler(i)
        self.recorder.frame = i
        self._n_warn = len(self._caught)

    def after_frame(self, i: int, slam, state: str, ms: float):
        syncs = sum("synchroniz" in str(w.message) for w in self._caught[self._n_warn:])
        if state != "OK":
            kind = "not OK"
        elif slam.tracker.last_kf_frame_id == slam.tracker.last_frame.frame_id:
            kind = "keyframe"
        elif self._busy:
            kind = "mapping stage"
        elif self._gba is not None and self._gba.n_chunks != self._chunks:
            kind = "GBA chunk"
        else:
            kind = "tracked"
        self.frames.append(dict(ms=ms, kind=kind, syncs=syncs, state=state))
        if self.prof is not None and i == self.p0 + self.pn - 1:
            self._stop_profiler(i + 1)

    def end_window(self, n_frames: int):
        if self.prof is not None:
            self._stop_profiler(n_frames)
        if torch.cuda.is_available():
            torch.cuda.set_sync_debug_mode(0)
        self._warn.__exit__(None, None, None)
        self.recorder.__exit__(None, None, None)
        self.spans = self.recorder.result()
        self.detach()

    # -- the profiler -------------------------------------------------------------
    def _start_profiler(self, i: int):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._stretch = torch.profiler.record_function(STRETCH)
        self._stretch.__enter__()
        self.replay.probe.tracer = self
        self._first = i

    def _stop_profiler(self, end: int):
        t0 = time.perf_counter()
        self.replay.probe.tracer = None
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._stretch.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.profiled = (self._first, end)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.paused_s += time.perf_counter() - t0

    def harness_work(self):
        return torch.profiler.record_function(HARNESS)

    def on_b1(self, n, m, valid_b, window):
        radius_shared = False
        with self.harness_work():
            if window is not None:
                r = window[2]
                radius_shared = r.dim() == 0 or r.numel() == 1 or r.stride(0) == 0
                window = tuple(None if x is None else x.detach().clone() for x in window)
            valid_b = None if valid_b is None else valid_b.detach().clone()
        self.b1.append((n, m, valid_b, window, radius_shared))

    def on_b2(self, shape):
        self.b2.append(shape)


def device_timeline(events, labels=()):
    """From the profiler's events of the stretch: (window (start_ns, end_ns),
    device intervals [(start, end, name)] without the harness's own work,
    host ranges [(start, end, label)] of the marked calls)."""
    cpu, dev = [], []
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        else:
            cpu.append(e)
    stretch = [e for e in cpu if e.name() == STRETCH]
    w0 = min(e.start_ns() for e in stretch) if stretch else min(e.start_ns() for e in events)
    w1 = max(e.end_ns() for e in stretch) if stretch else max(e.end_ns() for e in events)
    harness = [(e.start_ns(), e.end_ns()) for e in cpu if e.name() == HARNESS]
    ids = set()
    if harness:
        for e in cpu:
            s = e.start_ns()
            if any(a <= s <= b for a, b in harness):
                ids.add(e.correlation_id())
    ids.discard(0)
    names = set(labels) | {STRETCH, HARNESS}
    out = []
    for e in dev:
        if e.is_user_annotation() or e.name() in names:
            continue
        if e.correlation_id() in ids or e.linked_correlation_id() in ids:
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t > s:
            out.append((s, t, e.name()))
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in cpu
            if e.name() in names - {STRETCH, HARNESS}]
    return (w0, w1), out, host


def busy_union(intervals) -> float:
    """Nanoseconds covered by the union of (start, end, ...) intervals."""
    total, end = 0, None
    for s, t, *_ in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return float(total)


def idle_gaps(window, intervals):
    """The device's idle gaps [(start, end)] inside the window."""
    gaps, cur = [], window[0]
    for s, t, *_ in sorted(intervals):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if window[1] > cur:
        gaps.append((cur, window[1]))
    return gaps


SHORT_GAP_NS = 20_000  # gaps under 20 us are counted together, unlabelled


def idle_by_label(gaps, host) -> dict:
    """Idle nanoseconds by what the host was doing: each gap of 20 us or
    more under the innermost marked host range around its middle ("harness"
    where none is open), the shorter ones under one name."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out: dict = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_NS:
            key = "gaps under 20 us"
        else:
            t, key = (a + b) / 2, "harness"
            for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if host[j][1] >= t:
                    key = host[j][2]
                    break
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def all_labels() -> set:
    return {m[3] for m in MARKED}
