"""Timed spans and counters of the port's host path.

`with spans.span(name):` at a call site records, while a `Recorder` is
active, the host clock and, on CUDA, two events around the call (none while
the current stream captures a CUDA graph). While the autograd profiler is
on (`torch.profiler.profile`), the span also opens
`torch.profiler.record_function(name)`, so every span sits in any profiler
trace on the profiler's own clock. With no recorder active, `span` reads one
module global and returns one shared no-op context: no clock, no event, no
range. `spans.count(name, n)` adds `n` under `count/<name>` while a
recorder is active. Call sites go through the module attribute
(`spans.span(...)`), so a wrapper set on it applies everywhere.

The families:

- per frame: `frame` (`System.track_monocular`, `track_stereo`,
  `track_rgbd`), `after-frame tick` (`System._tick_gba`);
- extraction: `extract` (`Tracker._extract`) and in it `extract/atlas`,
  `extract/fast_nms` (kernel B2), `extract/select`, `extract/describe`;
- tracking: `track` (`Tracker._process_with_features`) and in it
  `track/inputs`, `track/motion_model`, `track/ref_kf`, `track/local_map`,
  `track/fetch`, `track/keyframe`, `track/relocalize`; a rig's
  `fisheye match` and `pose solve with right rows`;
- inertial tracking: `preintegration`, `pose-inertial (last frame)`,
  `pose-inertial (last keyframe)`;
- mapping: `mapping stage` (`AsyncMapper.tick`) and the stages of a pass,
  `mapping/*` (the JAX package's names); the inertial stages
  `local inertial BA`, `try_initialize`, `full VI-BA`, `scale refinement`;
- place recognition and loops: `loop closing`
  (`LoopCloser.process_keyframe`), `place/add`, `place/query`,
  `loop: verify Sim3` and in it `loop/verify/match`, `loop/verify/ransac`,
  `loop/verify/refine`, `loop/verify/project`; `loop: essential graph`,
  `loop: correct points`, `loop: search and fuse`;
- global BA: `GBA chunk` (`AsyncGBA.tick`) and in it `gba/chunk`;
- the Atlas: `atlas` (`MultiMapManager.on_new_keyframe`, `on_frame_done`),
  `try merge`, `merge: *`.

Counters: `count/graph_capture` (a CUDA graph captured by `graphed.run`),
`count/mapping_queue` (`AsyncMapper.queue_len()` at each tick that runs a
stage).

`entry.replay` activates a recorder for the inertial sensors and the Atlas
and returns what it read (`ReplayResult.inertial_ms`); the runner's
`--timing` prints `print_report`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_active: Optional["Recorder"] = None
_OFF = contextlib.nullcontext()  # what `span` returns with no recorder active
COUNT = "count/"  # the prefix of a counter's entries


class Recorder:
    """The spans closed and the counts made within the block, by name:
    (frame, host ms, the (start, end) CUDA events or None) for a span,
    (frame, n, None) for a counter. `frame` is set by the caller."""

    def __init__(self, cuda: bool):
        self.cuda, self.frame, self.calls = cuda, None, {}
        self._prev = None

    def __enter__(self):
        global _active
        self._prev, _active = _active, self
        return self

    def __exit__(self, *exc):
        global _active
        _active = self._prev

    def result(self) -> dict:
        """name -> [(frame, host ms, device ms or None)] (reads the events);
        a counter's entries are (frame, n, None)."""
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [(f, h, ev[0].elapsed_time(ev[1]) if ev else None) for f, h, ev in v]
                for name, v in self.calls.items()}


class _Span:
    __slots__ = ("rec", "name", "ev", "rf", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.ev = None
        if self.rec.cuda and not torch.cuda.is_current_stream_capturing():
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        host = (time.perf_counter() - self.t0) * 1e3
        ev = self.ev
        if ev is not None:
            ev[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec.calls.setdefault(self.name, []).append((self.rec.frame, host, ev))
        return False


def span(name: str):
    """A context that times its block under `name` while a recorder is
    active; the shared no-op context otherwise."""
    rec = _active
    if rec is None:
        return _OFF
    return _Span(rec, name)


def count(name: str, n: int = 1) -> None:
    """Adds `n` under `count/<name>` while a recorder is active."""
    rec = _active
    if rec is not None:
        rec.calls.setdefault(COUNT + name, []).append((rec.frame, n, None))


def report(calls: dict) -> dict:
    """{name: {n, total_s, mean_ms, max_ms, device_mean_ms}} of the spans of
    a `Recorder.result()`; device_mean_ms is None off CUDA. Counters are
    left out (`counters`)."""
    out = {}
    for name, v in sorted(calls.items()):
        if name.startswith(COUNT):
            continue
        host = [h for _, h, _ in v]
        dev = [d for _, _, d in v if d is not None]
        out[name] = dict(n=len(v), total_s=sum(host) / 1e3, mean_ms=sum(host) / len(v),
                         max_ms=max(host), device_mean_ms=sum(dev) / len(dev) if dev else None)
    return out


def counters(calls: dict) -> dict:
    """{name without `count/`: {entries, sum, mean}} of the counters of a
    `Recorder.result()`."""
    out = {}
    for name, v in sorted(calls.items()):
        if name.startswith(COUNT):
            total = sum(n for _, n, _ in v)
            out[name[len(COUNT):]] = dict(entries=len(v), sum=total, mean=total / len(v))
    return out


def print_report(calls: dict) -> None:
    """One line per span, as the JAX package's `utils/timing.print_report`,
    with the device mean beside the host's; then one line per counter."""
    for name, s in report(calls).items():
        dev = "" if s["device_mean_ms"] is None else f" device={s['device_mean_ms']:8.2f}ms"
        print(f"{name:32s} n={s['n']:5d} mean={s['mean_ms']:8.2f}ms max={s['max_ms']:8.2f}ms "
              f"total={s['total_s']:7.2f}s{dev}")
    counts = counters(calls)
    if counts:
        print("counters (entries, sum, mean):")
    for name, c in counts.items():
        print(f"{COUNT + name:32s} entries={c['entries']:5d} sum={c['sum']:8d} "
              f"mean={c['mean']:8.2f}")
