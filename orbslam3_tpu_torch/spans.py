"""Timed spans around the stages of a mapping pass (`mapping/*`, the JAX
package's names), the inertial calls of the tracker and the mapper, a
two-camera rig's calls (its match, its pose solves with right rows), the
Atlas's merge and the loop closer's verification and correction.

`with span(name):` at a call site records, while a `Recorder` is active,
the host clock and, on CUDA, two events around the call. With no recorder
active it costs one read of a module global. `entry.replay` activates one
for the inertial sensors and returns what it read
(`ReplayResult.inertial_ms`); the runner's `--timing` prints `report`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_active: Optional["Recorder"] = None


class Recorder:
    """The spans closed within the block, by name: (frame, host ms, the
    (start, end) CUDA events or None). `frame` is set by the caller."""

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
        """name -> [(frame, host ms, device ms or None)] (reads the events)."""
        if self.cuda:
            torch.cuda.synchronize()
        return {name: [(f, h, ev[0].elapsed_time(ev[1]) if ev else None) for f, h, ev in v]
                for name, v in self.calls.items()}


@contextlib.contextmanager
def span(name: str):
    rec = _active
    if rec is None:
        yield
        return
    ev = None
    if rec.cuda:
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        host = (time.perf_counter() - t0) * 1e3
        if ev is not None:
            ev[1].record()
        rec.calls.setdefault(name, []).append((rec.frame, host, ev))


def report(calls: dict) -> dict:
    """{name: {n, total_s, mean_ms, max_ms, device_mean_ms}} of a
    `Recorder.result()`; device_mean_ms is None off CUDA."""
    out = {}
    for name, v in sorted(calls.items()):
        host = [h for _, h, _ in v]
        dev = [d for _, _, d in v if d is not None]
        out[name] = dict(n=len(v), total_s=sum(host) / 1e3, mean_ms=sum(host) / len(v),
                         max_ms=max(host), device_mean_ms=sum(dev) / len(dev) if dev else None)
    return out


def print_report(calls: dict) -> None:
    """One line per span, as the JAX package's `utils/timing.print_report`,
    with the device mean beside the host's."""
    for name, s in report(calls).items():
        dev = "" if s["device_mean_ms"] is None else f" device={s['device_mean_ms']:8.2f}ms"
        print(f"{name:32s} n={s['n']:5d} mean={s['mean_ms']:8.2f}ms max={s['max_ms']:8.2f}ms "
              f"total={s['total_s']:7.2f}s{dev}")
