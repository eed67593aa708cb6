"""Timed spans around the inertial calls of the tracker and the mapper.

`with span(name):` at a call site records, while a `Recorder` is active,
the host clock and, on CUDA, two events around the call. With no recorder
active it costs one read of a module global. `entry.replay` activates one
for "mono_vi" and returns what it read (`ReplayResult.inertial_ms`).
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
