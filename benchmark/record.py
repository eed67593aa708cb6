"""What a traced run leaves for the per-layer metric readers.

`Record.of(cell, replay, tracer)` reduces the traced window to plain data:
per frame its host ms, kind and syncs; the port's spans; from the profiler's
stretch the device's busy time, its time per kernel name, its idle time by
what the host was doing; and the least time (`bounds.py`) of every B1 and B2
call the stretch made. A reader (`benchmark/metrics/<name>.py`) takes a
Record and returns its number, or None where the run gave it nothing to
read.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from benchmark import bounds, tracing


def by_kind(frames) -> dict:
    """{kind: [frames, median ms, median syncs]} of the traced window."""
    out = {}
    for f in frames:
        out.setdefault(f["kind"], []).append(f)
    return {k: [len(v), float(np.median([f["ms"] for f in v])),
                float(np.median([f["syncs"] for f in v]))] for k, v in sorted(out.items())}


class Record(NamedTuple):
    cell: object
    frames: List[dict]  # per window frame: ms, kind, syncs, state
    spans: dict  # name -> [(frame, host ms, device ms or None)]
    window_s: float  # the profiled stretch
    busy_s: float  # device time in it, the union of its operations
    profiled: tuple  # window frames [first, last) the profiler saw
    device_s: dict  # kernel name -> device seconds in the stretch
    idle_s: dict  # what the host was doing -> idle device seconds
    b1_bound_us: float  # summed over the stretch's B1 calls
    b1_calls: int
    b2_bound_us: float
    b2_calls: int

    @staticmethod
    def of(cell, replay, tracer) -> "Record":
        window_s = busy_s = 0.0
        device_s, idle_s = {}, {}
        if getattr(tracer, "events", None) is not None:
            labels = tracing.all_labels() | set(tracer.spans)
            window, dev, host = tracing.device_timeline(tracer.events, labels)
            window_s = (window[1] - window[0]) / 1e9
            busy_s = tracing.busy_union(dev) / 1e9
            for s, t, name in dev:
                device_s[name] = device_s.get(name, 0.0) + (t - s) / 1e9
            idle_s = {k: v / 1e9 for k, v in
                      tracing.idle_by_label(tracing.idle_gaps(window, dev), host).items()}
        b1 = sum(bounds.b1_bound(n, m, v, w, shared)["bound_us"]
                 for n, m, v, w, shared in tracer.b1)
        b2 = sum(bounds.b2_bound(h, w)["bound_us"] for h, w in tracer.b2)
        return Record(cell, tracer.frames, tracer.spans, window_s, busy_s, tracer.profiled,
                      device_s, idle_s, b1, len(tracer.b1), b2, len(tracer.b2))

    def kernel_s(self, names) -> float:
        return sum(v for k, v in self.device_s.items() if any(n in k for n in names))

    def roofline_pct(self, names, bound_us: float) -> Optional[float]:
        """100 x the calls' least time over their device time (None where
        the stretch ran none of them)."""
        t = self.kernel_s(names)
        return 100.0 * bound_us / 1e6 / t if t > 0 and bound_us > 0 else None

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in idle]}
