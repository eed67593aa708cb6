"""The 95th percentile of the host ms per frame over the traced window's
frames outside the profiled stretch. The untraced window's p95 spreads too
widely from run to run on a shared host to hold a bound (PERF.md), so it is
read here, beside the per-layer numbers, under the traced run's own costs
(sync debug mode, spans). Layer: system."""

import numpy as np


def read(rec):
    first, last = rec.profiled
    ms = [f["ms"] for i, f in enumerate(rec.frames) if not first <= i < last]
    return float(np.percentile(ms, 95)) if ms else None
