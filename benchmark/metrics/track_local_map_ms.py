"""Median host ms of the port's `track/local_map` spans (a tracked frame's
local keyframes, local-map match, final pose solve and bundle) in the
traced window. Layer: tracking."""

import statistics


def read(rec):
    ms = [h for _, h, _ in rec.spans.get("track/local_map", [])]
    return statistics.median(ms) if ms else None
