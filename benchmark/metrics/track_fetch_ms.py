"""Median host ms of the port's `track/fetch` spans (the tracked frame's one
read of its bundle: the host waiting for the device's tracking work) in the
traced window. Small against `track_motion_model_ms` and
`track_local_map_ms` means the host, not the card, sets the pace. Layer:
tracking."""

import statistics


def read(rec):
    ms = [h for _, h, _ in rec.spans.get("track/fetch", [])]
    return statistics.median(ms) if ms else None
