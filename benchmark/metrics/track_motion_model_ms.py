"""Median host ms of the port's `track/motion_model` spans (stage 1a of a
tracked frame: the motion-model match, its pose solve and the host read of
its success) in the traced window. Layer: tracking."""

import statistics


def read(rec):
    ms = [h for _, h, _ in rec.spans.get("track/motion_model", [])]
    return statistics.median(ms) if ms else None
