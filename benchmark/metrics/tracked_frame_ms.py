"""Median host ms of the traced window's frames of kind "tracked": no
keyframe, asynchronous mapping stage, GBA chunk or IMU stage after them
(kinds as `run_sequence.main` classifies them). Layer: tracking."""

import statistics


def read(rec):
    ms = [f["ms"] for f in rec.frames if f["kind"] == "tracked"]
    return statistics.median(ms) if ms else None
