"""Median device ms (CUDA events) of the port's `gba/chunk` spans in the
traced window. Layer: global BA."""

import statistics


def read(rec):
    ms = [d for _, _, d in rec.spans.get("gba/chunk", []) if d is not None]
    return statistics.median(ms) if ms else None
