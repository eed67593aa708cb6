"""Median host ms of the port's `extract` spans (`Tracker._extract`: the
image's upload, the atlas, kernel B2, the selection and the descriptors of
one image) in the traced window. Layer: extraction."""

import statistics


def read(rec):
    ms = [h for _, h, _ in rec.spans.get("extract", [])]
    return statistics.median(ms) if ms else None
