"""Kernel B2 (FAST + NMS) against its roofline: the summed least time of
the B2 calls of the profiled stretch (`bounds.b2_bound`, from each call's
atlas shape) over the device time the profiler gave B2's kernel. Layer:
kernel B2."""

from benchmark import bounds


def read(rec):
    return rec.roofline_pct(bounds.B2_KERNELS, rec.b2_bound_us)
