"""Kernel B1 (Hamming top-2 with the window) against its roofline: the
summed least time of the B1 calls of the profiled stretch (`bounds.b1_bound`,
pairs counted with the window mask on each call's inputs) over the device
time the profiler gave B1's kernel. Layer: kernel B1."""

from benchmark import bounds


def read(rec):
    return rec.roofline_pct(bounds.B1_KERNELS, rec.b1_bound_us)
