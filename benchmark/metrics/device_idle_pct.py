"""The share of the profiled stretch in which no kernel, copy or set of
memory ran on the card (the harness's own copies left out). Layer:
device."""


def read(rec):
    if rec.window_s <= 0 or rec.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.window_s)
