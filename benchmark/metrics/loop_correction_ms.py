"""Host ms of a loop correction: the spans `loop: essential graph`, `loop:
correct points` and `loop: search and fuse` of the traced window, summed,
per closure. Layer: loop closing."""

SPANS = ("loop: essential graph", "loop: correct points", "loop: search and fuse")


def read(rec):
    n = len(rec.spans.get(SPANS[0], []))
    if n == 0:
        return None
    return sum(h for name in SPANS for _, h, _ in rec.spans.get(name, [])) / n
