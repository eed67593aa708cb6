"""Host ms of the spans `preintegration`, `pose-inertial (last frame)` and
`pose-inertial (last keyframe)`, summed over the traced window, per frame
of the window. Layer: inertial tracking."""

SPANS = ("preintegration", "pose-inertial (last frame)", "pose-inertial (last keyframe)")


def read(rec):
    total = sum(h for name in SPANS for _, h, _ in rec.spans.get(name, []))
    if total == 0 or not rec.frames:
        return None
    return total / len(rec.frames)
