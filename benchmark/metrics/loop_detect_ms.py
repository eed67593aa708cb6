"""Host ms of place recognition and loop verification per keyframe: the
port's spans `place/add`, `place/query` and `loop/verify/*` of the traced
window, summed, over the number of `place/add` spans (one per keyframe the
loop closer takes). Layer: place recognition and loop verification."""


def read(rec):
    n = len(rec.spans.get("place/add", []))
    if n == 0:
        return None
    names = [k for k in rec.spans if k in ("place/add", "place/query")
             or k.startswith("loop/verify/")]
    return sum(h for k in names for _, h, _ in rec.spans[k]) / n
