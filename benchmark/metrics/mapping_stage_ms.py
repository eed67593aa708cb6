"""Mean host ms of the port's `mapping/*` spans (one asynchronous mapping
stage each) in the traced window. Layer: async mapping."""


def read(rec):
    ms = [h for name, v in rec.spans.items() if name.startswith("mapping/") for _, h, _ in v]
    return sum(ms) / len(ms) if ms else None
