"""Host syncs per frame over every frame of the traced window, counted by
PyTorch's sync debug mode as the runner counts them. Layer: system."""


def read(rec):
    return sum(f["syncs"] for f in rec.frames) / len(rec.frames) if rec.frames else None
