"""Device selection: the port takes an explicit `device` everywhere; this
module only answers whether a CUDA card is there."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path needs a GPU")
    return torch.device("cuda", 0)
