"""State conversion between the JAX package and the port.

A SLAM map is this system's parameter set: `MapState`, the `Features` of a
frame and the camera `params` cross between the two packages as numpy
arrays (`np.asarray(leaf)` on the JAX side), so this module needs neither
JAX nor the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Type, TypeVar

import numpy as np
import torch

T = TypeVar("T", bound=tuple)


def tensor(x, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """numpy (or array-like) -> tensor on `device`, dtype kept (int32 stays
    int32, bool stays bool, uint8 stays uint8) unless `dtype` converts it
    on the device. The array is copied, so the caller may reuse it. No host
    synchronisation: to a CUDA device the copy goes through pinned memory
    asynchronously (PyTorch synchronises the stream after a blocking copy
    from pageable memory)."""
    t = torch.from_numpy(np.array(x, copy=True))
    dev = torch.device(device)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    else:
        t = t.to(dev)
    return t if dtype is None else t.to(dtype)


def to_torch(tree: NamedTuple, device, cls: Type[T] | None = None) -> T:
    """A NamedTuple of arrays (numpy, or JAX arrays passed through
    `np.asarray`) -> the same NamedTuple type `cls` of tensors on `device`.
    `cls` defaults to the input's own type."""
    cls = cls or type(tree)
    return cls(**{k: tensor(np.asarray(v), device) for k, v in tree._asdict().items()})


def to_numpy(tree):
    """A tensor, or a NamedTuple of tensors -> numpy on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(v) for v in tree))
