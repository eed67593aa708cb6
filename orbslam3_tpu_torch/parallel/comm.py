"""The collectives of the sharded solvers over a `torch.distributed` group,
counted: where the JAX package writes `psum` / `pmax` / `all_gather` over a
mesh axis inside `shard_map`, the port calls `all_reduce` (SUM, MAX) and
`all_gather` here, one process per rank.

Every call adds to `STATS[name]`: calls, bytes (of the tensor handed to the
collective, as each rank sends it) and host ms around the call. With
`sync_timing()` active the device is drained before and after each call
on CUDA, so the ms are the collective's own; otherwise they include the
wait for the work queued before it (a blocking gloo call waits for its
input). The gloo backend takes CUDA tensors for both collectives and stages
them through the host itself; NCCL takes them on the rank's card. A bool
tensor travels as uint8 (gloo has no bool). Nothing here falls back to the
CPU or catches a failed collective: a group that stalls raises at its
timeout (`init_process_group(timeout=...)`, `parallel/launch.py`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

STATS: dict = {}  # name -> [calls, bytes, ms]
_sync_timing = [False]


def reset_stats() -> None:
    STATS.clear()


def stats_copy() -> dict:
    return {k: list(v) for k, v in STATS.items()}


def totals() -> tuple:
    """(calls, host ms) of every collective recorded in `STATS`."""
    return sum(v[0] for v in STATS.values()), sum(v[2] for v in STATS.values())


@contextlib.contextmanager
def sync_timing():
    """Drain the device around each collective inside the block."""
    prev, _sync_timing[0] = _sync_timing[0], True
    try:
        yield
    finally:
        _sync_timing[0] = prev


def resolve(group=None):
    """The group itself, the world group for None once a process group is
    initialized, else None (a single process: no collective)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world(group=None) -> tuple:
    """(size, rank) of `resolve(group)`; (1, 0) without a process group."""
    g = resolve(group)
    if g is None:
        return 1, 0
    return dist.get_world_size(g), dist.get_rank(g)


def _timed(name: str, x: torch.Tensor, fn):
    sync = _sync_timing[0] and x.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    fn()
    if sync:
        torch.cuda.synchronize(x.device)
    rec = STATS.setdefault(name, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += x.numel() * x.element_size()
    rec[2] += (time.perf_counter() - t0) * 1e3


def all_reduce(x: torch.Tensor, group, op: str = "sum", name: str = "all_reduce"
               ) -> torch.Tensor:
    """`psum` (op "sum") or `pmax` ("max") of `x` over `group`: reduced in
    place when `x` is contiguous, and returned."""
    x = x.contiguous()
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    _timed(name, x, lambda: dist.all_reduce(x, op=rop, group=group))
    return x


def all_gather(x: torch.Tensor, group, name: str = "all_gather") -> torch.Tensor:
    """Every rank's `x` concatenated along the leading axis, in rank order
    (`lax.all_gather` then a reshape)."""
    n = dist.get_world_size(group)
    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _timed(name, src, lambda: dist.all_gather(parts, src, group=group))
    out = torch.cat(parts)
    return out.to(torch.bool) if is_bool else out


def reducer(group: Optional[object], name: str):
    """`all_reduce(., group, "sum", name)`, or the identity without a group."""
    if group is None:
        return lambda x: x
    return lambda x: all_reduce(x, group, "sum", name)
