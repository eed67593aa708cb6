"""Run a function on n ranks, one spawned process each, over a
`torch.distributed` process group — the port's counterpart of
`scripts/drive_multimap_distributed.py`'s launcher.

    results = launch.run(fn, n, args, device="cuda")

starts n processes (the "spawn" start method: a child imports only what
`fn` needs, never the caller's JAX), joins them in one group through a
`FileStore` in a fresh temporary directory with an explicit timeout, and
calls `fn(rank, n, device, *args)` in each; every rank's return value comes
back with its tensors turned into numpy arrays. `device` is required: a
rank's device is `cuda:{rank % device_count}` when the caller asks for CUDA
(NCCL when every rank has a card of its own, else gloo, which stages CUDA
tensors through the host: several ranks on one card), the CPU (gloo) only
when the caller asks for it. The backend is
printed. A rank that raises, or dies, fails the run and the others are
stopped; a collective that waits on a diverged rank raises at the timeout.

`replay(n, device, **kw)` is config 5 on n ranks: each runs
`entry.replay(device, ..., distributed=True)` (its System with
`enable_distributed()` on the world group) and returns `replay_summary`.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(device, n: int) -> str:
    """NCCL when the ranks are on CUDA and each has a card of its own, else gloo."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= n):
        return "nccl"
    return "gloo"


def rank_device(device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def to_host(x):
    """Tensors -> numpy arrays inside dicts, lists, tuples and NamedTuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def _worker(fn, rank, n, backend, init_method, timeout, device, threads, args, out):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            res = to_host(fn(rank, n, dev, *args))
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:  # reported to the parent, which fails the run
        out.put((rank, False, traceback.format_exc()))


def run(fn, n: int, args=(), *, device, timeout: float = 300.0, threads: int | None = None,
        wall: float | None = None) -> list:
    """`fn(rank, n, device, *args)` on `n` spawned ranks (module docstring);
    returns the ranks' results in rank order. `fn` and `args` must pickle
    (`fn` a module-level function); `threads` sets each rank's
    `torch.set_num_threads`. `timeout` (s) bounds each collective, `wall`
    (s; `timeout` when None) the whole run."""
    backend = backend_for(device, n)
    print(f"launch: {n} ranks on {[str(rank_device(device, r)) for r in range(n)]} over "
          f"{backend}", flush=True)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="orbslam3_pg_")
    init = "file://" + os.path.join(tmp, "store")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(fn, r, n, backend, init, timeout, str(device),
                                               threads, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    results, errors = {}, []
    wall = timeout if wall is None else wall
    deadline = time.monotonic() + wall
    try:
        while len(results) + len(errors) < n:
            try:
                rank, ok, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead and not errors:
                    errors.append(f"rank(s) {dead} exited with {[procs[r].exitcode for r in dead]}"
                                  " before returning")
                if errors or time.monotonic() > deadline:
                    break
                continue
            if ok:
                results[rank] = payload
            else:
                errors.append(f"rank {rank}:\n{payload}")
                break
        if len(results) < n and not errors:
            errors.append(f"timed out after {wall} s with ranks {sorted(results)} done")
    finally:
        for p in procs:
            if errors and p.is_alive():
                p.terminate()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("launch: " + "\n".join(errors))
    return [results[r] for r in range(n)]


def replay_summary(rep) -> dict:
    """The picklable part of an `entry.replay` result, with what the
    distributed System did: GBA chunks and solves over the group, merge
    queries (sharded and all), the replica checks and the collectives' records
    (`collective_stats`; the per-frame counts are `collectives`)."""
    from orbslam3_tpu_torch.parallel import comm

    out = {k: v for k, v in rep._asdict().items() if k != "system"}
    out["kinds"] = rep.frame_kinds()
    sysm = rep.system
    lc, mm, d = sysm.loop_closer, sysm.multimap, sysm.dist
    g = lc.gba_async if lc is not None else None
    out.update(
        n_dist_solves=g.n_dist_solves if g is not None else 0,
        n_chunks=g.n_chunks if g is not None else 0,
        n_queries=mm.n_queries if mm is not None else 0,
        n_sharded_queries=mm.n_sharded_queries if mm is not None else 0,
        replica_checks=list(d.replica_checks) if d is not None else [],
        collective_stats=comm.stats_copy(), n_shards=d.n_shards if d is not None else 1)
    return out


def replay_rank(rank: int, n: int, device, kw: dict) -> dict:
    """One rank of `replay`: `entry.replay(device, distributed=True, **kw)`;
    with `frames_file` in `kw`, the frames `entry.save_frames` wrote there
    instead of rendering them."""
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.parallel import comm

    comm.reset_stats()
    kw = dict(kw)
    frames_file = kw.pop("frames_file", None)
    if frames_file is not None:
        E.load_frames(frames_file)
    rep = E.replay(device, distributed=True, **kw)
    return replay_summary(rep)


def replay(n: int, device, timeout: float = 300.0, wall: float | None = None, **kw) -> list:
    """Config 5 on `n` ranks: `replay_rank` in each (`entry.replay`'s
    keywords in `kw`, and `frames_file`); every rank's `replay_summary`."""
    return run(replay_rank, n, (kw,), device=device, timeout=timeout, wall=wall)
