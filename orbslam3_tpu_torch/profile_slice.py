"""Where the time of the port's main path goes on one GPU.

    python -m orbslam3_tpu_torch.profile_slice [--frames 6] [--passes 3] [--out TABLE.txt]

Runs `orbslam3_tpu_torch.entry.staged_pipeline` at the EuRoC shapes for a
few frames, then `entry.mapping_pass` at full width for a few passes, each
under `torch.profiler`, and prints per frame (per pass): wall time, the
device's busy share (summed kernel time over wall time), kernel launches,
and the device time of the port's two CUDA kernels; then the stage split of
each. With `--out`, the full per-kernel tables go to that file. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def stage_split(E, dev, a, frames) -> dict:
    """Median wall time of each stage of `entry()`'s step (extraction,
    motion-model match, pose solve, local-map match, pose solve)."""
    from orbslam3_tpu_torch.ops import features as feat
    from orbslam3_tpu_torch.pipeline import tracking as trk

    c = E._consts(E.EUROC, dev)
    _, state, local_mask, R_pred, t_pred, last_mp, last_octave = a
    names = ("extract", "motion_match", "solve_1", "local_map_match", "solve_2")
    times = {k: [] for k in names}
    for img in frames:
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        f = feat.extract(img, E.EUROC.orb)
        mark()
        assoc1, _ = trk._track_last_frame(c.model, c.params, R_pred, t_pred, last_mp,
                                          state.mp_pos, state.mp_valid, state.mp_desc, f,
                                          15.0, c.scale_f, last_octave)
        mark()
        res1 = trk._pose_opt_from_assoc(c.model, c.params, R_pred, t_pred, assoc1, f,
                                        state.mp_pos, state.mp_valid, c.sigma2)
        mark()
        assoc1 = torch.where(res1.inlier, assoc1, torch.full_like(assoc1, -1))
        assoc2, _ = trk._track_local_map_match(c.model, c.params, res1.R, res1.t, state,
                                               local_mask, f, assoc1, c.img_wh)
        mark()
        trk._pose_opt_from_assoc(c.model, c.params, res1.R, res1.t, assoc2, f,
                                 state.mp_pos, state.mp_valid, c.sigma2)
        mark()
        for k, t0, t1 in zip(names, marks, marks[1:]):
            times[k].append((t1 - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def mapping_split(E, dev, state, passes) -> dict:
    """Median wall time of each stage of one mapping pass (triangulate,
    fuse, local BA) and the local BA's ms per LM iteration: the marginal
    cost of running 2x the pass's iterations (the port always runs all of
    them; after the early stop the accepted state is frozen)."""
    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch.pipeline import local_mapping as lmap

    cfg = E.EUROC_MAPPING
    sc = E.make_mapping_scene(cfg)
    c = E._consts(E.EUROC, dev)
    T = lambda x: convert.tensor(x, dev)  # noqa: E731
    kf, nb = sc.kf, T(sc.nb_ids).long()
    cand, cval, win, fix = T(sc.cand_ids), T(sc.cand_valid), T(sc.window_ids), T(sc.fixed_ids)
    s = state

    stages = {
        "triangulate": lambda: lmap.triangulate_batch(
            c.model, c.params, s.kf_R[kf], s.kf_t[kf], s.kf_uv[kf], s.kf_octave[kf],
            s.kf_desc[kf], s.kf_mp[kf] < 0, s.kf_R[nb], s.kf_t[nb], s.kf_uv[nb],
            s.kf_octave[nb], s.kf_desc[nb], s.kf_mp[nb] < 0, c.sigma2, c.scale_f, E.EUROC.fx),
        "fuse": lambda: lmap._fuse_batch(c.model, c.params, s, nb, cand, cval, c.img_wh,
                                         c.sigma2, n_levels=E.EUROC.n_levels),
        "local_ba": lambda: lmap.local_ba(c.model, c.params, s, win, fix, c.sigma2,
                                          iters=cfg.iters),
        "local_ba_2x": lambda: lmap.local_ba(c.model, c.params, s, win, fix, c.sigma2,
                                             iters=2 * cfg.iters),
    }
    times = {k: [] for k in stages}
    for _ in range(passes):
        for k, fn in stages.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    med = {k: float(np.median(v)) for k, v in times.items()}
    med["lba_ms_per_iter"] = (med.pop("local_ba_2x") - med["local_ba"]) / cfg.iters
    return med


def _profile(fn, n):
    """(wall ms, profiler) of n calls of fn under the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, prof


def _report(what, n, wall_ms, prof):
    # Device-side events only (the aten ops that launch them carry the same
    # device time again).
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    ours = {name: (sum(e.self_device_time_total for e in kernels if name in e.key),
                   sum(e.count for e in kernels if name in e.key))
            for name in ("fast_score_kernel", "nms3_kernel", "hamming_top2_kernel")}
    whats = "passes" if what == "pass" else what + "s"
    print(f"{torch.cuda.get_device_name(0)}: {n} {whats}, wall {wall_ms / n:.2f} ms/{what}, "
          f"device busy {dev_us / 1e3 / n:.3f} ms/{what} ({100 * dev_us / 1e3 / wall_ms:.1f}% of "
          f"wall), {n_launch / n:.0f} kernels/{what}")
    print(f"port kernels, device us/{what} (launches/{what}): "
          + ", ".join(f"{k} {v / n:.1f} ({c / n:.0f})" for k, (v, c) in ours.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"top kernels, us/{what} (launches/{what}): "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / n:.1f} ({e.count / n:.0f})"
                      for e in top))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--out", help="write the full per-kernel tables here")
    args = ap.parse_args()

    from orbslam3_tpu_torch import convert
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch.device import require_cuda

    dev = require_cuda()
    _, a = E.entry(dev)
    run = E.staged_pipeline(dev)
    rng = np.random.default_rng(1)
    img_np = a[0].cpu().numpy()
    frames = [convert.tensor(img_np + rng.normal(0, 1.0, img_np.shape).astype(np.float32), dev)
              for _ in range(args.frames)]
    run(frames[0], *a[1:])
    torch.cuda.synchronize()

    frame_iter = iter(frames)
    wall_ms, prof = _profile(lambda: run(next(frame_iter), *a[1:]), args.frames)
    _report("frame", args.frames, wall_ms, prof)
    print("stage split, median host ms (synchronised after each stage): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_split(E, dev, a, frames).items()))

    mrun, (mstate,) = E.mapping_pass(dev)
    E.fetch_mapping(mrun(mstate))
    torch.cuda.synchronize()
    mwall, mprof = _profile(lambda: E.fetch_mapping(mrun(mstate)), args.passes)
    _report("pass", args.passes, mwall, mprof)
    print("mapping stage split, median host ms (synchronised after each stage): "
          + ", ".join(f"{k} {v:.2f}" for k, v in
                      mapping_split(E, dev, mstate, args.passes).items()))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("tracking, per-kernel table\n"
                       + prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
                       + "\n\nmapping pass, per-kernel table\n"
                       + mprof.key_averages().table(sort_by="self_device_time_total",
                                                    row_limit=60))
        print(f"table: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
