"""Where the time of the port's tracking slice goes on one GPU.

    python -m orbslam3_tpu_torch.profile_slice [--frames 6] [--out TABLE.txt]

Runs `orbslam3_tpu_torch.entry.staged_pipeline` at the EuRoC shapes for a
few frames under `torch.profiler` and prints: wall time per frame, the
device's busy share (summed kernel time over wall time), kernel launches per
frame, and the device time of the port's two CUDA kernels; with `--out`,
the full per-kernel table goes to that file. Needs a CUDA device.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--out", help="write the full per-kernel table here")
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            run(f, *a[1:])
        wall_ms = (time.perf_counter() - t0) * 1e3

    # Device-side events only (the aten ops that launch them carry the same
    # device time again).
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    ours = {name: sum(e.self_device_time_total for e in kernels if name in e.key)
            for name in ("fast_score_kernel", "nms3_kernel", "hamming_top2_kernel")}
    n = args.frames
    print(f"{torch.cuda.get_device_name(0)}: {n} frames, wall {wall_ms / n:.2f} ms/frame, "
          f"device busy {dev_us / 1e3 / n:.3f} ms/frame ({100 * dev_us / 1e3 / wall_ms:.1f}% of "
          f"wall), {n_launch / n:.0f} kernels/frame")
    print("port kernels, device us/frame: "
          + ", ".join(f"{k} {v / n:.1f}" for k, v in ours.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print("top kernels, us/frame (launches/frame): "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / n:.1f} ({e.count / n:.0f})"
                      for e in top))
    print("stage split, median host ms (synchronised after each stage): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_split(E, dev, a, frames).items()))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(prof.key_averages().table(sort_by="self_device_time_total", row_limit=60))
        print(f"table: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
