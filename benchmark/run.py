"""Run one cell of the port's benchmark once.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout: loads the cell named in `BENCHMARK.json` with
its configuration, traffic mix and limits (`benchmark/cell.py`), builds the
port's `System` on the first CUDA card and makes the recording from the
seed (`benchmark/replay.py`), replays the traffic's warm-up extent, then
measures for S seconds: sessions of the recording back to back, each frame
handed in when the previous one returned. Set-up (`setup_s`) runs from the
process's start to the window's first frame.

`--trace 0` reports the cell's end-to-end metrics: frames/s over the
window, the device's peak memory, the set-up time.
`--trace 1` is a run of its own that reports the per-layer metrics
(`benchmark/metrics/<name>.py`) from the port's spans, the host syncs and a
profiler trace of the traffic's `profile_frames` (`benchmark/tracing.py`),
with the device's busy time and a breakdown.

After the window the program's answers are judged against the plain
reference (`benchmark/judge.py`): each number and its limit go to standard
error as the last lines and into the result's last key, `checks`. The last
line of standard output is one JSON object: `correct`, `attempted` (the
frames handed in inside the window), `failed` (those not tracked after
their session's first tracked frame), `metrics`, `device`[, `breakdown`],
`checks`.

Exits 2 without a result where there is no CUDA card or fewer than the cell
asks for, and 3 where `jax`, `jaxlib`, `flax` or `orbslam3_tpu` is loaded
once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)  # import the harness as `benchmark`, the port from the checkout
CACHE = ROOT / ".bench_cache"  # fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
# One process with few threads: the host path is one Python thread, and idle
# math-library threads only contend with it for the cores the card's host shares.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "orbslam3_tpu")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v: float):
    """A number for JSON; None for one that is not finite (no answer)."""
    return v if v == v and abs(v) != float("inf") else None


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def layer_metrics(cell, record) -> dict:
    from benchmark.cell import metric_reader

    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the only measured device); cpu only for the harness's tests")
    args = ap.parse_args(argv)

    from benchmark import cell as cells

    cell = cells.load(args.workload)
    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device(args.device)
    cuda = device.type == "cuda"

    import orbslam3_tpu_torch  # noqa: F401  (its import switches TF32 off)
    from benchmark import judge, record
    from benchmark.replay import Replay
    from benchmark.tracing import Tracer

    traffic = cell.traffic
    tracer = Tracer(traffic["profile_frames"]) if args.trace else None
    t_imports = time.perf_counter() - T0
    replay = Replay(cell, args.seed, device, tracer)
    replay.warm()
    if tracer is not None:
        tracer.start_window()
    setup_s = time.perf_counter() - T0
    window_s = replay.window(args.seconds)
    if cuda:
        torch.cuda.synchronize()
    if tracer is not None:
        tracer.end_window(replay.window_frames)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    metrics, extra, breakdown = {}, {}, None
    if tracer is None:
        values = dict(frames_per_s=(len(replay.frame_ms) / window_s, "frames/s"),
                      device_peak_gib=(peak / 2**30, "GiB"), setup_s=(setup_s, "s"))
        for m in cell.end_to_end:
            v, unit = values[m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}
    else:
        rec = record.Record.of(cell, replay, tracer)
        metrics = layer_metrics(cell, rec)
        extra = dict(busy_s=rec.busy_s, window_s=rec.window_s)
        breakdown = rec.breakdown()

    replay.free()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge.judge(replay, cell)
    correct = all(v <= lim for v, lim in checks.values())
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark may not hold: {', '.join(bad)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak), **extra}
    if cuda:
        device_info["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(len(replay.frame_ms)),
              "failed": int(replay.failed), "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # For the reader, not the check: how set-up and the window went.
    result["setup_parts"] = dict(imports=t_imports, **replay.setup_parts)
    result["sessions"] = [dict(frames=s.n_frames, imu_init=s.imu_init_frame,
                               loops=s.loop_frames) for s in replay.sessions]
    slow = sorted(range(len(replay.frame_ms)), key=lambda i: -replay.frame_ms[i])[:10]
    result["slowest_frames"] = [[i, replay.frame_ms[i]] for i in sorted(slow)]
    if tracer is not None:
        result["frames_by_kind"] = record.by_kind(tracer.frames)
    result["checks"] = {k: {"value": _finite(v), "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
