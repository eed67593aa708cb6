"""Readings of a cell's correctness numbers over many seeds in one process:
the program as it runs in the benchmark, its precision control, or a
planted fault. The benchmark's own runs do not run this.

    python benchmark/control.py --workload NAME --seeds 101-112 --seconds S
        [--tf32] [--fault NAME] [--out FILE]

Per seed: the recording made from the seed, a fresh System, the
window of S seconds (the traffic's warm-up extent replayed before the first
seed only: later seeds find every kernel built and every graph captured),
then the judge. `--tf32` is the precision control: the configuration states
float32 with TF32 off (the port switches it off at import), and the control
switches TF32 on for float32 matmuls and convolutions in the program, the
step that would tempt a later change. The reference keeps TF32 off. Prints
one JSON line per seed with each number and its limit.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)
from benchmark import run  # noqa: E402,F401  (the same environment as a run: threads, caches)


def seeds_of(text: str) -> list:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,7,9")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cell as cells
    from benchmark import faults, judge
    from benchmark.replay import Replay

    cell = cells.load(args.workload)
    device = torch.device("cuda")
    import orbslam3_tpu_torch  # noqa: F401  (switches TF32 off)

    if args.tf32:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    undo = faults.plant(args.fault) if args.fault else None
    out = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(seeds_of(args.seeds)):
            t0 = time.perf_counter()
            replay = Replay(cell, seed, device)
            if n == 0:
                replay.warm()
            replay.window(args.seconds)
            replay.free()
            checks = judge.judge(replay, cell)
            line = json.dumps(dict(
                workload=cell.name, seed=seed, tf32=args.tf32, fault=args.fault,
                correct=all(v <= lim for v, lim in checks.values()),
                frames=len(replay.frame_ms), sessions=len(replay.sessions),
                wall_s=time.perf_counter() - t0,
                checks={k: [v if v == v and abs(v) != float("inf") else None, lim]
                        for k, (v, lim) in checks.items()}))
            print(line, flush=True)
            if out is not None:
                out.write(line + "\n")
                out.flush()
            del replay
            torch.cuda.empty_cache()
    finally:
        if undo is not None:
            undo()
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
