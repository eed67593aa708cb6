"""The port's replays with the pose solves replayed from CUDA graphs and
issued op by op, on the first CUDA card.

    python tests/pose_graph_replay.py [--mono N] [--rig N]

Replays N frames of the synthetic EuRoC sequence through the monocular
`System` (`entry.replay(cuda, "mono", N)`) and through config 4's
stereo-inertial fisheye rig (`"stereo_vi_fisheye"`) twice each: once as the
package runs (`optim.graphed.run` captures each pose solve's signature once
and replays it), once with `graphed.run` swapped for the plain call. Prints
per run the wall, the median ms of a tracked frame, its host syncs, the
ATE and the graphs captured and replayed so far; then whether the two runs
of each sensor agree on every state and every pose bit for bit; then the
card's name and power limit. Not a test: nothing collects it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import orbslam3_tpu_torch.entry as E  # noqa: E402
from orbslam3_tpu_torch.optim import graphed  # noqa: E402


def _op_by_op(fn, static, tensors):
    return fn(*static, *tensors)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mono", type=int, default=40)
    ap.add_argument("--rig", type=int, default=60)
    a = ap.parse_args()
    graph_run = graphed.run
    out = {}
    for sensor, n in (("mono", a.mono), ("stereo_vi_fisheye", a.rig)):
        for how, run in (("graphs", graph_run), ("op by op", _op_by_op)):
            graphed.run = run
            t = time.perf_counter()
            r = E.replay("cuda", sensor, n)
            wall = time.perf_counter() - t
            out[sensor, how] = r
            kinds = r.frame_kinds()
            tracked = [m for k, m in zip(kinds, r.ms) if k == "tracked"]
            syncs = sorted({s for k, s in zip(kinds, r.syncs) if k == "tracked"})
            print(f"{sensor} {n} frames, pose solves {how}: wall {wall:.1f} s (rendering "
                  f"{r.render_s:.1f} s), tracked frame median {np.median(tracked):.2f} ms over "
                  f"{len(tracked)}, host syncs {syncs}, ATE {r.ate:.6f} m, graphs captured "
                  f"{graphed.CAPTURES}, replays {graphed.REPLAYS}", flush=True)
        g, o = out[sensor, "graphs"], out[sensor, "op by op"]
        same = g.states == o.states and g.pos.shape == o.pos.shape and np.array_equal(g.pos, o.pos)
        print(f"{sensor}: states and poses equal bit for bit: {same}", flush=True)
        if not same:
            return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
