"""The JAX runner (`scripts/run_sequence.py`) on the sequence that
`chip_smoke.py` phase 16 writes and replays on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_runner_lap.py --seq DIR [--frames 260] \
        [--t-loop 8] [--sync-mapping] [--out FILE]

Writes `entry.write_euroc_sequence(DIR, frames, seed 0, t_loop, imu=True)` with the
port's writer (752x480, `make_synth_euroc.py`'s settings: 1000 features, 8
levels) unless DIR already holds it, prints the sequence's digest
(`datasets.sequence_digest`: decoded pixels and CSV text), then runs the JAX
runner's `main` in this process on those files (its trajectory files go to
DIR_jax/) with every flag at its
default (async mapping, Kmax 512, Pmax 65536, the shipped 100k vocabulary,
place recognition and the Atlas), or with `--sync-mapping`. It watches the
run through the JAX `System`: the frame after which each loop closed, the
keyframe count, the GBA runs finished and aborted and the path
`auto_dense_schur` gave them, and the Sim3 ATE over the whole trajectory
(`eval/ate.py`, as the runner computes and prints it to 4 decimals). One
JSON line ends the output. chip_smoke's phase-16 constants come from this script.
Not a test: nothing collects it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from orbslam3_tpu.eval.ate import ate_rmse  # noqa: E402
from orbslam3_tpu.optim import ba as jba  # noqa: E402
from orbslam3_tpu.system import System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402
from orbslam3_tpu_torch.io import datasets  # noqa: E402


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--frames", type=int, default=260)
    ap.add_argument("--t-loop", type=float, default=8.0)
    ap.add_argument("--sync-mapping", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    t0 = time.time()
    if not os.path.exists(os.path.join(a.seq, "settings.yaml")):
        E.write_euroc_sequence(a.seq, a.frames, 0, t_loop=a.t_loop, imu=True)
    digest = datasets.sequence_digest(a.seq)
    print(f"sequence {a.seq}: sha256 {digest} ({time.time() - t0:.1f} s)", flush=True)

    watch = dict(frame=-1, slam=None, loops=[], states=[])
    track = System.track_monocular

    def watched(self, *args, **kw):
        watch["slam"] = self
        watch["frame"] += 1
        n_before = self.loop_closer.n_loops_closed if self.loop_closer else 0
        out = track(self, *args, **kw)
        if self.loop_closer is not None and self.loop_closer.n_loops_closed > n_before:
            watch["loops"].append(watch["frame"])
        watch["states"].append(self.tracking_state.name)
        return out

    System.track_monocular = watched
    spec = importlib.util.spec_from_file_location(
        "run_sequence", os.path.join(REPO, "scripts", "run_sequence.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    out_dir = a.seq.rstrip("/") + "_jax"  # the sequence's directory stays as written
    os.makedirs(out_dir, exist_ok=True)
    traj = os.path.join(out_dir, "sync.txt" if a.sync_mapping else "async.txt")
    argv_run = ["run_sequence.py", os.path.join(a.seq, "settings.yaml"), a.seq,
                "--dataset", "euroc", "--mode", "mono", "--out", traj,
                "--kf-out", traj.replace(".txt", "_kf.txt")]
    if a.sync_mapping:
        argv_run.append("--sync-mapping")
    buf = io.StringIO()
    sys.argv = argv_run
    t1 = time.time()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        runner.main()
    text = buf.getvalue()
    slam = watch["slam"]
    gba = slam.loop_closer.gba_async
    ts, pos = slam.get_trajectory()
    gt = datasets.load_groundtruth_euroc(a.seq)
    ate_full = ate_rmse(ts, pos, gt[0], gt[1], with_scale=True)
    ate = re.search(r"ATE RMSE: ([0-9.]+) m", text)
    first_ok = next((k for k, s in enumerate(watch["states"]) if s == "OK"), None)
    out = dict(frames=a.frames, t_loop=a.t_loop, sync_mapping=a.sync_mapping, digest=digest,
               ate=ate_full, ate_printed=float(ate.group(1)) if ate else None,
               loop_frames=watch["loops"],
               n_loops=slam.loop_closer.n_loops_closed,
               merges=slam.multimap.n_merges if slam.multimap else 0,
               n_kf=slam.store.n_kf, gba_finished=gba.n_finished, gba_aborted=gba.n_aborted,
               gba_path="dense" if jba.auto_dense_schur(slam.store.state.Kmax,
                                                        slam.store.state.Pmax) else "pcg", first_ok=first_ok,
               not_ok_after_init=[k for k, s in enumerate(watch["states"])
                                  if first_ok is not None and k >= first_ok and s != "OK"],
               run_seconds=time.time() - t1, seconds=time.time() - t0)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
