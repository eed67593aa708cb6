"""The JAX runner (`scripts/run_sequence.py`) on the sequences that
`chip_smoke.py` phases 16 and 19b write and replay on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_runner_lap.py --seq DIR [--frames 260] \
        [--t-loop 8] [--sync-mapping] [--out FILE]
    JAX_PLATFORMS=cpu python tests/jax_runner_lap.py --seq DIR --frames 530 \
        --mode mono-vi --kmax 256 --pmax 16384 --c13
    JAX_PLATFORMS=cpu python tests/jax_runner_lap.py --seq DIR --frames 130 \
        --mode stereo-vi --kmax 256 --pmax 16384 --c13

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

`--max-frames N` passes to the runner: it tracks the first N frames of the
sequence (a cut of a phase's depth on the same files).

`--mode mono-vi` replays the same files with the IMU (`--t-loop` then
defaults to the script's 60 s lap, the sequence of phases 13 and 19b). It
also watches the mapper: the frame and keyframe count at which the IMU was
initialized, the frames of VIBA1 and VIBA2, and every `refine_scale` call
(its frame, keyframe count, whether it applied a transform, and that
transform's scale), plus the SE3 (unscaled) ATE and the Sim3 scale. `--no-loop`,
`--kmax` and `--pmax` pass to the runner; `--c13` repairs fault C13 in the
JAX `Tracker` as `tests/jax_vi_replay.py --c13` does (chip_smoke phase 19b's
constants come from `--c13`). The IMU noise is drawn after every image, so
the constants of an N-frame sequence come from `--frames N`.

`--mode stereo-vi` writes config 4's sequence instead (`fisheye=True`, the
TUM-VI layout of `make_synth_euroc.py --fisheye`: the 512x512 KB8 pair, its
settings and IMU) and replays it with `--dataset tumvi --mode stereo-vi`;
its ATE is the SE3 one, as the runner prints it for a metric sensor.

In both inertial modes it also records every frame's IMU prediction (the
camera centre of `predict_state` through the last gap, taken where the
`Tracker` turns it into a camera pose) and the tracked camera centre after
the frame, and prints fault C20's numbers (ROADMAP): the distance between
the two on the first frame after each frame whose call completed an IMU
stage (the IMU alignment, VIBA1, VIBA2, an applied scale refinement; under
async mapping the stage runs in that call's tick, after its tracking), and
the median over the other tracked frames after the IMU initialization.

Per loop closed (`loops`): the frame whose call closed it, the current and
loop keyframes and the keyframe count at the correction, the verified
Sim3's scale, the frame whose call finished the GBA that loop started
(None when a later loop aborted it or the run ended first), and fault
C20's distances on the frame after the loop's tick and on the frame after
that finish. Those frames count among the stages, so the median leaves
them out too.
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
import numpy as np

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from orbslam3_tpu.eval.ate import associate, ate_rmse, umeyama  # noqa: E402
from orbslam3_tpu.optim import ba as jba  # noqa: E402
from orbslam3_tpu.pipeline import gba as jgba  # noqa: E402
from orbslam3_tpu.pipeline import inertial_support as jisup  # noqa: E402
from orbslam3_tpu.pipeline.inertial_support import ImuInitializer  # noqa: E402
from orbslam3_tpu.pipeline.loop_closing import LoopCloser  # noqa: E402
from orbslam3_tpu.system import System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402
from orbslam3_tpu_torch.io import datasets  # noqa: E402


# A long run compiles thousands of executables, each holding memory maps of
# its code; past the kernel's vm.max_map_count (65530) LLVM cannot allocate
# and the process dies. Dropping the compiled executables frees them (the
# persistent compile cache reloads them); the results do not change.
MAX_MAPS = 40000


def c20_errors(pred_err: dict, stages: dict, init_frame) -> dict:
    """Fault C20's numbers from {frame: |IMU prediction - tracked centre|}
    and {stage: the frame whose call completed it}: per stage, the error on
    the frame after it; the median and the largest over the other frames
    after the IMU initialization."""
    after_stage = {k + 1 for k in stages.values() if k is not None}
    rest = sorted(e for k, e in pred_err.items()
                  if init_frame is not None and k > init_frame and k not in after_stage)
    med = rest[len(rest) // 2] if len(rest) % 2 else (
        (rest[len(rest) // 2 - 1] + rest[len(rest) // 2]) / 2 if rest else None)
    return dict(after={name: pred_err.get(k + 1) for name, k in stages.items() if k is not None},
                median_other=med, max_other=rest[-1] if rest else None, n_other=len(rest))


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
    ap.add_argument("--t-loop", type=float, default=None,
                    help="lap seconds (default 8 for mono, the script's 60 for mono-vi)")
    ap.add_argument("--mode", choices=["mono", "mono-vi", "stereo-vi"], default="mono")
    ap.add_argument("--sync-mapping", action="store_true")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="the runner's --max-frames: track the sequence's first N frames")
    ap.add_argument("--kmax", type=int, default=None)
    ap.add_argument("--pmax", type=int, default=None)
    ap.add_argument("--c13", action="store_true", help="repair fault C13 in the JAX Tracker")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.t_loop is None and a.mode == "mono":
        a.t_loop = 8.0
    if a.c13:
        from jax_vi_replay import repair_c13

        repair_c13()
    t0 = time.time()
    stereo = a.mode == "stereo-vi"
    if not os.path.exists(os.path.join(a.seq, "settings.yaml")):
        E.write_euroc_sequence(a.seq, a.frames, 0, t_loop=a.t_loop, imu=True, fisheye=stereo)
    digest = datasets.sequence_digest(a.seq)
    print(f"sequence {a.seq}: sha256 {digest} ({time.time() - t0:.1f} s)", flush=True)

    watch = dict(frame=-1, slam=None, loops=[], states=[], refine=[], n_kf=[],
                 corrections=[], finishes=[])
    vi = dict(imu_init_frame=None, imu_init_kfs=None, viba1_frame=None, viba2_frame=None)
    preds, tracked, pred_err = {}, {}, {}
    refine = ImuInitializer.refine_scale
    body_to_cam = jisup.body_to_cam
    tick = System._tick_gba
    correct_loop = LoopCloser._correct_loop
    finish = jgba.AsyncGBA._finish

    def corrected(self, kf_id, loop_kf, R21, t21, s21):
        watch["corrections"].append(dict(frame=watch["frame"], kf=int(kf_id),
                                         loop_kf=int(loop_kf), n_kf=int(self.store.n_kf),
                                         scale=float(s21)))
        return correct_loop(self, kf_id, loop_kf, R21, t21, s21)

    def finished(self, store):
        watch["finishes"].append(watch["frame"])
        return finish(self, store)

    def ticked(self):  # the tracked camera centre, before the tick may move the map
        last = self.tracker.last_frame
        if last is not None and self.tracking_state.name == "OK":
            R, t = np.asarray(last.R, np.float64), np.asarray(last.t, np.float64)
            tracked[watch["frame"]] = -R.T @ t
        return tick(self)

    def predicted(R_wb, p_wb, Rbc, tbc):
        if sys._getframe(1).f_code.co_filename.endswith("tracking.py"):  # the IMU prediction
            preds[watch["frame"]] = np.asarray(p_wb) + np.asarray(R_wb) @ np.asarray(tbc)
        return body_to_cam(R_wb, p_wb, Rbc, tbc)

    def watching(track):
        def watched(self, *args, **kw):
            return _watched(track, self, *args, **kw)

        return watched

    def _watched(track, self, *args, **kw):
        watch["slam"] = self
        watch["frame"] += 1
        with open("/proc/self/maps") as f:
            n_maps = sum(1 for _ in f)
        if n_maps > MAX_MAPS:  # compiled executables' code maps near the kernel's limit
            jax.clear_caches()
            print(f"frame {watch['frame']}: {n_maps} memory maps, JAX caches cleared",
                  flush=True)
        n_before = self.loop_closer.n_loops_closed if self.loop_closer else 0
        out = track(self, *args, **kw)
        k = watch["frame"]
        if k in preds and k in tracked and self.tracking_state.name == "OK":
            pred_err[k] = float(np.linalg.norm(preds[k] - tracked[k]))
        if self.loop_closer is not None and self.loop_closer.n_loops_closed > n_before:
            watch["loops"].append(watch["frame"])
        watch["states"].append(self.tracking_state.name)
        watch["n_kf"].append(self.store.n_kf)
        ini = self.mapper.imu_init
        if ini is not None:
            k = watch["frame"]
            if vi["imu_init_frame"] is None and ini.initialized:
                vi.update(imu_init_frame=k, imu_init_kfs=self.store.n_kf)
            if vi["viba1_frame"] is None and ini.viba1_done:
                vi["viba1_frame"] = k
            if vi["viba2_frame"] is None and ini.viba2_done:
                vi["viba2_frame"] = k
        return out

    def watched_refine(self, store, *args, **kw):
        ok = refine(self, store, *args, **kw)
        t = self.applied_transform
        watch["refine"].append(dict(frame=watch["frame"], n_kf=store.n_kf, ok=bool(ok),
                                    scale=None if t is None else float(t[1])))
        return ok

    System.track_monocular = watching(System.track_monocular)
    System.track_stereo = watching(System.track_stereo)
    ImuInitializer.refine_scale = watched_refine
    jisup.body_to_cam = predicted
    System._tick_gba = ticked
    LoopCloser._correct_loop = corrected
    jgba.AsyncGBA._finish = finished
    spec = importlib.util.spec_from_file_location(
        "run_sequence", os.path.join(REPO, "scripts", "run_sequence.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    out_dir = a.seq.rstrip("/") + "_jax"  # the sequence's directory stays as written
    os.makedirs(out_dir, exist_ok=True)
    traj = os.path.join(out_dir, "sync.txt" if a.sync_mapping else "async.txt")
    if a.mode != "mono":
        traj = traj.replace(".txt", "_vi.txt" if a.mode == "mono-vi" else "_svi.txt")
    argv_run = ["run_sequence.py", os.path.join(a.seq, "settings.yaml"), a.seq,
                "--dataset", "tumvi" if stereo else "euroc", "--mode", a.mode, "--out", traj,
                "--kf-out", traj.replace(".txt", "_kf.txt")]
    if a.sync_mapping:
        argv_run.append("--sync-mapping")
    if a.no_loop:
        argv_run.append("--no-loop")
    for flag, v in (("--kmax", a.kmax), ("--pmax", a.pmax),
                    ("--max-frames", a.max_frames or None)):
        if v is not None:
            argv_run += [flag, str(v)]
    buf = io.StringIO()
    sys.argv = argv_run
    t1 = time.time()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        runner.main()
    text = buf.getvalue()
    slam = watch["slam"]
    lc = slam.loop_closer
    gba = lc.gba_async if lc is not None else None
    ts, pos = slam.get_trajectory()
    gt = datasets.load_groundtruth_euroc(a.seq)
    ate_full = ate_rmse(ts, pos, gt[0], gt[1], with_scale=True)
    ate = re.search(r"ATE RMSE: ([0-9.]+) m", text)
    stages = dict(imu_init=vi["imu_init_frame"], viba1=vi["viba1_frame"],
                  viba2=vi["viba2_frame"])
    stages.update({f"refinement {i + 1}": r["frame"]
                   for i, r in enumerate(x for x in watch["refine"] if x["ok"])})
    loops = []
    corr = watch["corrections"]
    for i, c in enumerate(corr):
        nxt = corr[i + 1]["frame"] if i + 1 < len(corr) else None
        fin = next((f for f in watch["finishes"] if f >= c["frame"]
                    and (nxt is None or f < nxt)), None)
        loops.append(dict(c, gba_finish=fin, c20_after_tick=pred_err.get(c["frame"] + 1),
                          c20_after_finish=None if fin is None else pred_err.get(fin + 1)))
        stages[f"loop {i + 1}"] = c["frame"]
        if fin is not None:
            stages[f"gba finish {i + 1}"] = fin
    first_ok = next((k for k, s in enumerate(watch["states"]) if s == "OK"), None)
    ia, ib = associate(ts, gt[0])
    out = dict(frames=a.frames, max_frames=a.max_frames, t_loop=a.t_loop, mode=a.mode,
               sync_mapping=a.sync_mapping,
               no_loop=a.no_loop, c13=a.c13, digest=digest,
               ate=ate_full, ate_printed=float(ate.group(1)) if ate else None,
               ate_se3=ate_rmse(ts, pos, gt[0], gt[1], with_scale=False),
               scale=float(umeyama(pos[ia], gt[1][ib], with_scale=True)[0]),
               **vi, refine=watch["refine"], n_kf_per_frame=watch["n_kf"],
               c20=c20_errors(pred_err, stages, vi["imu_init_frame"]), loops=loops,
               gba_finish_frames=watch["finishes"],
               pred_err=[pred_err.get(k) for k in range(len(watch["states"]))],
               states=watch["states"],
               loop_frames=watch["loops"],
               n_loops=lc.n_loops_closed if lc is not None else 0,
               merges=slam.multimap.n_merges if slam.multimap else 0,
               n_kf=slam.store.n_kf, gba_finished=gba.n_finished if gba else 0,
               gba_aborted=gba.n_aborted if gba else 0,
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
