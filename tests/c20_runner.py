"""Fault C20 under asynchronous mapping, on the card: the port's runner at its
defaults (asynchronous mapping, place recognition, the Atlas; Kmax 256, Pmax
16384) on config 3 or config 4, and how far each frame's IMU prediction lies
from its tracked camera centre.

    python tests/c20_runner.py --seq DIR [--mode mono-vi|stereo-vi] [--frames N]
        [--t-loop T] [--repo CHECKOUT] [--device cpu] [--out FILE]
    python tests/c20_runner.py --seq DIR --frames 260 --t-loop 8   # phase 21's lap

Writes `entry.write_euroc_sequence(DIR, N, 0, t_loop=T, imu=True)` (config 3,
530 frames of the script's 60 s lap by default; with `--mode stereo-vi`
config 4's fisheye pair in the TUM-VI layout, 130) unless DIR holds it, then
runs `run_sequence.main` of the
package in `--repo` (default: the checkout holding this script) on it. It
watches the run from outside, through names every checkout since the runner
has (`Tracker._imu_predict`, `System._tick_gba`, `System.track_*`,
`ImuInitializer.refine_scale`, `System.n_loops_closed`, `AsyncGBA.n_finished`),
so a parent checkout (unpacked with `git archive` into an ignored directory)
is measured the same way on the same files. Per frame: the camera centre of
the IMU prediction, the tracked centre before the frame's tick of
background work, the IMU stages completed, whether a loop correction or a
background global BA completed in its call. Prints one JSON line: per stage
(the IMU initialization, VIBA1, VIBA2, each applied scale refinement) and
per event ("loop 1", ..., "GBA 1", ...) the frame whose call completed it
and the distance (m) on the frame after it, the median and the three largest
over the other frames after the IMU initialization, the frames not OK and
the share of frames that took the pose-inertial result. Not a test: nothing
collects it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", required=True)
    ap.add_argument("--mode", choices=["mono-vi", "stereo-vi"], default="mono-vi")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--t-loop", type=float, default=None, help="lap seconds (config 3 only)")
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    stereo = a.mode == "stereo-vi"
    n = a.frames or (130 if stereo else 530)
    sys.path.insert(0, os.path.abspath(a.repo))
    from orbslam3_tpu_torch import entry as E
    from orbslam3_tpu_torch import run_sequence
    from orbslam3_tpu_torch.pipeline import inertial_support as isup
    from orbslam3_tpu_torch.pipeline.tracking import Tracker
    from orbslam3_tpu_torch.system import System

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(a.seq, "settings.yaml")):
        E.write_euroc_sequence(a.seq, n, 0, t_loop=a.t_loop, imu=True, fisheye=stereo)
    write_s = time.perf_counter() - t0
    rows, seen = [], {}
    originals = {}

    def patch(cls, name, fn):
        originals[cls, name] = getattr(cls, name)
        setattr(cls, name, fn)

    def gba_finished(slam):
        g = None if slam.loop_closer is None else slam.loop_closer.gba_async
        return 0 if g is None else g.n_finished

    def watching(name):
        def track(self, *args, **kw):
            seen.clear()
            loops, gbas = self.n_loops_closed, gba_finished(self)
            out = originals[System, name](self, *args, **kw)
            ini = self.mapper.imu_init
            rows.append(dict(state=self.tracking_state.name, n_kf=self.n_keyframes,
                             stages=(bool(ini.initialized), bool(ini.viba1_done),
                                     bool(ini.viba2_done)),
                             refined=bool(seen.get("refined")), pred=seen.get("pred"),
                             centre=seen.get("centre"), pi=bool(self.tracker.pi_taken),
                             loop=self.n_loops_closed > loops, gba=gba_finished(self) > gbas))
            return out

        return track

    def tick(self):
        last = self.tracker.last_frame
        if last is not None and self.tracking_state.name == "OK":
            seen["centre"] = -np.asarray(last.R, np.float64).T @ np.asarray(last.t, np.float64)
        return originals[System, "_tick_gba"](self)

    def imu_predict(self, last):
        out = originals[Tracker, "_imu_predict"](self, last)
        seen["pred"] = -np.asarray(out[0], np.float64).T @ np.asarray(out[1], np.float64)
        return out

    def refine_scale(self, *args, **kw):
        ok = originals[isup.ImuInitializer, "refine_scale"](self, *args, **kw)
        seen["refined"] = seen.get("refined", False) or bool(ok)
        return ok

    for name in ("track_monocular", "track_stereo"):
        patch(System, name, watching(name))
    patch(System, "_tick_gba", tick)
    patch(Tracker, "_imu_predict", imu_predict)
    patch(isup.ImuInitializer, "refine_scale", refine_scale)
    out_dir = a.seq.rstrip("/") + "_c20"
    os.makedirs(out_dir, exist_ok=True)
    argv_run = [os.path.join(a.seq, "settings.yaml"), a.seq, "--dataset",
                "tumvi" if stereo else "euroc", "--mode", a.mode, "--kmax", "256", "--pmax",
                "16384", "--out", os.path.join(out_dir, "t.txt"), "--kf-out",
                os.path.join(out_dir, "kf.txt")]
    if a.device:
        argv_run += ["--device", a.device]
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = run_sequence.main(argv_run)
    finally:
        for (cls, name), fn in originals.items():
            setattr(cls, name, fn)
    stages = {}
    for i, name in enumerate(("imu_init", "viba1", "viba2")):
        k = next((k for k, r in enumerate(rows) if r["stages"][i]), None)
        if k is not None:
            stages[name] = k
    for i, k in enumerate(k for k, r in enumerate(rows) if r["refined"]):
        stages[f"refinement {i + 1}"] = k
    for key, name in (("loop", "loop"), ("gba", "GBA")):
        for i, k in enumerate(k for k, r in enumerate(rows) if r[key]):
            stages[f"{name} {i + 1}"] = k

    def err(r):
        if r["pred"] is None or r["centre"] is None:
            return None
        return float(np.linalg.norm(r["pred"] - r["centre"]))

    init = stages.get("imu_init")
    after = {k + 1 for k in stages.values()}
    rest = {k: err(r) for k, r in enumerate(rows) if init is not None and k > init
            and k not in after and err(r) is not None}
    post = [r for r in rows[init + 1:]] if init is not None else []
    line = dict(repo=os.path.abspath(a.repo), mode=a.mode, frames=n, t_loop=a.t_loop,
                stages=stages,
                after={name: err(rows[k + 1]) if k + 1 < len(rows) else None
                       for name, k in stages.items()},
                median=float(np.median(list(rest.values()))) if rest else None, n_other=len(rest),
                largest=sorted(rest.items(), key=lambda x: -x[1])[:3],
                not_ok=[k for k, r in enumerate(rows) if r["state"] != "OK"],
                pi_share=sum(r["pi"] for r in post) / max(len(post), 1), n_kf=res["n_kf"],
                n_loops=res["n_loops"], ate=res["ate"], write_s=write_s,
                run_s=time.perf_counter() - t1)
    text = json.dumps(line)
    print(text)
    if a.out:
        with open(a.out, "a") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
