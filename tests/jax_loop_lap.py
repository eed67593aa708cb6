"""The JAX `System`'s run of the loop-and-kidnap lap that `chip_smoke.py`
phase 10 replays on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_loop_lap.py --t-loop 8 --frames 300 \
        --kidnap-at 280 --kidnap-src 40 [--out FILE] [--init-out FILE.npz]

Renders the synthetic EuRoC sequence of `scripts/make_synth_euroc.py`
(seed 0) with its lap shortened to `--t-loop` seconds, runs
`orbslam3_tpu.system.System(MONOCULAR, PINHOLE, (752, 480), OrbParams())`
with place recognition on at the reference's defaults (the 97k-word
vocabulary), and from frame `--kidnap-at` on feeds the images of frames
`--kidnap-src`... at increasing timestamps. Prints one JSON line: the loops
closed (keyframe pair, frame, ATE before and after each correction), GBA
runs finished, the state of every frame, the frame that relocalized, and
the Sim3 ATE over the whole trajectory. chip_smoke's phase-10 constants
come from this script. Not a test: nothing collects it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu.eval.ate import ate_rmse  # noqa: E402
from orbslam3_tpu.io.vocab_io import load_binary_vocabulary  # noqa: E402
from orbslam3_tpu.ops import cameras as cam  # noqa: E402
from orbslam3_tpu.ops import features as feat  # noqa: E402
from orbslam3_tpu.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth_100k.bin")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-loop", type=float, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--kidnap-at", type=int, required=True)
    ap.add_argument("--kidnap-src", type=int, required=True)
    ap.add_argument("--out")
    ap.add_argument("--init-out", help="an .npz of the two-view initialization's map")
    a = ap.parse_args(argv)
    t0 = time.time()
    gt_ts, imgs, gt_pos = E.euroc_frames(a.frames, 0, t_loop=a.t_loop,
                                         kidnap=(a.kidnap_at, a.kidnap_src))
    cfg = E.EUROC_MONO
    slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, np.asarray(cfg["camera"], np.float32),
                  cfg["img_wh"], feat.OrbParams(), Kmax=cfg["Kmax"], Pmax=cfg["Pmax"],
                  fps=cfg["fps"])
    slam.enable_place_recognition(load_binary_vocabulary(VOC))
    frame = [0]
    loops = []

    def on_correction(phase, kf_id, loop_kf):
        ts, pos = slam.get_trajectory()
        ate = ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
        if phase == "before":
            loops.append(dict(kf=int(kf_id), loop_kf=int(loop_kf), frame=frame[0], ate_before=ate))
        else:
            loops[-1]["ate_after"] = ate

    slam.loop_closer.on_correction = on_correction
    states, init = [], None
    for k, (t, img) in enumerate(zip(gt_ts, imgs)):
        frame[0] = k
        slam.track_monocular(img.astype(np.float32), float(t))
        states.append(slam.tracking_state.name)
        if init is None and states[-1] == "OK":
            s = slam.store.state
            n = slam.store.n_kf
            init = dict(frame=k, n_kf=n, n_mp=int(np.asarray(s.mp_valid).sum()))
            if a.init_out:
                np.savez(a.init_out, frame=k, kf_R=np.asarray(s.kf_R)[:n],
                         kf_t=np.asarray(s.kf_t)[:n], mp_valid=np.asarray(s.mp_valid),
                         mp_pos=np.asarray(s.mp_pos), kf_mp=np.asarray(s.kf_mp)[:n])
        print(k, states[-1], slam.store.n_kf, flush=True, file=sys.stderr)
    gba = slam.loop_closer.gba_async
    n_fin_before_join = gba.n_finished
    slam.shutdown()
    ts, pos = slam.get_trajectory()
    ate = ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
    lost = [k for k in range(a.kidnap_at, a.frames) if states[k] != "OK"]
    reloc = next((k for k in range(a.kidnap_at, a.frames)
                  if states[k] == "OK" and k > a.kidnap_at and states[k - 1] != "OK"), None)
    out = dict(t_loop=a.t_loop, frames=a.frames, kidnap_at=a.kidnap_at, kidnap_src=a.kidnap_src,
               init=init, loops=loops, n_loops=slam.loop_closer.n_loops_closed,
               gba_finished=n_fin_before_join, gba_finished_after_join=gba.n_finished,
               gba_aborted=gba.n_aborted, n_kf=slam.store.n_kf, lost_after_kidnap=lost,
               relocalized_at=reloc, states=states, ate=ate, poses=len(ts),
               seconds=time.time() - t0)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
