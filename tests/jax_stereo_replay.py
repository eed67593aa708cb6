"""The JAX `System`'s runs of the stereo, RGB-D and raw-stereo replays that
`chip_smoke.py` phases 11 and 12 drive on the card, and of phase 6's
monocular replay, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_stereo_replay.py --mode stereo --frames 120 [--out FILE]
    JAX_PLATFORMS=cpu python tests/jax_stereo_replay.py --mode rgbd --frames 60
    JAX_PLATFORMS=cpu python tests/jax_stereo_replay.py --mode raw --frames 30
    JAX_PLATFORMS=cpu python tests/jax_stereo_replay.py --mode mono --frames 60

Renders the synthetic EuRoC sequence of `scripts/make_synth_euroc.py` (seed
0) through the port's `entry.euroc_frames` (numpy only) with the same
arguments as the phase: `stereo=True` (the script's `--stereo` pair),
`depth=True` (the left image and its ray-cast depth), or `raw=True` (the
unrectified pair, rectified by `System.enable_rectification` with the
script's LEFT./RIGHT. blocks), or the monocular stream. It runs
`orbslam3_tpu.system.System(STEREO, RGBD or MONOCULAR, PINHOLE, (752, 480),
OrbParams(), bf=50.38)` (Kmax 256, Pmax 16384; no bf for MONOCULAR) and
prints one JSON line: the state of every frame, the frame of
initialization, keyframe and map-point counts, the SE3 (unscaled) and Sim3
ATE and the Sim3 scale. chip_smoke's phase-6, phase-11 and phase-12
constants come from this script. Not a test: nothing collects it.
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

from orbslam3_tpu.eval.ate import ate_rmse, associate, umeyama  # noqa: E402
from orbslam3_tpu.ops import cameras as cam  # noqa: E402
from orbslam3_tpu.ops import features as feat  # noqa: E402
from orbslam3_tpu.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("stereo", "rgbd", "raw", "mono"), required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    t0 = time.time()
    cfg = E.EUROC_MONO if a.mode == "mono" else E.EUROC_STEREO
    frames = E.euroc_frames(a.frames, 0, stereo=a.mode == "stereo", raw=a.mode == "raw",
                            depth=a.mode == "rgbd")
    gt_ts, imgs, gt_pos = frames[:3]
    sensor = {"rgbd": Sensor.RGBD, "mono": Sensor.MONOCULAR}.get(a.mode, Sensor.STEREO)
    slam = System(sensor, cam.CameraModel.PINHOLE, np.asarray(cfg["camera"], np.float32),
                  cfg["img_wh"], feat.OrbParams(), bf=cfg.get("bf", 0.0), Kmax=cfg["Kmax"],
                  Pmax=cfg["Pmax"], fps=cfg["fps"])
    if a.mode == "raw":
        slam.enable_rectification(*E.raw_stereo_rig())
    states, n_kf = [], []
    for k, t in enumerate(gt_ts):
        if a.mode == "mono":
            slam.track_monocular(imgs[k].astype(np.float32), float(t))
        elif a.mode == "rgbd":
            slam.track_rgbd(imgs[k].astype(np.float32), frames[3][k], float(t))
        else:
            slam.track_stereo(imgs[k, 0].astype(np.float32), imgs[k, 1].astype(np.float32),
                              float(t))
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
        print(k, states[-1], slam.store.n_kf, flush=True, file=sys.stderr)
    ts, pos = slam.get_trajectory()
    ia, ib = associate(ts, gt_ts, 0.01)
    scale = float(umeyama(pos[ia], gt_pos[ib], with_scale=True)[0])
    out = dict(mode=a.mode, frames=a.frames, states=states, n_kf_per_frame=n_kf,
               init=states.index("OK") if "OK" in states else None,
               n_kf=slam.store.n_kf, n_mp=int(np.asarray(slam.store.state.mp_valid).sum()),
               ate_se3=ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=False, max_dt=0.01),
               ate_sim3=ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01),
               scale=scale, poses=len(ts), seconds=time.time() - t0)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
