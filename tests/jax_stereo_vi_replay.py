"""The JAX `System`'s run of the stereo-inertial replays that `chip_smoke.py`
phase 14 drives on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_stereo_vi_replay.py --frames 130 [--c13]
        [--mode fisheye|pinhole] [--out FILE]

`--mode fisheye` (the default; config 4) renders `scripts/make_synth_euroc.py
--fisheye`'s sequence (seed 0: the 512x512 Kannala-Brandt 8 pair 0.15 m
apart in the smaller room, with the 200 Hz IMU stream) through the port's
`entry.euroc_frames(..., fisheye=True, imu=True)` (numpy only), and runs
`orbslam3_tpu.system.System(IMU_STEREO, KB8, (512, 512), OrbParams(),
camera2=(the right camera, Tlr, lapping areas), imu_calib=...)` with the
numbers of `entry.EUROC_STEREO_VI_FISHEYE` (Kmax 256, Pmax 16384); `--mode
pinhole` runs `IMU_STEREO` on the rectified 752x480 pair (bf = 458 x 0.11,
`entry.EUROC_STEREO_VI`). Each frame is fed the samples with t at or before
its time (`entry.imu_batches`). Prints one JSON line: the state of every
frame, the frame and the keyframe count at which the IMU was initialized,
the frames of VIBA1 and VIBA2, keyframe and map-point counts, the SE3
(unscaled) and Sim3 ATE and the Sim3 scale. The IMU noise is drawn after
all the images, so the constants of an N-frame replay come from `--frames N`.

`--c13` repairs fault C13 (ROADMAP) in the JAX `Tracker` for this run only,
as `tests/jax_vi_replay.py --c13` does: the keyframe frame whose mapping
pass aligned the map to gravity takes its keyframe's pose. chip_smoke's
phase-14 constants come from this script with `--c13`. Not a test: nothing
collects it.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from jax_vi_replay import repair_c13  # noqa: E402
from orbslam3_tpu.eval.ate import ate_rmse, associate, umeyama  # noqa: E402
from orbslam3_tpu.ops import cameras as cam  # noqa: E402
from orbslam3_tpu.ops import imu as imu_ops  # noqa: E402
from orbslam3_tpu.ops.features import OrbParams  # noqa: E402
from orbslam3_tpu.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--mode", choices=("fisheye", "pinhole"), default="fisheye")
    ap.add_argument("--c13", action="store_true", help="repair fault C13 in the JAX Tracker")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.c13:
        repair_c13()
    t0 = time.time()
    fisheye = a.mode == "fisheye"
    cfg = E.EUROC_STEREO_VI_FISHEYE if fisheye else E.EUROC_STEREO_VI
    gt_ts, imgs, gt_pos, imu = E.euroc_frames(a.frames, 0, stereo=True, imu=True,
                                              fisheye=fisheye)
    Tbc = cfg["Tbc"]
    calib = imu_ops.ImuCalib.create(Tbc[:3, :3], Tbc[:3, 3], **cfg["imu"])
    camera2 = None
    if fisheye:
        params2, Tlr, lap1, lap2 = cfg["camera2"]
        camera2 = (np.asarray(params2, np.float32), Tlr, lap1, lap2)
    slam = System(Sensor.IMU_STEREO, cam.CameraModel.KB8 if fisheye else cam.CameraModel.PINHOLE,
                  np.asarray(cfg["camera"], np.float32), cfg["img_wh"],
                  OrbParams(*cfg["orb"]), bf=cfg.get("bf", 0.0), imu_calib=calib,
                  camera2=camera2, Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
    states, n_kf = [], []
    init_frame = init_kfs = viba1 = viba2 = None
    for k, (t, batch) in enumerate(zip(gt_ts, E.imu_batches(gt_ts, imu))):
        slam.track_stereo(imgs[k, 0].astype(np.float32), imgs[k, 1].astype(np.float32),
                          float(t), imu_measurements=batch)
        states.append(slam.tracking_state.name)
        n_kf.append(slam.n_keyframes)
        ini = slam.mapper.imu_init
        if init_frame is None and slam.mapper.imu_initialized:
            init_frame, init_kfs = k, slam.store.n_kf
        if viba1 is None and ini.viba1_done:
            viba1 = k
        if viba2 is None and ini.viba2_done:
            viba2 = k
        print(k, states[-1], slam.store.n_kf, slam.mapper.imu_initialized, flush=True,
              file=sys.stderr)
    ts, pos = slam.get_trajectory()
    ia, ib = associate(ts, gt_ts, 0.01)
    scale = float(umeyama(pos[ia], gt_pos[ib], with_scale=True)[0]) if len(ia) >= 3 else \
        float("nan")
    out = dict(frames=a.frames, mode=a.mode, c13=a.c13, states=states, n_kf_per_frame=n_kf,
               init=states.index("OK") if "OK" in states else None,
               imu_init_frame=init_frame, imu_init_kfs=init_kfs, viba1_frame=viba1,
               viba2_frame=viba2, n_kf=slam.store.n_kf,
               n_mp=int(np.asarray(slam.store.state.mp_valid).sum()),
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
