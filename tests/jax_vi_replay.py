"""The JAX `System`'s run of the monocular-inertial replay that
`chip_smoke.py` phase 13 drives on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_vi_replay.py --frames 160 [--c13] [--out FILE]

Renders the synthetic EuRoC sequence of `scripts/make_synth_euroc.py` (seed
0) with its 200 Hz IMU stream through the port's `entry.euroc_frames(...,
imu=True)` (numpy only), and runs `orbslam3_tpu.system.System(IMU_MONOCULAR,
PINHOLE, (752, 480), OrbParams(), imu_calib=ImuCalib.create(Tbc = I, the
script's IMU.* noise))` (Kmax 256, Pmax 16384), each frame fed the samples
with t at or before its time (`entry.imu_batches`). Prints one JSON line:
the state of every frame, the frame of map initialization, the frame and
the keyframe count at which the IMU was initialized, the frames at which
VIBA1 and VIBA2 ran, keyframe and map-point counts, the SE3 (unscaled) and
Sim3 ATE and the Sim3 scale. The sequence's IMU noise is drawn after all
its images (as the script draws it), so a run of fewer frames has other
IMU samples: the constants of an N-frame replay come from `--frames N`.
`--track M` tracks only the first M of them (`entry.replay(..., n_track=M)`;
the ATE is then over those frames).

`--c13` repairs fault C13 (ROADMAP) in the JAX `Tracker` for this run only,
the way the port repairs it: the keyframe frame whose mapping pass
initialized the IMU (or refined the scale) keeps its pose from before the
map's gravity and scale alignment, so the next frame is predicted from a
pose in the old frame and tracking is lost; repaired, that frame takes its
keyframe's pose. The JAX package's files are not changed. chip_smoke's
phase-13 constants come from this script with `--c13`. Not a test: nothing
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

from orbslam3_tpu.eval.ate import ate_rmse, associate, umeyama  # noqa: E402
from orbslam3_tpu.ops import cameras as cam  # noqa: E402
from orbslam3_tpu.ops import features as feat  # noqa: E402
from orbslam3_tpu.ops import imu as imu_ops  # noqa: E402
from orbslam3_tpu.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402


def repair_c13():
    """Patch the JAX `Tracker` (this process only): after a keyframe's
    mapping pass applied a map transform, the frame takes its keyframe's
    pose (the port's `Tracker._create_keyframe`)."""
    from orbslam3_tpu.pipeline import tracking as trk

    apply, create = trk.Tracker.apply_map_transform, trk.Tracker._create_keyframe_impl

    def apply_map_transform(self, Rwg, s):
        apply(self, Rwg, s)
        self._map_transformed = True

    def create_keyframe_impl(self, cur):
        self._map_transformed = False
        create(self, cur)
        if self._map_transformed:
            kf = self.last_kf_id
            cur.R = np.asarray(self.store.state.kf_R[kf])
            cur.t = np.asarray(self.store.state.kf_t[kf])

    trk.Tracker.apply_map_transform = apply_map_transform
    trk.Tracker._create_keyframe_impl = create_keyframe_impl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--c13", action="store_true", help="repair fault C13 in the JAX Tracker")
    ap.add_argument("--track", type=int, help="track only the first TRACK of the frames")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if a.c13:
        repair_c13()
    t0 = time.time()
    cfg = E.EUROC_MONO_VI
    gt_ts, imgs, gt_pos, imu = E.euroc_frames(a.frames, 0, imu=True)
    Tbc = cfg["Tbc"]
    calib = imu_ops.ImuCalib.create(Tbc[:3, :3], Tbc[:3, 3], **cfg["imu"])
    slam = System(Sensor.IMU_MONOCULAR, cam.CameraModel.PINHOLE,
                  np.asarray(cfg["camera"], np.float32), cfg["img_wh"], feat.OrbParams(),
                  imu_calib=calib, Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
    states, n_kf = [], []
    init_frame = init_kfs = viba1 = viba2 = None
    batches = E.imu_batches(gt_ts, imu)[:a.track]
    for k, (t, batch) in enumerate(zip(gt_ts, batches)):
        slam.track_monocular(imgs[k].astype(np.float32), float(t), imu_measurements=batch)
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
    out = dict(frames=a.frames, track=a.track, c13=a.c13, states=states, n_kf_per_frame=n_kf,
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
