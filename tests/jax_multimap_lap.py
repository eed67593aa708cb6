"""The JAX `System`'s run of the multi-map lap that `chip_smoke.py` phase 15
replays on the card, on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_multimap_lap.py --t-loop 16 --frames 360 \
        --blind-at 80 --blind-n 110 [--out FILE]

Renders the synthetic EuRoC sequence of `scripts/make_synth_euroc.py`
(seed 0) with its lap shortened to `--t-loop` seconds and frames
`--blind-at` ... `--blind-at + --blind-n - 1` a uniform grey (a covered
lens; `entry.euroc_frames(blind=...)`), runs
`orbslam3_tpu.system.System(MONOCULAR, PINHOLE, (752, 480), OrbParams())`
with place recognition and the Atlas on (the 97k-word vocabulary, as
`scripts/run_sequence.py` enables them). Prints one JSON line: the frame
that stored a map and the keyframe count of the map it stored, each
merge's frame, keyframe pair and world Sim3, the map count and state after
every frame, the GBA runs finished, the Sim3 ATE over the frames that are
not blind, and the seconds. chip_smoke's phase-15 constants come from this
script. Not a test: nothing collects it.

    JAX_PLATFORMS=cpu python tests/jax_multimap_lap.py --mode mono-vi --t-loop 16 \
        --frames 420 --track 360 --blind-at 100 --blind-n 110 [--out FILE]

runs config 3 instead (`Sensor.IMU_MONOCULAR` with `EUROC_MONO_VI`'s
calibration, each frame fed the 200 Hz samples with t at or before its time
as `entry.replay` feeds them, and fault C13 repaired as the port repairs it:
`jax_vi_replay.repair_c13`) and adds, per map, the frame and keyframe count
of its IMU initialization, VIBA1 and VIBA2, and per merge `imu_metric`, the
so3 log of the gated world rotation, the weld's BA ("inertial" or "visual")
and window and the graph's `dof4`; and the SE3 ATE and the Sim3 scale.
`--track M` tracks only the first M frames (the IMU noise stays the
N-frame sequence's; the ATE is over the frames tracked). chip_smoke's
phase-20 constants come from this run (1926 s on 8 cores): map 0's IMU at
frame 64 with 10 keyframes, map 0 stored at frame 205 with 19, map 1 from
frame 212 with its IMU at frame 252 with 10 keyframes, a merge at frame 311
on the inertial branch (imu_metric, s 0.953080, yaw only, the 16-keyframe
inertial weld, the 4-DoF graph), no frame lost after map 1's
initialization, 2 GBA runs finished, SE3 ATE 0.067729 m (all 420 frames:
the same events, 0.067225 m, 2025 s). On phase 15's blind interval (frames
80-189, 400 frames) the JAX System stores map 0 at frame 185 with 14
keyframes and initializes map 1's IMU at frame 231; the port's map 0 holds
10 keyframes at frame 80 and is reset, hence the later interval.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from orbslam3_tpu.eval.ate import associate, ate_rmse, umeyama  # noqa: E402
from orbslam3_tpu.io.vocab_io import load_binary_vocabulary  # noqa: E402
from orbslam3_tpu.ops import cameras as cam  # noqa: E402
from orbslam3_tpu.ops import features as feat  # noqa: E402
from orbslam3_tpu.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch import entry as E  # noqa: E402

# A long run of the JAX System on the CPU maps memory regions for every
# executable it compiles; past the kernel's `vm.max_map_count` (65530 by
# default) LLVM fails with "Cannot allocate memory" (the inertial lap reached
# it near frame 300). The lap then clears JAX's caches: the functions compile
# again to the same code, so the run's results do not change.
MAX_MAPPINGS = 40000


def _mappings() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth_100k.bin")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-loop", type=float, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--blind-at", type=int, required=True)
    ap.add_argument("--blind-n", type=int, required=True)
    ap.add_argument("--mode", choices=("mono", "mono-vi"), default="mono")
    ap.add_argument("--track", type=int, help="track only the first TRACK of the frames")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    vi = a.mode == "mono-vi"
    t0 = time.time()
    frames = E.euroc_frames(a.frames, 0, t_loop=a.t_loop, blind=(a.blind_at, a.blind_n),
                            imu=vi)
    gt_ts, imgs, gt_pos = frames[:3]
    if vi:
        from jax_vi_replay import repair_c13
        from orbslam3_tpu.ops import imu as imu_ops

        repair_c13()
        cfg = E.EUROC_MONO_VI
        Tbc = cfg["Tbc"]
        calib = imu_ops.ImuCalib.create(Tbc[:3, :3], Tbc[:3, 3], **cfg["imu"])
        batches = E.imu_batches(gt_ts, frames[3])
        slam = System(Sensor.IMU_MONOCULAR, cam.CameraModel.PINHOLE,
                      np.asarray(cfg["camera"], np.float32), cfg["img_wh"], feat.OrbParams(),
                      imu_calib=calib, Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
    else:
        cfg = E.EUROC_MONO
        batches = [None] * a.frames
        slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE,
                      np.asarray(cfg["camera"], np.float32), cfg["img_wh"], feat.OrbParams(),
                      Kmax=cfg["Kmax"], Pmax=cfg["Pmax"], fps=cfg["fps"])
    voc = load_binary_vocabulary(VOC)
    slam.enable_place_recognition(voc)
    slam.enable_multimap(voc)
    mm = slam.multimap
    frame = [0]
    stored, merges = [], []
    create_map, verify_merge, do_merge = mm._create_map, mm._verify_merge, mm._do_merge

    def on_create_map():
        stored.append(dict(frame=frame[0], n_kf=slam.store.n_kf))
        create_map()

    def on_verify_merge(act, target, kf_id, cand):
        n = len(merges)
        ok = verify_merge(act, target, kf_id, cand)
        if ok:
            merges[n].update(kf=int(kf_id), cand=int(cand))
        return ok

    def on_do_merge(act, target, R, t, s):
        merges.append(dict(frame=frame[0], n_kf_active=act.n_kf, n_kf_target=target.n_kf,
                           R=np.asarray(R).tolist(), t=np.asarray(t).tolist(), s=float(s)))
        if vi:
            merges[-1].update(imu_metric=bool(slam.tracker.imu_ready),
                              log_R=np.asarray(lie.log_so3(jnp.asarray(R, jnp.float32))).tolist())
        do_merge(act, target, R, t, s)
        merges[-1]["n_kf_after"] = target.n_kf

    mm._create_map, mm._verify_merge, mm._do_merge = on_create_map, on_verify_merge, on_do_merge
    imu_maps = []  # one entry per map: the frames and keyframe counts of its IMU stages
    if vi:
        import jax.numpy as jnp

        from orbslam3_tpu.ops import lie
        from orbslam3_tpu.optim import pose_graph as pg

        mapper = slam.mapper
        inertial_ba, visual_ba, solve_graph = (mapper._local_inertial_ba, mapper._local_ba,
                                               pg.solve_pose_graph)

        def merging():
            return merges and "n_kf_after" not in merges[-1]

        def on_inertial_ba(kf_id, *args, **kw):
            if merging():
                merges[-1].update(weld="inertial", weld_window=kw.get("window"))
            return inertial_ba(kf_id, *args, **kw)

        def on_visual_ba(kf_id, *args, **kw):
            if merging():
                merges[-1].update(weld="visual")
            return visual_ba(kf_id, *args, **kw)

        def on_solve_graph(graph, *args, **kw):
            if merging():
                merges[-1]["dof4"] = bool(kw.get("dof4", False))
            return solve_graph(graph, *args, **kw)

        mapper._local_inertial_ba, mapper._local_ba = on_inertial_ba, on_visual_ba
        pg.solve_pose_graph = on_solve_graph
    states, n_maps, n_kf, cleared = [], [], [], []
    for k, (t, img) in enumerate(zip(gt_ts[:a.track], imgs)):
        frame[0] = k
        slam.track_monocular(img.astype(np.float32), float(t), imu_measurements=batches[k])
        states.append(slam.tracking_state.name)
        n_maps.append(mm.atlas.n_maps)
        n_kf.append(slam.store.n_kf)
        if vi:
            ini = slam.mapper.imu_init
            if not imu_maps or imu_maps[-1]["obj"] is not ini:
                imu_maps.append(dict(obj=ini, first_frame=k, init=None, init_kfs=None,
                                     viba1=None, viba1_kfs=None, viba2=None, viba2_kfs=None))
            m = imu_maps[-1]
            for key, done in (("init", ini.initialized), ("viba1", ini.viba1_done),
                              ("viba2", ini.viba2_done)):
                if m[key] is None and done:
                    m[key], m[key + "_kfs"] = k, slam.store.n_kf
        print(k, states[-1], n_maps[-1], n_kf[-1], slam.mapper.imu_initialized if vi else "",
              flush=True, file=sys.stderr)
        if _mappings() > MAX_MAPPINGS:
            jax.clear_caches()
            gc.collect()
            cleared.append(k)
    gba = slam.loop_closer.gba_async
    n_fin_before_join = gba.n_finished
    slam.shutdown()
    seen = np.ones(a.frames, bool)
    seen[a.blind_at:a.blind_at + a.blind_n] = False
    ts, pos = slam.get_trajectory()
    ate = ate_rmse(ts, pos, gt_ts[seen], gt_pos[seen], with_scale=True, max_dt=0.01)
    extra = {}
    if vi:
        ia, ib = associate(ts, gt_ts[seen], 0.01)
        extra = dict(
            mode=a.mode, imu_maps=[{k: v for k, v in m.items() if k != "obj"} for m in imu_maps],
            ate_se3=ate_rmse(ts, pos, gt_ts[seen], gt_pos[seen], with_scale=False, max_dt=0.01),
            scale=float(umeyama(pos[ia], gt_pos[seen][ib], with_scale=True)[0]))
    out = dict(t_loop=a.t_loop, frames=a.frames, track=a.track, blind_at=a.blind_at,
               blind_n=a.blind_n,
               stored=stored, merges=merges, n_merges=mm.n_merges, n_maps=n_maps,
               gba_finished=n_fin_before_join, gba_finished_after_join=gba.n_finished,
               gba_aborted=gba.n_aborted, n_kf=n_kf, final_n_kf=slam.store.n_kf,
               n_loops=slam.loop_closer.n_loops_closed, states=states, ate=ate,
               poses=len(ts), **extra, caches_cleared_at=cleared, seconds=time.time() - t0)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
