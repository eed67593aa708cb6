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
    ap.add_argument("--blind-at", type=int, required=True)
    ap.add_argument("--blind-n", type=int, required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    t0 = time.time()
    gt_ts, imgs, gt_pos = E.euroc_frames(a.frames, 0, t_loop=a.t_loop,
                                         blind=(a.blind_at, a.blind_n))
    cfg = E.EUROC_MONO
    slam = System(Sensor.MONOCULAR, cam.CameraModel.PINHOLE, np.asarray(cfg["camera"], np.float32),
                  cfg["img_wh"], feat.OrbParams(), Kmax=cfg["Kmax"], Pmax=cfg["Pmax"],
                  fps=cfg["fps"])
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
        do_merge(act, target, R, t, s)
        merges[-1]["n_kf_after"] = target.n_kf

    mm._create_map, mm._verify_merge, mm._do_merge = on_create_map, on_verify_merge, on_do_merge
    states, n_maps, n_kf = [], [], []
    for k, (t, img) in enumerate(zip(gt_ts, imgs)):
        frame[0] = k
        slam.track_monocular(img.astype(np.float32), float(t))
        states.append(slam.tracking_state.name)
        n_maps.append(mm.atlas.n_maps)
        n_kf.append(slam.store.n_kf)
        print(k, states[-1], n_maps[-1], n_kf[-1], flush=True, file=sys.stderr)
    gba = slam.loop_closer.gba_async
    n_fin_before_join = gba.n_finished
    slam.shutdown()
    seen = np.ones(a.frames, bool)
    seen[a.blind_at:a.blind_at + a.blind_n] = False
    ts, pos = slam.get_trajectory()
    ate = ate_rmse(ts, pos, gt_ts[seen], gt_pos[seen], with_scale=True, max_dt=0.01)
    out = dict(t_loop=a.t_loop, frames=a.frames, blind_at=a.blind_at, blind_n=a.blind_n,
               stored=stored, merges=merges, n_merges=mm.n_merges, n_maps=n_maps,
               gba_finished=n_fin_before_join, gba_finished_after_join=gba.n_finished,
               gba_aborted=gba.n_aborted, n_kf=n_kf, final_n_kf=slam.store.n_kf,
               n_loops=slam.loop_closer.n_loops_closed, states=states, ate=ate,
               poses=len(ts), seconds=time.time() - t0)
    line = json.dumps(out)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
