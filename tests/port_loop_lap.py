"""The port's run of phase 10's loop-and-kidnap lap on the CPU, the
counterpart of `tests/jax_loop_lap.py` (fault C16: the two-view
initialization and the ATE before the closure, both packages on one host).

    python tests/port_loop_lap.py --t-loop 8 --frames 260 --kidnap-at 240 \
        --kidnap-src 40 [--threads 8] [--init-out FILE.npz] [--compare-init JAX.npz] \
        [--dlt svd]

Runs `entry.mono_replay("cpu", ...)` with place recognition at the
reference's defaults (the 97k-word vocabulary) and prints one JSON line with
the fields of `jax_loop_lap.py`'s: the frame of the two-view initialization
and its map's size, the loops (keyframe pair, frame, ATE before and after),
GBA runs, the states, the relocalizing frame, the Sim3 ATE and the seconds.
`--compare-init` reads the JAX run's `--init-out` file and adds the two
initial maps' differences: the frame, keyframe 1's pose, the point count and
the points of the slots both hold. `--dlt svd` triangulates the two-view
initialization's points by the reference's float32 SVD instead of the
port's float64 inverse iteration (`ops/ransac.py::triangulate_linear`).
Not a test: nothing collects it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from orbslam3_tpu_torch import entry as E  # noqa: E402
from orbslam3_tpu_torch.ops import ransac  # noqa: E402

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth_100k.bin")


def svd_dlt(R, t, p1, p2):
    """`triangulate_linear` as the reference computes it: the right singular
    vector of the smallest singular value of the float32 DLT system."""
    lead = R.shape[:-2]
    P1 = torch.cat([torch.eye(3, dtype=R.dtype), torch.zeros(3, 1, dtype=R.dtype)], dim=1)
    P2 = torch.cat([R, t[..., :, None]], dim=-1)

    def rows(P, p):
        P = P[..., None, :, :]
        return torch.stack([p[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                            p[..., 1:2] * P[..., 2, :] - P[..., 1, :]], dim=-2)

    A = torch.cat([rows(P1.expand(*lead, 3, 4), p1), rows(P2, p2)], dim=-2)
    X = torch.linalg.svd(A)[2][..., -1, :]
    w = X[..., 3:4]
    return X[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--t-loop", type=float, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--kidnap-at", type=int, required=True)
    ap.add_argument("--kidnap-src", type=int, required=True)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--init-out")
    ap.add_argument("--compare-init")
    ap.add_argument("--dlt", choices=["inverse", "svd"], default="inverse")
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    if a.dlt == "svd":
        ransac.triangulate_linear = svd_dlt
    t0 = time.time()
    init = {}

    def on_frame(k, slam):
        if not init and slam.tracking_state.name == "OK":
            s = slam.store.state
            n = slam.store.n_kf
            init.update(frame=k, n_kf=n, n_mp=int(s.mp_valid.sum()), kf_R=s.kf_R[:n].numpy(),
                        kf_t=s.kf_t[:n].numpy(), mp_valid=s.mp_valid.numpy(),
                        mp_pos=s.mp_pos.numpy(), kf_mp=s.kf_mp[:n].numpy())
        print(k, slam.tracking_state.name, slam.store.n_kf, flush=True, file=sys.stderr)

    rep = E.mono_replay("cpu", a.frames, vocabulary=VOC, t_loop=a.t_loop,
                        kidnap=(a.kidnap_at, a.kidnap_src), on_frame=on_frame)
    if a.init_out:
        np.savez(a.init_out, **init)
    out = dict(dlt=a.dlt, t_loop=a.t_loop, frames=a.frames, kidnap_at=a.kidnap_at,
               kidnap_src=a.kidnap_src, init={k: init[k] for k in ("frame", "n_kf", "n_mp")},
               loops=rep.loops,
               n_loops=len(rep.loops), gba_finished=rep.gba_finished,
               gba_aborted=rep.gba_aborted, n_kf=rep.n_kf, lost_after_kidnap=rep.lost,
               relocalized_at=rep.relocalized, states=rep.states, ate=rep.ate,
               poses=len(rep.ts), seconds=time.time() - t0)
    if a.compare_init:
        j = np.load(a.compare_init)
        both = j["mp_valid"] & init["mp_valid"]
        out["init_vs_jax"] = dict(
            frame=(int(j["frame"]), init["frame"]),
            n_mp=(int(j["mp_valid"].sum()), init["n_mp"]),
            slots_in_both=int(both.sum()),
            kf1_R=float(np.abs(j["kf_R"][1] - init["kf_R"][1]).max()),
            kf1_t=float(np.abs(j["kf_t"][1] - init["kf_t"][1]).max()),
            points_max=float(np.abs(j["mp_pos"][both] - init["mp_pos"][both]).max()),
            points_median=float(np.median(np.linalg.norm(j["mp_pos"][both]
                                                         - init["mp_pos"][both], axis=1))))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
