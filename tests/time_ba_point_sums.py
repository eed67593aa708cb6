"""Device time of the port's whole-map BA with each form of its per-point
sums, and of a background GBA chunk, on one GPU, all in one process.

    python tests/time_ba_point_sums.py [--reps 3]

Builds `tests/loop_scene.py::make_ba_map` maps at the port's shapes
(1000 observation slots a keyframe, Pmax 16384, 999 points that every
keyframe observes, stereo rows on every eighth keyframe, keyframe 0 fixed;
positions and points perturbed from a seed): 256 keyframes (config 1's
Kmax, the global BA's dense reduced system) and 80 (the local BA's 48 + 32
window). On each it runs `pipeline.gba.global_ba` (10 LM iterations) with
each form of `optim/ba.py::point_sum` on CUDA:

- "index_add": one `index_add_` by point (rows that share a point add in
  no fixed order on CUDA);
- "camera loop": the (point, camera) slots, then the cameras added one
  launch each;
- "one reduction": the slots, then one sum over the camera axis (the
  port's form).

The per-camera sums are the checkout's own in every form
(`optim/ba.py::CameraSums` where it exists). The forms run in the order a,
b, c, c, b, a, `--reps` times each, timed by CUDA events and the host
clock around the call. Prints, per map and form, the median device and
host ms, whether two runs of the form gave equal states, and the largest
difference of the keyframe positions from "one reduction"'s; then, per
map, a background GBA chunk (`gba.gba_step` with 2 iterations, what
`AsyncGBA.tick` launches, the checkout's default forms) timed the same
way, `--reps` x 4 times, and whether two whole-map BAs with the default
forms give equal states; then the card's name and power limit. Run it in
two checkouts on one card to compare them. Not a test: nothing collects
it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import loop_scene as LS  # noqa: E402

from orbslam3_tpu_torch.atlas import store as st  # noqa: E402
from orbslam3_tpu_torch.ops import features as feat  # noqa: E402
from orbslam3_tpu_torch.ops.cameras import CameraModel  # noqa: E402
from orbslam3_tpu_torch.optim import ba as ba_mod  # noqa: E402
from orbslam3_tpu_torch.pipeline import gba  # noqa: E402

NF, PMAX, N_PTS = 1000, 16384, 999


def _index_add(vals, op, oc, P, C):
    return ba_mod.segment_sum(vals, op, P)


def _camera_loop(vals, op, oc, P, C):
    slots = ba_mod.point_slots(vals, op, oc, P, C)
    acc = slots[:, 0]
    for c in range(1, C):
        acc = acc + slots[:, c]
    return acc


def _one_reduction(vals, op, oc, P, C):
    return ba_mod.point_slots(vals, op, oc, P, C).sum(1)


FORMS = {"index_add": _index_add, "camera loop": _camera_loop, "one reduction": _one_reduction}


def make_map(K: int, dev):
    arrays, info = LS.make_ba_map(K=K, Kmax=K, Nf=NF, Pmax=PMAX, n_pts=N_PTS,
                                  stereo=tuple(range(1, K, 8)))
    rng = np.random.default_rng(2)
    arrays["kf_t"][1:K] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    arrays["mp_pos"][1:info["n_mp"]] += rng.normal(0, 0.05, (info["n_mp"] - 1, 3)).astype(
        np.float32)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in arrays.items()}, info


def run_once(arrays, info, K: int, dev, form):
    """(device ms, host ms, final MapState) of one `global_ba` with `form`."""
    store = st.MapStore(Kmax=K, Pmax=PMAX, Nf=NF, device=dev)
    store.state = st.MapState(**{k: v.clone() for k, v in arrays.items()})
    store.n_kf, store.n_mp, store.kf_ts = K, info["n_mp"], info["kf_ts"]
    params = torch.from_numpy(LS.PARAMS.copy()).to(dev)
    s2 = torch.from_numpy(feat.sigma2(feat.OrbParams(n_levels=4))).to(dev)
    saved = ba_mod.point_sum
    ba_mod.point_sum = form
    try:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        h0 = time.perf_counter()
        ev[0].record()
        gba.global_ba(store, CameraModel.PINHOLE, params, s2, bf=30.0)
        ev[1].record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - h0) * 1e3
    finally:
        ba_mod.point_sum = saved
    return ev[0].elapsed_time(ev[1]), host, store.state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    out = {}
    for K in (256, 80):
        arrays, info = make_map(K, dev)
        run_once(arrays, info, K, dev, _one_reduction)  # warm-up
        times = {name: [] for name in FORMS}
        states = {name: [] for name in FORMS}
        order = list(FORMS) + list(reversed(FORMS))
        for _ in range(args.reps):
            for name in order:
                d, h, s = run_once(arrays, info, K, dev, FORMS[name])
                times[name].append((d, h))
                states[name].append(s)
        ref = states["one reduction"][0]
        rows = {}
        for name in FORMS:
            a, b = states[name][0], states[name][1]
            repeats = all(torch.equal(getattr(a, k), getattr(b, k))
                          for k in ("kf_R", "kf_t", "mp_pos"))
            rows[name] = dict(
                device_ms=statistics.median(d for d, _ in times[name]),
                host_ms=statistics.median(h for _, h in times[name]),
                runs=len(times[name]), repeats_exactly=repeats,
                max_kf_t_diff=float((a.kf_t - ref.kf_t).abs().max()))
            print(f"BA point sums, {K} keyframes x {PMAX} points ({K * NF} observation slots), "
                  f"{name}: device {rows[name]['device_ms']:.3f} ms, host "
                  f"{rows[name]['host_ms']:.3f} ms (median of {len(times[name])}), repeats "
                  f"exactly {repeats}, kf_t vs one reduction {rows[name]['max_kf_t_diff']:.2e}")
        chunk = []
        fixed = torch.zeros(K, dtype=torch.bool, device=dev)
        fixed[0] = True
        params = torch.from_numpy(LS.PARAMS.copy()).to(dev)
        s2 = torch.from_numpy(feat.sigma2(feat.OrbParams(n_levels=4))).to(dev)
        state = st.MapState(**{k: v.clone() for k, v in arrays.items()})
        for _ in range(4 * args.reps):
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            h0 = time.perf_counter()
            ev[0].record()
            gba.gba_step(CameraModel.PINHOLE, params, state, fixed, s2, 30.0, 2)
            ev[1].record()
            torch.cuda.synchronize()
            chunk.append((ev[0].elapsed_time(ev[1]), (time.perf_counter() - h0) * 1e3))
        a = run_once(arrays, info, K, dev, ba_mod.point_sum)[2]
        b = run_once(arrays, info, K, dev, ba_mod.point_sum)[2]
        repeats = all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("kf_R", "kf_t", "mp_pos"))
        rows["gba chunk"] = dict(device_ms=statistics.median(d for d, _ in chunk),
                                 host_ms=statistics.median(h for _, h in chunk), runs=len(chunk))
        rows["default forms repeat exactly"] = repeats
        print(f"GBA chunk (2 LM iterations), {K} keyframes: device "
              f"{rows['gba chunk']['device_ms']:.3f} ms, host {rows['gba chunk']['host_ms']:.3f} "
              f"ms (median of {len(chunk)}); two whole-map BAs with the default forms equal: "
              f"{repeats}")
        out[K] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"ba_point_sums": out, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
