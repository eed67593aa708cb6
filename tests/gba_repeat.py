"""Repeatability of the whole-map BA of
`tests/test_torch_cuda.py::test_global_ba_256_cameras_on_card_equals_cpu`
(256 keyframes, `tests/loop_scene.py::make_ba_map`, the same perturbation).

    python tests/gba_repeat.py [--cpu-only]

Runs `pipeline.gba.global_ba` twice on the first CUDA card and on the CPU
with 1 and with 8 threads, all in float32, and once more on the CPU in
float64 (the map, the camera and the octave variances cast up: the
reference solve). Prints whether the two card runs are equal bit for bit,
the largest difference of the poses and points between the card and each
CPU run and between the two CPU runs, and each float32 solve's largest
difference from the float64 one; then the card's name and power limit.
`--cpu-only` runs the CPU solves alone. Not a test: nothing collects it.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import loop_scene as LS  # noqa: E402

from orbslam3_tpu_torch.atlas import store as st  # noqa: E402
from orbslam3_tpu_torch.ops import features as feat  # noqa: E402
from orbslam3_tpu_torch.ops.cameras import CameraModel  # noqa: E402
from orbslam3_tpu_torch.pipeline import gba  # noqa: E402

K = 256
FIELDS = ("kf_R", "kf_t", "mp_pos")


def run(arrays, info, where: str, threads: int | None = None,
        dtype: torch.dtype = torch.float32) -> dict:
    """The whole-map BA of the test's map on `where`, its float arrays, the
    camera and the octave variances in `dtype`."""
    if threads is not None:
        torch.set_num_threads(threads)

    def up(v):
        x = torch.from_numpy(np.array(v)).to(where)
        return x.to(dtype) if x.is_floating_point() else x

    store = st.MapStore(Kmax=K, Pmax=2048, Nf=256, device=where)
    store.state = st.MapState(**{k: up(v) for k, v in arrays.items()})
    store.n_kf, store.n_mp, store.kf_ts = K, info["n_mp"], info["kf_ts"]
    gba.global_ba(store, CameraModel.PINHOLE, up(LS.PARAMS.copy()),
                  up(feat.sigma2(feat.OrbParams(n_levels=4))), bf=30.0)
    return {k: getattr(store.state, k).cpu().double() for k in FIELDS}


def diff(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).abs().max()) for k in FIELDS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args(argv)
    if not args.cpu_only and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    arrays, info = LS.make_ba_map(K=K, Kmax=K, Pmax=2048, stereo=tuple(range(1, K, 8)))
    rng = np.random.default_rng(2)
    arrays["kf_t"][1:K] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    arrays["mp_pos"][1:info["n_mp"]] += rng.normal(0, 0.05, (info["n_mp"] - 1, 3)).astype(
        np.float32)
    cpu1, cpu8 = run(arrays, info, "cpu", 1), run(arrays, info, "cpu", 8)
    f64 = run(arrays, info, "cpu", 8, torch.float64)
    print(f"GBA {K} keyframes: CPU 1 thread vs 8 threads {diff(cpu1, cpu8)}")
    print(f"GBA {K} keyframes: float64 vs CPU 1 thread {diff(cpu1, f64)}, "
          f"vs CPU 8 threads {diff(cpu8, f64)}")
    if args.cpu_only:
        return 0
    a, b = run(arrays, info, "cuda"), run(arrays, info, "cuda")
    same = all(torch.equal(a[k], b[k]) for k in FIELDS)
    print(f"GBA {K} keyframes: two card runs equal bit for bit: {same}; card vs CPU 1 thread "
          f"{diff(a, cpu1)}, card vs CPU 8 threads {diff(a, cpu8)}, card vs float64 "
          f"{diff(a, f64)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
