"""The dataset runner of the port — `scripts/run_sequence.py` (ORB-SLAM3's
Examples mains, `mono_euroc.cc`, `rgbd_tum.cc`, ...) on the port's `System`:
replay a dataset directory in any sensor mode, write the trajectory (TUM,
KITTI or EuRoC format) and report the ATE when there is ground truth.

    python -m orbslam3_tpu_torch.run_sequence SETTINGS.yaml SEQ_DIR \\
        --dataset euroc|tumvi|kitti|tumrgbd \\
        --mode mono|mono-vi|stereo|stereo-vi|rgbd \\
        [--assoc FILE] [--timestamps FILE] [--max-frames N] [--no-loop]
        [--vocab voc.npz|voc.bin] [--train-vocab] [--out traj.txt]
        [--traj-format tum|kitti|euroc] [--kmax 512] [--pmax 65536]
        [--sync-mapping] [--timing] [--viewer PORT] [--device cuda|cpu]

The flags and defaults are the JAX runner's: mapping runs asynchronously
(one stage per frame) unless `--sync-mapping`; place recognition and the
Atlas are on unless `--no-loop`, with the vocabulary from `--vocab`, else the
shipped `assets/ORBvoc_synth_100k.bin`, else one trained on the sequence
(`--train-vocab`). The map holds 512 keyframes and 65536 points, past
`auto_dense_schur`'s budget, so a global BA takes the matrix-free PCG path.
It runs on the first CUDA card; `--device cpu` is the only way to the CPU.

Besides the JAX runner's lines it prints the path and the chunks of each
global BA, the frame-time percentiles and, on CUDA, the host syncs per frame
kind (counted by PyTorch's sync debug mode), and ends with a `summary {...}` JSON line (the ATE, the
loops and their frames, the GBA's outcome and chunk ms, every frame's ms, kind and
syncs, the mapping stages' spans). `main(argv)` returns that summary with the
per-frame states, every span and the `System`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.run_sequence")
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--dataset", choices=["euroc", "tumvi", "kitti", "tumrgbd"], default="euroc")
    ap.add_argument("--mode", choices=["mono", "mono-vi", "stereo", "stereo-vi", "rgbd"],
                    default="mono")
    ap.add_argument("--assoc", default=None, help="TUM RGB-D associations file")
    ap.add_argument("--timestamps", default=None, help="EuRoC timestamp list")
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--kf-out", default="kf_trajectory.txt")
    ap.add_argument("--traj-format", choices=["tum", "kitti", "euroc"], default="tum")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kmax", type=int, default=512)
    ap.add_argument("--pmax", type=int, default=65536)
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--sync-mapping", action="store_true",
                    help="run each keyframe's mapping pass inside the inserting frame "
                         "(default: sliced one stage per frame, ORB-SLAM3's LocalMapping "
                         "thread overlap)")
    ap.add_argument("--vocab", default=None,
                    help=".bin (reference binary) or .npz vocabulary; default: the shipped "
                         "assets/ORBvoc_synth_100k.bin")
    ap.add_argument("--train-vocab", action="store_true",
                    help="ignore the shipped vocabulary and train one on the sequence")
    ap.add_argument("--timing", action="store_true",
                    help="print the span report at the end: spans, then counters")
    ap.add_argument("--viewer", type=int, default=None, metavar="PORT",
                    help="serve the live viewer on this port (0 = a free one)")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA card (cpu only when asked)")
    return ap


def _load_sequence(args, datasets):
    if args.dataset in ("euroc", "tumvi"):
        seq = datasets.load_euroc_images(args.seq_dir, args.timestamps)
        if args.mode in ("stereo", "stereo-vi"):
            seq.paths_right = datasets.load_euroc_images(args.seq_dir, args.timestamps,
                                                         cam="cam1").paths
    elif args.dataset == "kitti":
        seq = datasets.load_kitti(args.seq_dir)
    else:
        if not args.assoc:
            raise SystemExit("--assoc is required for tumrgbd")
        seq = datasets.load_tum_rgbd(args.seq_dir, args.assoc)
    return seq


def _vocabulary(args, seq, n, settings, device):
    """The vocabulary as the JAX runner resolves it."""
    from orbslam3_tpu_torch.ops import bow
    from orbslam3_tpu_torch.ops import features as feat

    default_bin = REPO / "assets" / "ORBvoc_synth_100k.bin"
    if not default_bin.exists():
        default_bin = REPO / "assets" / "ORBvoc_synth.bin"
    path = args.vocab
    if path is None and not args.train_vocab and default_bin.exists():
        path = str(default_bin)
    if path and os.path.exists(path):
        if path.endswith(".bin"):
            from orbslam3_tpu_torch.io import vocab_io

            voc = vocab_io.load_binary_vocabulary(path, device)
            print(f"vocabulary: {voc.n_words} words (binary artifact {os.path.basename(path)})")
        else:
            voc = bow.load_npz(path, device)
            print(f"vocabulary: {voc.n_words} words (cached)")
        return voc
    stride = max(1, n // 40)
    train = []
    for k in range(0, n, stride):
        f = feat.extract(torch.from_numpy(seq.read(k)).to(device), settings.orb)
        train.append(f.desc[f.valid].cpu().numpy())
    voc = bow.build_vocabulary(np.concatenate(train), k=10, depth=4, seed=0, device=device)
    print(f"vocabulary: trained {voc.n_words} words")
    if args.vocab:
        bow.save_npz(args.vocab, voc)
    return voc


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    from orbslam3_tpu_torch import config as cfg
    from orbslam3_tpu_torch import spans
    from orbslam3_tpu_torch.ate import ate_rmse, ate_scale
    from orbslam3_tpu_torch.device import require_cuda
    from orbslam3_tpu_torch.io import datasets
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.optim import ba as ba_mod
    from orbslam3_tpu_torch.system import Sensor, System

    device = require_cuda() if args.device is None else torch.device(args.device)
    cuda = device.type == "cuda"
    settings = cfg.load_settings(args.settings)
    seq = _load_sequence(args, datasets)
    n = len(seq) if not args.max_frames else min(len(seq), args.max_frames)
    print(f"{args.dataset}/{args.mode}: {n} frames, camera model {int(settings.camera.model)}")

    inertial = args.mode in ("mono-vi", "stereo-vi")
    imu_calib = imu = None
    if inertial:
        if settings.imu is None:
            raise SystemExit("the settings lack an IMU section")
        ic = settings.imu
        imu_calib = imu_ops.ImuCalib.create(
            Rbc=ic.Tbc[:3, :3], tbc=ic.Tbc[:3, 3], noise_gyro=ic.noise_gyro,
            noise_acc=ic.noise_acc, walk_gyro=ic.walk_gyro, walk_acc=ic.walk_acc, freq=ic.freq,
            device=device)
        imu = datasets.load_euroc_imu(args.seq_dir)
    sensor = {"mono": Sensor.MONOCULAR, "mono-vi": Sensor.IMU_MONOCULAR, "stereo": Sensor.STEREO,
              "stereo-vi": Sensor.IMU_STEREO, "rgbd": Sensor.RGBD}[args.mode]
    camera2 = None
    if args.mode in ("stereo", "stereo-vi") and settings.camera.params2 is not None:
        camera2 = (settings.camera.params2, settings.camera.T_c1_c2, settings.camera.lapping1,
                   settings.camera.lapping2)
    slam = System(sensor, settings.camera.model, settings.camera.params,
                  (settings.camera.width, settings.camera.height), orb_params=settings.orb,
                  device=device, bf=settings.camera.bf, camera2=camera2, Kmax=args.kmax,
                  Pmax=args.pmax, fps=settings.camera.fps, imu_calib=imu_calib)
    if args.mode in ("stereo", "stereo-vi") and settings.rect_left is not None:
        slam.enable_rectification(settings.rect_left, settings.rect_right)
        print("stereo rectification: LEFT./RIGHT. remap maps active")
    if not args.sync_mapping:
        slam.enable_async_mapping()
    if not args.no_loop:
        voc = _vocabulary(args, seq, n, settings, device)
        slam.enable_place_recognition(voc)
        slam.enable_multimap(voc)

    gt = None
    gt_path = os.path.join(args.seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    if args.dataset in ("euroc", "tumvi") and os.path.exists(gt_path):
        gt = datasets.load_groundtruth_euroc(args.seq_dir)
    with_scale = args.mode in ("mono", "mono-vi")
    recorder = spans.Recorder(cuda)  # its `frame` is the frame being tracked
    loops = []
    if gt is not None and slam.loop_closer is not None:
        def _loop_ate(phase, kf_id, loop_kf):
            ts_e, pos_e = slam.get_trajectory()
            e = ate_rmse(ts_e, pos_e, gt[0], gt[1], with_scale=with_scale)
            if phase == "before":
                loops.append(dict(frame=recorder.frame, kf=int(kf_id), loop_kf=int(loop_kf),
                                  ate_before=e))
            else:
                loops[-1]["ate_after"] = e
            print(f"loop closure kf{kf_id}->kf{loop_kf}: ATE {phase} correction = {e:.4f} m",
                  flush=True)

        slam.loop_closer.on_correction = _loop_ate
    if args.viewer is not None:
        v = slam.enable_viewer(port=args.viewer)
        print(f"live viewer: http://127.0.0.1:{v.port}/")

    gba = slam.loop_closer.gba_async if slam.loop_closer is not None else None
    dense = ba_mod.auto_dense_schur(args.kmax, args.pmax)
    am = slam.async_mapper
    frame_ms, states, kinds, syncs = [], [], [], []
    cursor = 0

    def _track(k):
        nonlocal cursor
        recorder.frame = k
        ts = float(seq.timestamps[k])
        batch = None
        if inertial:
            hi = int(np.searchsorted(imu.timestamps, ts, side="right"))
            batch = [(imu.timestamps[j], imu.acc[j], imu.gyro[j]) for j in range(cursor, hi)]
            cursor = hi
        busy = am is not None and not am.idle()
        chunks = gba.n_chunks if gba is not None else 0
        caught.clear()
        tf = time.perf_counter()
        if args.mode in ("mono", "mono-vi"):
            frame = slam.track_monocular(seq.read(k), ts, imu_measurements=batch or None)
        elif args.mode in ("stereo", "stereo-vi"):
            frame = slam.track_stereo(seq.read(k), seq.read_right(k), ts,
                                      imu_measurements=batch or None)
        else:
            depth = seq.read_depth(k) / settings.camera.depth_map_factor
            frame = slam.track_rgbd(seq.read(k), depth, ts)
        frame_ms.append((time.perf_counter() - tf) * 1e3)
        states.append(slam.tracking_state.name)
        if states[-1] != "OK":
            kind = "not OK"
        elif slam.tracker.last_kf_frame_id == frame.frame_id:  # a freed slot keeps n_kf
            kind = "keyframe"
        elif busy:
            kind = "mapping stage"
        elif gba is not None and gba.n_chunks != chunks:
            kind = "GBA chunk"
        else:
            kind = "tracked"
        kinds.append(kind)
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
        if k % 50 == 0 or k == n - 1:
            print(f"[{k}/{n}] state={slam.tracking_state.name} kfs={slam.n_keyframes} "
                  f"mps={slam.n_map_points}", flush=True)

    t0 = time.perf_counter()
    with recorder, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:  # each host sync warns: counted per frame
            torch.cuda.set_sync_debug_mode("warn")
        try:
            for k in range(n):
                _track(k)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
        slam.shutdown()  # drains the mapper and a background GBA
    wall = time.perf_counter() - t0
    calls = recorder.result()
    print(f"done: {n} frames in {wall:.1f}s ({n / wall:.1f} fps incl. mapping)")
    if slam.loop_closer is not None:
        print(f"loops_closed={slam.loop_closer.n_loops_closed} "
              f"merges={slam.multimap.n_merges if slam.multimap else 0}")
    if inertial:
        ini = slam.mapper.imu_init
        print(f"imu stages: init={slam.mapper.imu_initialized} "
              f"viba1={getattr(ini, 'viba1_done', False)} viba2={getattr(ini, 'viba2_done', False)}")
    chunk_ms = [(h, d) for _, h, d in calls.get("gba/chunk", [])]
    if gba is not None:
        dev_ms = [d for _, d in chunk_ms if d is not None]
        print(f"global BA: {'dense Schur' if dense else 'PCG'} path (auto_dense_schur({args.kmax}, "
              f"{args.pmax}) = {dense}), {gba.n_finished} finished, {gba.n_aborted} aborted, "
              f"{len(chunk_ms)} chunks" + (
                  f", chunk ms median {statistics.median(dev_ms):.2f} max {max(dev_ms):.2f} "
                  f"(device)" if dev_ms else ""))
    tracked = [m for m, s in zip(frame_ms, states) if s == "OK"]
    print(f"frame ms: median {_pct(frame_ms, 50):.2f} p95 {_pct(frame_ms, 95):.2f} max "
          f"{max(frame_ms):.2f} over {n} frames ({len(tracked)} OK); mapping "
          f"{'synchronous' if am is None else 'asynchronous'}")
    by_kind = {}
    for kd, sy, ms in zip(kinds, syncs, frame_ms):
        by_kind.setdefault(kd, []).append((sy, ms))
    if cuda:
        print("syncs per frame kind: " + "; ".join(
            f"{kd} {len(v)} frames, median {statistics.median([s for s, _ in v])} (max "
            f"{max(s for s, _ in v)})" for kd, v in sorted(by_kind.items())))
    if args.timing:
        spans.print_report(calls)

    ts_est, pos_est = slam.get_trajectory()
    if args.traj_format == "kitti":
        slam.save_trajectory_kitti(args.out)
    elif args.traj_format == "euroc":
        slam.save_trajectory_euroc(args.out)
    else:
        slam.save_trajectory_tum(args.out)
    if args.traj_format == "euroc":
        slam.save_keyframe_trajectory_euroc(args.kf_out)
    else:
        slam.save_keyframe_trajectory_tum(args.kf_out)
    print(f"trajectories -> {args.out}, {args.kf_out}")
    ate = scale = None
    if gt is not None:
        ate = ate_rmse(ts_est, pos_est, gt[0], gt[1], with_scale=with_scale)
        print(f"ATE RMSE: {ate:.4f} m")
        if args.mode in ("stereo", "stereo-vi", "rgbd"):
            scale = ate_scale(ts_est, pos_est, gt[0], gt[1])
            print(f"scale vs GT: {scale:.4f}")
    first_ok = next((k for k, st in enumerate(states) if st == "OK"), None)
    summary = dict(
        n=n, mapping="synchronous" if am is None else "asynchronous", ate=ate, scale=scale,
        first_ok=first_ok,
        not_ok_after_init=[k for k, st in enumerate(states)
                           if first_ok is not None and k > first_ok and st != "OK"],
        loops=loops, n_loops=slam.loop_closer.n_loops_closed if slam.loop_closer else 0,
        merges=slam.multimap.n_merges if slam.multimap else 0, n_kf=slam.n_keyframes,
        gba_path="dense" if dense else "pcg",
        gba_finished=gba.n_finished if gba is not None else 0,
        gba_aborted=gba.n_aborted if gba is not None else 0, gba_chunk_ms=chunk_ms,
        mapper_idle=am is None or am.idle(), wall_s=wall, frame_ms=frame_ms, kinds=kinds,
        syncs=syncs if cuda else None,
        spans={k: [(f, h, d) for f, h, d in v] for k, v in calls.items()
               if k.startswith(("mapping/", "gba/"))})
    print("summary " + json.dumps(summary))
    return dict(summary, states=states, spans=calls, system=slam)


if __name__ == "__main__":
    main()
