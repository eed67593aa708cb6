"""Live-ingest SLAM server of the port — `scripts/serve_stream.py` (ORB-SLAM3's
ROS nodes, `ros_mono.cc`, `ros_mono_inertial.cc`) on the port's `System`: a
producer streams frames (and IMU samples) over a UNIX socket; the server owns
the System, on the card, and answers each frame with its pose (the protocol of
`io/stream.py`).

Server:  python -m orbslam3_tpu_torch.serve_stream SETTINGS.yaml --socket PATH \\
         [--mode mono|mono-vi] [--vocab voc.npz|voc.bin] [--kmax 256] \\
         [--pmax 16384] [--out traj.txt] [--viewer PORT] [--device cuda|cpu]
Client:  python -m orbslam3_tpu_torch.serve_stream SETTINGS.yaml --socket PATH \\
         --client SEQ_DIR [--mode mono|mono-vi] [--max-frames N]
         (replays a EuRoC-layout directory through the socket with the port's
         loaders and prints the poses it receives)

The server maps asynchronously, as the JAX script's; it runs on the first
CUDA card and on the CPU only with `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import socket

import numpy as np
import torch


def build_system(args):
    """The server's `System` for `args` (settings, mode, map size, device,
    vocabulary, viewer), with asynchronous mapping on."""
    from orbslam3_tpu_torch import config as cfg
    from orbslam3_tpu_torch.device import require_cuda
    from orbslam3_tpu_torch.ops import imu as imu_ops
    from orbslam3_tpu_torch.system import Sensor, System

    device = require_cuda() if args.device is None else torch.device(args.device)
    settings = cfg.load_settings(args.settings)
    imu_calib = None
    sensor = Sensor.MONOCULAR
    if args.mode == "mono-vi":
        sensor = Sensor.IMU_MONOCULAR
        ic = settings.imu
        imu_calib = imu_ops.ImuCalib.create(
            Rbc=ic.Tbc[:3, :3], tbc=ic.Tbc[:3, 3], noise_gyro=ic.noise_gyro,
            noise_acc=ic.noise_acc, walk_gyro=ic.walk_gyro, walk_acc=ic.walk_acc, freq=ic.freq,
            device=device)
    slam = System(sensor, settings.camera.model, settings.camera.params,
                  (settings.camera.width, settings.camera.height), orb_params=settings.orb,
                  device=device, imu_calib=imu_calib, Kmax=args.kmax, Pmax=args.pmax,
                  fps=settings.camera.fps)
    slam.enable_async_mapping()
    if args.vocab and os.path.exists(args.vocab):
        from orbslam3_tpu_torch.ops import bow

        if args.vocab.endswith(".bin"):
            from orbslam3_tpu_torch.io import vocab_io

            voc = vocab_io.load_binary_vocabulary(args.vocab, device)
        else:
            voc = bow.load_npz(args.vocab, device)
        slam.enable_place_recognition(voc)
    if args.viewer is not None:
        v = slam.enable_viewer(port=args.viewer)
        print(f"live viewer: http://127.0.0.1:{v.port}/", flush=True)
    return slam


def run_server(args):
    from orbslam3_tpu_torch.io import stream

    slam = build_system(args)
    try:
        os.unlink(args.socket)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(args.socket)
    srv.listen(1)
    print(f"listening on {args.socket}", flush=True)
    conn, _ = srv.accept()
    n = stream.serve(slam, conn)
    slam.shutdown()
    print(f"served {n} frames; kfs={slam.n_keyframes} mps={slam.n_map_points}", flush=True)
    if args.out:
        slam.save_trajectory_tum(args.out)
    conn.close()
    srv.close()
    return slam


def replay(sock, seq_dir: str, mode: str = "mono", max_frames: int = 0, log_every: int = 20):
    """The client: each frame's IMU samples, then the frame, through `sock`;
    returns the (t, state, Rwc, twc) of every POSE received."""
    from orbslam3_tpu_torch.io import datasets, stream

    seq = datasets.load_euroc_images(seq_dir)
    imu = datasets.load_euroc_imu(seq_dir) if mode == "mono-vi" else None
    total = len(seq.timestamps) if not max_frames else min(len(seq.timestamps), max_frames)
    cursor = 0
    poses = []
    for k in range(total):
        ts = float(seq.timestamps[k])
        if imu is not None:
            hi = int(np.searchsorted(imu.timestamps, ts, side="right"))
            for j in range(cursor, hi):
                stream.send_imu(sock, float(imu.timestamps[j]), imu.acc[j], imu.gyro[j])
            cursor = hi
        stream.send_frame(sock, ts, seq.read(k).astype(np.uint8))
        msg = stream.recv_message(sock)
        if not msg or msg[0] != stream.MSG_POSE:
            raise RuntimeError(f"frame {k}: no POSE came back")
        poses.append(stream.parse_pose(msg[1]))
        if log_every and (k + 1) % log_every == 0:
            print(f"[{k + 1}] state={poses[-1][1]} twc={np.round(poses[-1][3], 3)}", flush=True)
    stream.send_bye(sock)
    return poses


def run_client(args):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    poses = replay(sock, args.client, args.mode, args.max_frames)
    sock.close()
    print(f"streamed {len(poses)} frames", flush=True)
    return poses


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m orbslam3_tpu_torch.serve_stream")
    ap.add_argument("settings")
    ap.add_argument("--socket", default="orbslam3_tpu_torch.sock")
    ap.add_argument("--mode", choices=["mono", "mono-vi"], default="mono")
    ap.add_argument("--vocab", default=None)
    ap.add_argument("--client", default=None, help="SEQ_DIR: act as the producer")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--kmax", type=int, default=256)
    ap.add_argument("--pmax", type=int, default=16384)
    ap.add_argument("--out", default=None)
    ap.add_argument("--viewer", type=int, default=None, metavar="PORT")
    ap.add_argument("--device", default=None,
                    help="torch device; default the first CUDA card (cpu only when asked)")
    args = ap.parse_args(argv)
    return run_client(args) if args.client else run_server(args)


if __name__ == "__main__":
    main()
