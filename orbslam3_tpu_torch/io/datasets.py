"""Dataset loaders and writers: EuRoC, TUM-VI, TUM RGB-D, KITTI.

The loaders are host-only copies of the JAX package's (the `LoadImages` /
`LoadIMU` CSV parsers of the reference's example mains); they return
timestamps in seconds (float64) and lazy image paths, and read PNGs through
`io/png.py` with `cv2.imread`'s semantics. The writers are the port's
stand-ins for the `cv2.imwrite` calls that write each layout:
`write_euroc` the `mav0` layout of `scripts/make_synth_euroc.py` (with
`right`, the TUM-VI pair of its `--fisheye`), `write_kitti` the odometry
layout, `write_tum_rgbd` the RGB-D layout with 16-bit depth PNGs and an
associations file. `sequence_digest` names a sequence by its decoded pixels
and CSV text, so that two machines whose `zlib` compresses differently agree
on it.
"""

from __future__ import annotations

import csv
import hashlib
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import png


@dataclass
class ImageSequence:
    timestamps: np.ndarray  # (N,) seconds
    paths: List[str]
    paths_right: Optional[List[str]] = None  # stereo

    def __len__(self):
        return len(self.paths)

    def read(self, i: int) -> np.ndarray:
        """Grayscale float32 image."""
        return png.imread(self.paths[i], png.IMREAD_GRAYSCALE).astype(np.float32)

    def read_right(self, i: int) -> np.ndarray:
        return png.imread(self.paths_right[i], png.IMREAD_GRAYSCALE).astype(np.float32)

    def read_depth(self, i: int) -> np.ndarray:
        """Raw depth image (TUM RGB-D ships 16-bit PNGs), read unchanged as the
        reference's `rgbd_tum.cc:LoadImages` reads it."""
        return png.imread(self.paths_right[i], png.IMREAD_UNCHANGED).astype(np.float32)


@dataclass
class ImuData:
    timestamps: np.ndarray  # (M,) seconds
    gyro: np.ndarray  # (M,3) rad/s
    acc: np.ndarray  # (M,3) m/s^2


def _csv_rows(path: str):
    with open(path) as f:
        for row in csv.reader(f):
            if row and not row[0].startswith("#"):
                yield row


def load_euroc_images(
    seq_dir: str, timestamps_file: Optional[str] = None, cam: str = "cam0"
) -> ImageSequence:
    """EuRoC mav0 layout: `<seq>/mav0/cam0/data/<ns>.png` + data.csv. If
    `timestamps_file` (the reference's EuRoC_TimeStamps list) is given, it
    selects the frames."""
    base = os.path.join(seq_dir, "mav0", cam, "data")
    if timestamps_file:
        with open(timestamps_file) as f:
            ns = [line.strip() for line in f if line.strip()]
        ts = np.asarray([int(t) for t in ns], np.int64)
        paths = [os.path.join(base, f"{t}.png") for t in ns]
    else:
        ts_list, paths = [], []
        for row in _csv_rows(os.path.join(seq_dir, "mav0", cam, "data.csv")):
            ts_list.append(int(row[0]))
            paths.append(os.path.join(base, row[1].strip()))
        ts = np.asarray(ts_list, np.int64)
    return ImageSequence(timestamps=ts.astype(np.float64) * 1e-9, paths=paths)


def load_euroc_imu(seq_dir: str) -> ImuData:
    """`mav0/imu0/data.csv`: ns, wx, wy, wz, ax, ay, az."""
    path = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    arr = np.asarray([[float(v) for v in row[:7]] for row in _csv_rows(path)], np.float64)
    return ImuData(
        timestamps=arr[:, 0] * 1e-9,
        gyro=arr[:, 1:4].astype(np.float32),
        acc=arr[:, 4:7].astype(np.float32),
    )


def load_tum_rgbd(seq_dir: str, association_file: str) -> ImageSequence:
    """TUM RGB-D with an associations file `ts_rgb rgb ts_depth depth`."""
    ts, rgb, depth = [], [], []
    with open(association_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            ts.append(float(p[0]))
            rgb.append(os.path.join(seq_dir, p[1]))
            depth.append(os.path.join(seq_dir, p[3]))
    return ImageSequence(np.asarray(ts), rgb, paths_right=depth)


def load_kitti(seq_dir: str) -> ImageSequence:
    """KITTI odometry layout: image_0/, image_1/, times.txt."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png") for i in range(len(times))]
    right_dir = os.path.join(seq_dir, "image_1")
    right = (
        [os.path.join(right_dir, f"{i:06d}.png") for i in range(len(times))]
        if os.path.isdir(right_dir)
        else None
    )
    return ImageSequence(times.astype(np.float64), left, paths_right=right)


def load_tumvi_images(seq_dir: str, cam: str = "cam0") -> ImageSequence:
    """TUM-VI uses the same mav0 layout as EuRoC."""
    return load_euroc_images(seq_dir, cam=cam)


load_tumvi_imu = load_euroc_imu


def load_groundtruth_euroc(seq_dir: str):
    """`mav0/state_groundtruth_estimate0/data.csv`: ns, p(3), q(4), v(3),
    bw(3), ba(3). Returns (ts_s, positions (N,3), quaternions wxyz)."""
    path = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0", "data.csv")
    arr = np.asarray([[float(v) for v in row[:8]] for row in _csv_rows(path)], np.float64)
    return arr[:, 0] * 1e-9, arr[:, 1:4], arr[:, 4:8]


def write_euroc(out_dir: str, timestamps_ns, images, settings_yaml: str, *,
                right=None, imu=None, groundtruth=None) -> None:
    """Write a sequence in the mav0 layout of `scripts/make_synth_euroc.py`:
    `mav0/cam0/data/<ns>.png` and `data.csv` (and `cam1` for `right`),
    `mav0/imu0/data.csv` from `imu` = (t_ns (M,), gyro (M, 3), acc (M, 3)),
    `mav0/state_groundtruth_estimate0/data.csv` from `groundtruth` =
    (positions (N, 3), quaternions wxyz (N, 4)) per frame, and
    `settings.yaml`. Images are (N, H, W) uint8."""
    mav0 = os.path.join(out_dir, "mav0")
    cams = [("cam0", images)] + ([("cam1", right)] if right is not None else [])
    for cam, imgs in cams:
        os.makedirs(os.path.join(mav0, cam, "data"), exist_ok=True)
        with open(os.path.join(mav0, cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for ns, img in zip(timestamps_ns, imgs):
                png.imwrite(os.path.join(mav0, cam, "data", f"{int(ns)}.png"), np.asarray(img))
                f.write(f"{int(ns)},{int(ns)}.png\n")
    gt_dir = os.path.join(mav0, "state_groundtruth_estimate0")
    imu_dir = os.path.join(mav0, "imu0")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(imu_dir, exist_ok=True)
    if groundtruth is not None:
        with open(os.path.join(gt_dir, "data.csv"), "w") as f:
            f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
            for ns, p, q in zip(timestamps_ns, *groundtruth):
                f.write(f"{int(ns)},{p[0]:.6f},{p[1]:.6f},{p[2]:.6f},"
                        f"{q[0]:.7f},{q[1]:.7f},{q[2]:.7f},{q[3]:.7f}\n")
    if imu is not None:
        with open(os.path.join(imu_dir, "data.csv"), "w") as f:
            f.write(
                "#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
                "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
                "a_RS_S_z [m s^-2]\n"
            )
            for ns, g, a in zip(*imu):
                f.write(f"{int(ns)},{g[0]:.8f},{g[1]:.8f},{g[2]:.8f},"
                        f"{a[0]:.6f},{a[1]:.6f},{a[2]:.6f}\n")
    with open(os.path.join(out_dir, "settings.yaml"), "w") as f:
        f.write(settings_yaml)


def write_kitti(out_dir: str, timestamps, images, right=None) -> None:
    """The KITTI odometry layout that `load_kitti` reads: `image_0/%06d.png`
    (and `image_1/` for `right`), `times.txt` with one time in seconds a line
    (`%.6e`, as KITTI writes them). Images are (N, H, W) uint8."""
    for cam, imgs in [("image_0", images)] + ([("image_1", right)] if right is not None else []):
        os.makedirs(os.path.join(out_dir, cam), exist_ok=True)
        for k, img in enumerate(imgs):
            png.imwrite(os.path.join(out_dir, cam, f"{k:06d}.png"), np.asarray(img))
    with open(os.path.join(out_dir, "times.txt"), "w") as f:
        f.writelines(f"{float(t):.6e}\n" for t in timestamps)


DEPTH_MAP_FACTOR = 5000.0  # TUM RGB-D's depth PNG scale (rgbd_tum.cc's DepthMapFactor)


def write_tum_rgbd(out_dir: str, timestamps, images, depths) -> str:
    """The TUM RGB-D layout that `load_tum_rgbd` reads: `rgb/<t>.png` (8-bit),
    `depth/<t>.png` (16-bit, metres times `DEPTH_MAP_FACTOR` rounded, 0
    where the depth is not finite or not positive, at most 65535) and
    `associations.txt`, lines `t rgb/<t>.png t depth/<t>.png` with times in
    seconds to 6 decimals as the dataset names its files. Returns the
    associations file's path."""
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    lines = []
    for t, img, d in zip(timestamps, images, depths):
        name = f"{float(t):.6f}"
        png.imwrite(os.path.join(out_dir, "rgb", f"{name}.png"), np.asarray(img))
        d = np.asarray(d, np.float64) * DEPTH_MAP_FACTOR
        raw = np.where(np.isfinite(d) & (d > 0), np.minimum(np.round(d), 65535), 0)
        png.imwrite(os.path.join(out_dir, "depth", f"{name}.png"), raw.astype(np.uint16))
        lines.append(f"{name} rgb/{name}.png {name} depth/{name}.png\n")
    path = os.path.join(out_dir, "associations.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def sequence_digest(seq_dir: str) -> str:
    """sha256 over a sequence's text files and decoded images, in path order:
    each file's relative path, then its text, or a PNG's shape, type and
    pixels (never the compressed bytes)."""
    h = hashlib.sha256()
    paths = []
    for root, _, files in os.walk(seq_dir):
        paths += [os.path.join(root, f) for f in files]
    for path in sorted(paths, key=lambda p: os.path.relpath(p, seq_dir)):
        rel = os.path.relpath(path, seq_dir)
        h.update(rel.encode())
        if path.endswith(".png"):
            img = png.imread(path, png.IMREAD_UNCHANGED)
            h.update(f"{img.shape}{img.dtype}".encode())
            h.update(np.ascontiguousarray(img).tobytes())
        else:
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()
