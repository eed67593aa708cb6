"""Typed settings from ORB-SLAM3's settings files — the port of
`orbslam3_tpu/config.py` (`CameraConfig`, `RectifyConfig`, `ImuConfig`,
`Settings`, `load_settings`), field for field.

ORB-SLAM3 reads its per-dataset YAML through cv::FileStorage
(`Tracking.cc:57-343`: `Camera.*`, `Camera2.*` and `Tlr` for a two-camera
rig, `ThDepth`, `DepthMapFactor`, `ORBextractor.*`, `Tbc`, `IMU.*`, the
`LEFT.`/`RIGHT.` rectification blocks). The card's machine has no YAML
library, so this module reads the subset of cv::FileStorage YAML those files
use itself:

- the `%YAML:1.0` header, blank lines and `#` comments;
- `Key: value` and `Key:value` at the start of a line, the value a number,
  a quoted string, a bare word, or a `[...]` list of numbers over one or more
  lines;
- `Key: !!opencv-matrix` blocks whose indented lines give `rows`, `cols`,
  `dt` and `data: [...]` (the list may span lines).

Anything else raises `ValueError`, naming the file and the line.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat


@dataclass
class CameraConfig:
    model: cam.CameraModel
    params: np.ndarray  # length-8 vector (see ops/cameras.py)
    width: int
    height: int
    fps: float = 30.0
    bf: float = 0.0  # baseline * fx (stereo / RGB-D)
    th_depth: float = 35.0  # close/far stereo point threshold (ThDepth)
    rgb: bool = True
    # second camera (two-camera rig)
    params2: Optional[np.ndarray] = None
    T_c1_c2: Optional[np.ndarray] = None  # 4x4 (Tlr)
    lapping1: Optional[tuple] = None  # (lappingBegin, lappingEnd) cam 1
    lapping2: Optional[tuple] = None
    depth_map_factor: float = 1.0


@dataclass
class RectifyConfig:
    """One side of the stereo-rectification block (`LEFT./RIGHT. K/D/R/P`
    and height/width, `Tracking.cc:299-323`)."""

    K: np.ndarray  # (3,3) original intrinsics
    D: np.ndarray  # (4-5,) radtan distortion
    R: np.ndarray  # (3,3) rectifying rotation
    P: np.ndarray  # (3,4) rectified projection
    width: int
    height: int


@dataclass
class ImuConfig:
    Tbc: np.ndarray  # 4x4 body<-camera
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    freq: float


@dataclass
class Settings:
    camera: CameraConfig
    orb: feat.OrbParams
    imu: Optional[ImuConfig] = None
    # Raw-stereo rectification (LEFT./RIGHT. blocks); None = pre-rectified.
    rect_left: Optional[RectifyConfig] = None
    rect_right: Optional[RectifyConfig] = None


_KEY = re.compile(r"^([A-Za-z0-9_.]+)\s*:\s*(.*)$")
_NUMBER = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")
_WORD = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-]*$")


def _strip_comment(text: str) -> str:
    """The line without a `#` comment outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return text[:i]
    return text


def _scalar(text: str, where: str):
    if _NUMBER.match(text):
        return int(text) if re.match(r"^[-+]?\d+$", text) else float(text)
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    if _WORD.match(text) and text.lower() not in ("true", "false", "yes", "no", "null", "on",
                                                  "off"):
        return text
    raise ValueError(f"{where}: unsupported value {text!r}")


def _read_list(first: str, lines, i: int, where) -> tuple[list, int]:
    """The numbers of a `[...]` list that starts with `first` (after the
    bracket) and may go on over the next lines; returns (numbers, next i)."""
    body = first
    while "]" not in body:
        if i >= len(lines):
            raise ValueError(f"{where(i)}: a list without its closing ']'")
        body += " " + _strip_comment(lines[i]).strip()
        i += 1
    inner, rest = body.split("]", 1)
    if rest.strip():
        raise ValueError(f"{where(i - 1)}: text after a list's ']': {rest.strip()!r}")
    items = [x.strip() for x in inner.split(",") if x.strip()]
    vals = []
    for x in items:
        v = _scalar(x, where(i - 1))
        if isinstance(v, str):
            raise ValueError(f"{where(i - 1)}: a list holds numbers only, not {x!r}")
        vals.append(v)
    return vals, i


def read_opencv_yaml(path: str) -> dict:
    """The key-value pairs of a cv::FileStorage YAML file (the subset in the
    module docstring); an `!!opencv-matrix` is a dict of rows, cols, dt and
    data."""
    with open(path) as f:
        lines = f.read().splitlines()
    out: dict = {}
    i = 0

    def where(k):
        return f"{path}:{k + 1}"

    while i < len(lines):
        raw = lines[i]
        line = _strip_comment(raw).rstrip()
        i += 1
        if not line.strip() or (i == 1 and re.match(r"^%YAML[:\s]\s*[\d.]+$", line.strip())):
            continue
        if line.strip() == "---" or line.strip() == "...":
            continue
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{where(i - 1)}: not a 'Key: value' line: {raw!r}")
        key, value = m.group(1), m.group(2).strip()
        if key in out:
            raise ValueError(f"{where(i - 1)}: key {key!r} given twice")
        if value == "!!opencv-matrix":
            node: dict = {}
            while i < len(lines) and (not lines[i].strip() or lines[i][:1] in " \t"):
                sub = _strip_comment(lines[i]).strip()
                i += 1
                if not sub:
                    continue
                sm = _KEY.match(sub)
                if sm is None or sm.group(1) not in ("rows", "cols", "dt", "data"):
                    raise ValueError(f"{where(i - 1)}: unexpected line in {key}'s matrix: "
                                     f"{lines[i - 1]!r}")
                name, val = sm.group(1), sm.group(2).strip()
                if name == "data":
                    if not val.startswith("["):
                        raise ValueError(f"{where(i - 1)}: a matrix's data must be a [...] list")
                    node["data"], i = _read_list(val[1:], lines, i, where)
                else:
                    node[name] = _scalar(val, where(i - 1))
            if set(node) != {"rows", "cols", "dt", "data"}:
                raise ValueError(f"{path}: matrix {key} lacks {sorted({'rows', 'cols', 'dt', 'data'} - set(node))}")
            if len(node["data"]) != int(node["rows"]) * int(node["cols"]):
                raise ValueError(f"{path}: matrix {key} holds {len(node['data'])} values, not "
                                 f"{node['rows']} x {node['cols']}")
            out[key] = node
        elif value.startswith("["):
            out[key], i = _read_list(value[1:], lines, i, where)
        elif value == "":
            raise ValueError(f"{where(i - 1)}: key {key!r} without a value")
        else:
            out[key] = _scalar(value, where(i - 1))
    return out


def _get_matrix(node) -> np.ndarray:
    if isinstance(node, dict) and "data" in node:
        return np.asarray(node["data"], np.float64).reshape(int(node["rows"]), int(node["cols"]))
    return np.asarray(node, np.float64)


def load_settings(path: str) -> Settings:
    """Parse an ORB-SLAM3 settings file (EuRoC.yaml, TUM_512.yaml, ...)."""
    d = read_opencv_yaml(path)

    cam_type = d.get("Camera.type", "PinHole")
    fx, fy = float(d["Camera.fx"]), float(d["Camera.fy"])
    cx, cy = float(d["Camera.cx"]), float(d["Camera.cy"])
    if cam_type in ("PinHole", "Rectified"):
        model = cam.CameraModel.PINHOLE
        params = np.asarray(
            [fx, fy, cx, cy,
             float(d.get("Camera.k1", 0.0)), float(d.get("Camera.k2", 0.0)),
             float(d.get("Camera.p1", 0.0)), float(d.get("Camera.p2", 0.0))],
            np.float32,
        )
    elif cam_type == "KannalaBrandt8":
        model = cam.CameraModel.KB8
        params = np.asarray(
            [fx, fy, cx, cy,
             float(d["Camera.k1"]), float(d["Camera.k2"]),
             float(d["Camera.k3"]), float(d["Camera.k4"])],
            np.float32,
        )
    else:
        raise ValueError(f"unknown Camera.type {cam_type}")

    params2 = None
    T12 = None
    if "Camera2.fx" in d:
        params2 = np.asarray(
            [float(d["Camera2.fx"]), float(d["Camera2.fy"]),
             float(d["Camera2.cx"]), float(d["Camera2.cy"]),
             float(d.get("Camera2.k1", 0.0)), float(d.get("Camera2.k2", 0.0)),
             float(d.get("Camera2.k3", 0.0)), float(d.get("Camera2.k4", 0.0))],
            np.float32,
        )
        if "Tlr" in d:
            T12 = _get_matrix(d["Tlr"])

    def _lap(prefix):
        if f"{prefix}.lappingBegin" in d:
            return (float(d[f"{prefix}.lappingBegin"]), float(d[f"{prefix}.lappingEnd"]))
        return None

    camera = CameraConfig(
        model=model,
        params=params,
        width=int(d.get("Camera.width", 752)),
        height=int(d.get("Camera.height", 480)),
        fps=float(d.get("Camera.fps", 30.0)),
        bf=float(d.get("Camera.bf", 0.0)),
        th_depth=float(d.get("ThDepth", 35.0)),
        rgb=bool(int(d.get("Camera.RGB", 1))),
        params2=params2,
        T_c1_c2=T12,
        lapping1=_lap("Camera"),
        lapping2=_lap("Camera2"),
        depth_map_factor=float(d.get("DepthMapFactor", 1.0)),
    )
    orb = feat.OrbParams(
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        ini_th=float(d.get("ORBextractor.iniThFAST", 20)),
        min_th=float(d.get("ORBextractor.minThFAST", 7)),
    )

    def _rect(prefix):
        if f"{prefix}.K" not in d:
            return None
        return RectifyConfig(
            K=_get_matrix(d[f"{prefix}.K"]),
            D=_get_matrix(d[f"{prefix}.D"]).reshape(-1),
            R=_get_matrix(d[f"{prefix}.R"]),
            P=_get_matrix(d[f"{prefix}.P"]),
            width=int(d.get(f"{prefix}.width", camera.width)),
            height=int(d.get(f"{prefix}.height", camera.height)),
        )

    imu = None
    if "IMU.NoiseGyro" in d:
        imu = ImuConfig(
            Tbc=_get_matrix(d["Tbc"]) if "Tbc" in d else np.eye(4),
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d["IMU.NoiseAcc"]),
            walk_gyro=float(d["IMU.GyroWalk"]),
            walk_acc=float(d["IMU.AccWalk"]),
            freq=float(d.get("IMU.Frequency", 200.0)),
        )
    return Settings(camera=camera, orb=orb, imu=imu, rect_left=_rect("LEFT"),
                    rect_right=_rect("RIGHT"))
