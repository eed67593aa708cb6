"""Live sensor ingest over a socket — the port of `orbslam3_tpu/io/stream.py`,
the same wire format byte for byte (ORB-SLAM3's ROS nodes, e.g.
`Examples/ROS/ORB_SLAM3/src/ros_mono_inertial.cc`, re-expressed as a
length-prefixed stream): a producer (a camera driver, a dataset replayer such
as `python -m orbslam3_tpu_torch.serve_stream --client`) pushes FRAME and IMU
messages; `serve` owns the `System` and answers every frame with a POSE
(timestamp, tracking state, Twc).

Wire format (little-endian):
  [u32 total_len][u8 msg_type][payload]
  IMU   (type 1): f64 t, 3*f32 acc, 3*f32 gyro
  FRAME (type 2): f64 t, u16 h, u16 w, u8 img[h*w]  (grayscale)
  POSE  (type 3): f64 t, u8 state, 12*f32 Twc rows (R|t)
  STEREO(type 4): f64 t, u16 h, u16 w, u8 left[h*w], u8 right[h*w]
  BYE   (type 9): empty — clean shutdown

The state byte is `TrackState.value`, whose values are the JAX package's.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional, Tuple

import numpy as np

MSG_IMU = 1
MSG_FRAME = 2
MSG_POSE = 3
MSG_STEREO = 4
MSG_BYE = 9

_HDR = struct.Struct("<IB")


def _send(sock: socket.socket, msg_type: int, payload: bytes):
    sock.sendall(_HDR.pack(len(payload), msg_type) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def send_imu(sock, t: float, acc, gyro):
    _send(sock, MSG_IMU, struct.pack("<d6f", t, *np.asarray(acc, np.float32),
                                     *np.asarray(gyro, np.float32)))


def send_frame(sock, t: float, img: np.ndarray):
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    _send(sock, MSG_FRAME, struct.pack("<dHH", t, h, w) + img.tobytes())


def send_stereo(sock, t: float, left: np.ndarray, right: np.ndarray):
    left = np.ascontiguousarray(left, np.uint8)
    right = np.ascontiguousarray(right, np.uint8)
    h, w = left.shape
    _send(sock, MSG_STEREO,
          struct.pack("<dHH", t, h, w) + left.tobytes() + right.tobytes())


def send_pose(sock, t: float, state: int, Rwc: np.ndarray, twc: np.ndarray):
    T = np.concatenate([np.asarray(Rwc, np.float32),
                        np.asarray(twc, np.float32)[:, None]], axis=1)
    _send(sock, MSG_POSE, struct.pack("<dB", t, state) + T.tobytes())


def send_bye(sock):
    _send(sock, MSG_BYE, b"")


def recv_message(sock) -> Optional[Tuple[int, bytes]]:
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    n, msg_type = _HDR.unpack(hdr)
    payload = _recv_exact(sock, n) if n else b""
    if n and payload is None:
        return None
    return msg_type, payload


def parse_imu(payload: bytes):
    vals = struct.unpack("<d6f", payload)
    return vals[0], np.asarray(vals[1:4], np.float32), np.asarray(vals[4:7], np.float32)


def parse_frame(payload: bytes):
    t, h, w = struct.unpack_from("<dHH", payload)
    img = np.frombuffer(payload, np.uint8, h * w, _HDR_FRAME).reshape(h, w)
    return t, img


_HDR_FRAME = struct.calcsize("<dHH")


def parse_stereo(payload: bytes):
    t, h, w = struct.unpack_from("<dHH", payload)
    n = h * w
    left = np.frombuffer(payload, np.uint8, n, _HDR_FRAME).reshape(h, w)
    right = np.frombuffer(payload, np.uint8, n, _HDR_FRAME + n).reshape(h, w)
    return t, left, right


def parse_pose(payload: bytes):
    t, state = struct.unpack_from("<dB", payload)
    T = np.frombuffer(payload, np.float32, 12, struct.calcsize("<dB")).reshape(3, 4)
    return t, state, T[:, :3].copy(), T[:, 3].copy()


def serve(system, sock: socket.socket):
    """Consume messages from `sock`, drive `system` (the port's `System`),
    answer each FRAME / STEREO with a POSE. As ORB-SLAM3's ROS node: IMU
    samples queue up between frames and go to Track* in a batch
    (`ros_mono_inertial.cc` SyncWithImu). Returns the number of frames
    tracked. Blocking; run it in its own thread or process, the only one
    that drives `system`."""
    imu_batch = []
    n = 0
    while True:
        msg = recv_message(sock)
        if msg is None:
            break
        msg_type, payload = msg
        if msg_type == MSG_BYE:
            break
        if msg_type == MSG_IMU:
            imu_batch.append(parse_imu(payload))
            continue
        if msg_type == MSG_FRAME:
            t, img = parse_frame(payload)
            cur = system.track_monocular(
                img.astype(np.float32), t, imu_measurements=imu_batch or None
            )
        elif msg_type == MSG_STEREO:
            t, left, right = parse_stereo(payload)
            cur = system.track_stereo(
                left.astype(np.float32), right.astype(np.float32), t,
                imu_measurements=imu_batch or None,
            )
        else:
            continue
        imu_batch = []
        n += 1
        Rwc, twc = cur.Twc()
        send_pose(sock, t, int(system.tracking_state.value), Rwc, twc)
    return n
