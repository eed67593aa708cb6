"""Port parity: the live-ingest protocol (`io/stream.py`) and the stream
server's loop (`serve`), against the JAX package on the CPU.

* every message's bytes (IMU, FRAME, STEREO, POSE, BYE) equal the JAX
  encoder's, and each parser reads them back;
* `serve` over a `socketpair`, with the client of `serve_stream.py`
  replaying a EuRoC directory written here (the 10-frame scene of
  `tests/test_e2e_mono.py` at 320x240, 400 features on 3 levels), answers
  every frame with the pose and state of the same `System` driven directly
  by `track_monocular` (both with asynchronous mapping, as the server runs).
"""

import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam3_tpu.io import stream as stream_j
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu_torch import serve_stream
from orbslam3_tpu_torch.io import datasets
from orbslam3_tpu_torch.io import stream as stream_t
from orbslam3_tpu_torch.pipeline.tracking import TrackState
import test_e2e_mono as scene
from test_runners import SETTINGS

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

N_FRAMES = 10


class _Wire:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


def _encode(mod, rng):
    img = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    right = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    R = rng.normal(0, 1, (3, 3)).astype(np.float32)
    t = rng.normal(0, 1, 3).astype(np.float32)
    out = {}
    for name, call in (("imu", lambda s: mod.send_imu(s, 1.25, [0.1, -9.8, 0.3], [1e-3, 2e-3, 3e-3])),
                       ("frame", lambda s: mod.send_frame(s, 2.5, img)),
                       ("stereo", lambda s: mod.send_stereo(s, 3.75, img, right)),
                       ("pose", lambda s: mod.send_pose(s, 4.0, 2, R, t)),
                       ("bye", mod.send_bye)):
        w = _Wire()
        call(w)
        out[name] = w.data
    return out, img, right, R, t


def test_messages_equal_reference_bytes():
    got, img, right, R, t = _encode(stream_t, np.random.default_rng(0))
    ref, *_ = _encode(stream_j, np.random.default_rng(0))
    assert got == ref
    assert (stream_t.MSG_IMU, stream_t.MSG_FRAME, stream_t.MSG_POSE, stream_t.MSG_STEREO,
            stream_t.MSG_BYE) == (1, 2, 3, 4, 9)
    hdr = 5  # u32 length, u8 type
    tt, acc, gyro = stream_t.parse_imu(got["imu"][hdr:])
    assert tt == 1.25 and np.allclose(acc, [0.1, -9.8, 0.3]) and np.allclose(gyro, [1e-3, 2e-3, 3e-3])
    tt, back = stream_t.parse_frame(got["frame"][hdr:])
    assert tt == 2.5 and (back == img).all()
    tt, lb, rb = stream_t.parse_stereo(got["stereo"][hdr:])
    assert tt == 3.75 and (lb == img).all() and (rb == right).all()
    tt, state, Rb, tb = stream_t.parse_pose(got["pose"][hdr:])
    assert (tt, state) == (4.0, 2) and (Rb == R).all() and (tb == t).all()
    assert got["bye"] == b"\x00\x00\x00\x00\x09"


def test_track_states_equal_reference():
    from orbslam3_tpu.pipeline.tracking import TrackState as TrackState_j

    assert [(s.name, s.value) for s in TrackState] == [(s.name, s.value) for s in TrackState_j]


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """The scene written as a EuRoC directory (grey 8-bit PNGs)."""
    root = tmp_path_factory.mktemp("stream_seq")
    params = cam_j.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2)
    pts, shades = scene.make_world(np.random.default_rng(0))
    imgs = [np.clip(np.round(scene.render(params, R, t, pts, shades)), 0, 255).astype(np.uint8)
            for R, t in scene.camera_path(N_FRAMES)]
    ns = [1_000_000_000 + 100_000_000 * k for k in range(N_FRAMES)]
    datasets.write_euroc(str(root), ns, imgs, SETTINGS)
    return str(root)


def _args(seq):
    return SimpleNamespace(settings=f"{seq}/settings.yaml", mode="mono", kmax=32, pmax=4096,
                           device="cpu", vocab=None, viewer=None)


def test_serve_answers_every_frame_as_a_direct_drive(sequence):
    served = serve_stream.build_system(_args(sequence))
    a, b = socket.socketpair()
    out = {}
    th = threading.Thread(target=lambda: out.setdefault("n", stream_t.serve(served, a)))
    th.start()
    poses = serve_stream.replay(b, sequence, log_every=0)
    th.join(timeout=600)
    a.close()
    b.close()
    assert out["n"] == N_FRAMES == len(poses)
    direct = serve_stream.build_system(_args(sequence))
    seq = datasets.load_euroc_images(sequence)
    for k, (t, state, Rwc, twc) in enumerate(poses):
        cur = direct.track_monocular(seq.read(k), float(seq.timestamps[k]))
        assert t == float(seq.timestamps[k])
        assert state == direct.tracking_state.value
        R_d, t_d = cur.Twc()
        np.testing.assert_allclose(Rwc, R_d, rtol=0, atol=1e-5)
        np.testing.assert_allclose(twc, t_d, rtol=0, atol=1e-5)
    assert TrackState(poses[-1][1]) == TrackState.OK
    assert served.n_keyframes == direct.n_keyframes >= 2
