"""Port parity: the live viewer (`viz/server.py`) and its renderers
(`viz/drawer.py`) against the JAX package's, on the CPU.

A CPU `System` tracks the first 6 frames of the 12-frame scene of
`tests/test_e2e_mono.py` (320x240, 400 features on 3 levels) with the viewer on; while it tracks, the four routes
answer (`/`, `/state.json`, `/frame.png`, `/map.png`). After the last frame,
the JAX package's `LiveViewer` publishes the same host state: its JSON is
byte for byte the port's, its `/map.png` pixel for pixel, and its
`/frame.png` pixel for pixel outside the box of the state text (which the
port writes into the PNG's `tEXt` chunk instead). The HTTP threads touch no
tensor.
"""

import json
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from orbslam3_tpu.ops import cameras as cam_j  # noqa: E402
from orbslam3_tpu.viz import server as server_j  # noqa: E402
from orbslam3_tpu_torch.io import png  # noqa: E402
from orbslam3_tpu_torch.ops import features as feat_t  # noqa: E402
from orbslam3_tpu_torch.ops.cameras import CameraModel  # noqa: E402
from orbslam3_tpu_torch.system import Sensor, System  # noqa: E402
from orbslam3_tpu_torch.viz import drawer  # noqa: E402
import test_e2e_mono as scene  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

N_FRAMES = 6


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=30) as r:
        return r.status, r.headers["Content-Type"], r.read()


@pytest.fixture(scope="module")
def run():
    params = cam_j.make_pinhole(scene.FOCAL, scene.FOCAL, scene.W / 2, scene.H / 2)
    pts, shades = scene.make_world(np.random.default_rng(0))
    imgs = [scene.render(params, R, t, pts, shades)
            for R, t in scene.camera_path(12)[:N_FRAMES]]  # the 12-frame path's start
    slam = System(Sensor.MONOCULAR, CameraModel.PINHOLE, np.asarray(params), (scene.W, scene.H),
                  orb_params=feat_t.OrbParams(n_features=400, n_levels=3), device="cpu",
                  Kmax=32, Pmax=4096)
    slam.enable_async_mapping()
    viewer = slam.enable_viewer(port=0, min_period_s=0.0)
    # the HTTP threads must not touch a tensor: count tensor reads by thread
    reads = []
    main = __import__("threading").current_thread()
    originals = {name: getattr(torch.Tensor, name) for name in ("cpu", "numpy", "item", "tolist")}

    def counted(name):
        def read(self, *a, **kw):
            if __import__("threading").current_thread() is not main:
                reads.append(name)
            return originals[name](self, *a, **kw)
        return read

    for name in originals:
        setattr(torch.Tensor, name, counted(name))
    routes = []
    try:
        for k, img in enumerate(imgs):
            slam.track_monocular(img, k * 0.1)
            routes.append({r: _get(viewer.port, r) for r in ("/", "/state.json", "/frame.png",
                                                            "/map.png")})
    finally:
        for name, f in originals.items():
            setattr(torch.Tensor, name, f)
    yield dict(slam=slam, viewer=viewer, routes=routes, img=imgs[-1], reads=reads)
    slam.shutdown()


def test_routes_answer_while_tracking(run):
    assert run["reads"] == []
    for k, routes in enumerate(run["routes"]):
        assert routes["/"][0] == 200 and b"<canvas" in routes["/"][2]
        state = json.loads(routes["/state.json"][2])
        assert state["frame_id"] == k
        assert routes["/frame.png"][1] == "image/png"
        frame = png.decode(routes["/frame.png"][2], png.IMREAD_UNCHANGED)
        assert frame.shape == (scene.H, scene.W, 3)
        assert png.decode(routes["/map.png"][2], png.IMREAD_UNCHANGED).shape == (640, 640, 3)
    last = json.loads(run["routes"][-1]["/state.json"][2])
    slam = run["slam"]
    assert last["state"] == slam.tracking_state.name == "OK"
    assert last["n_keyframes"] == slam.n_keyframes and last["n_map_points"] == slam.n_map_points
    assert b"tEXtstate\x00OK  kp=" in run["routes"][-1]["/frame.png"][2]


def _jax_view(slam):
    """The JAX viewer fed the port's host state after the last frame."""
    s = slam.store.state
    host = SimpleNamespace(**{k: getattr(s, k).numpy() for k in
                              ("mp_pos", "mp_valid", "kf_R", "kf_t", "kf_valid")})
    lf = slam.tracker.last_frame
    frame = SimpleNamespace(features=SimpleNamespace(uv=lf.features.uv.numpy(),
                                                     valid=lf.features.valid.numpy()),
                            mp_assoc=lf.mp_assoc, frame_id=lf.frame_id, Twc=lf.Twc)
    fake = SimpleNamespace(store=SimpleNamespace(state=host), get_trajectory=slam.get_trajectory,
                           tracker=SimpleNamespace(last_frame=frame), loop_closer=slam.loop_closer,
                           tracking_state=slam.tracking_state)
    v = server_j.LiveViewer(fake, port=0, min_period_s=0.0)
    return v, frame


def test_state_json_and_pictures_equal_reference(run):
    slam, img = run["slam"], run["img"]
    ref, frame = _jax_view(slam)
    try:
        ref.update(img, frame)
        ours = run["routes"][-1]
        assert json.loads(ours["/state.json"][2]).keys() == json.loads(ref._state_json).keys()
        assert ours["/state.json"][2] == ref._state_json
        map_ref = cv2.imdecode(np.frombuffer(ref._render_map_png(), np.uint8), -1)
        np.testing.assert_array_equal(png.decode(ours["/map.png"][2], png.IMREAD_UNCHANGED),
                                      map_ref)
        frame_ref = cv2.imdecode(np.frombuffer(ref._frame_png, np.uint8), -1)
        frame_got = png.decode(ours["/frame.png"][2], png.IMREAD_UNCHANGED)
        text = f"OK  kp={int(frame.features.valid.sum())}"
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        box = np.zeros(frame_got.shape[:2], bool)
        box[20 - th - 2:20 + base + 2, 8:10 + tw + 2] = True
        assert (frame_ref[~box] == frame_got[~box]).all()
        assert (frame_ref[box] != frame_got[box]).any()  # the text is only in the reference's
    finally:
        ref.close()


def test_primitives_equal_opencv():
    """Lines (clipped at every border), squares and tilted crosses; squares
    in bulk, overlapping at the borders, in drawing order."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        w, h = int(rng.integers(4, 40)), int(rng.integers(4, 40))
        a, b = np.zeros((h, w, 3), np.uint8), np.zeros((h, w, 3), np.uint8)
        p1 = tuple(int(v) for v in rng.integers(-20, 60, 2))
        p2 = tuple(int(v) for v in rng.integers(-20, 60, 2))
        cv2.line(a, p1, p2, (0, 0, 255), 1)
        drawer._line(b, p1, p2, (0, 0, 255))
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        cv2.rectangle(a, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0), 1)
        drawer._squares(b, np.array([x]), np.array([y]), np.array([[0, 255, 0]]))
        cv2.drawMarker(a, (x, y), (255, 128, 0), cv2.MARKER_TILTED_CROSS, 6)
        drawer._line(b, (x - 3, y - 3), (x + 3, y + 3), (255, 128, 0))
        drawer._line(b, (x + 3, y - 3), (x - 3, y + 3), (255, 128, 0))
        np.testing.assert_array_equal(a, b)
    a, b = np.zeros((30, 40, 3), np.uint8), np.zeros((30, 40, 3), np.uint8)
    x, y = rng.integers(-2, 42, 300), rng.integers(-2, 32, 300)
    colors = rng.integers(0, 256, (300, 3))
    for xi, yi, c in zip(x, y, colors):
        cv2.rectangle(a, (int(xi) - 3, int(yi) - 3), (int(xi) + 3, int(yi) + 3), c.tolist(), 1)
    drawer._squares(b, x, y, colors)
    np.testing.assert_array_equal(a, b)
