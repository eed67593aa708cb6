"""Live map and frame viewer over HTTP — the port of
`orbslam3_tpu/viz/server.py` (ORB-SLAM3's Pangolin viewer thread,
`Viewer.cc:76`, `FrameDrawer.cc`, `MapDrawer.cc`), with the same routes,
JSON keys, throttling and subsampling:

  /            the viewer page (canvas top-down map + frame overlay)
  /state.json  map snapshot: keyframes, map-point subsample, trajectory,
               current pose, tracking state, counters
  /frame.png   the tracked-keypoint overlay (`FrameDrawer::DrawFrame`); the
               state text is its `tEXt` chunk `state` (no OpenCV font here)
  /map.png     the top-down map render (`MapDrawer::DrawMapPoints`)

`update` runs on the thread that drives the `System`, after each frame: at
most every `min_period_s` it reads the map and the frame to the host in one
bundle (plus the trajectory of any stored map) and keeps an immutable
snapshot. The HTTP threads read only that snapshot and never touch a
tensor, so nothing but the tracking thread uses the device (the pose solves'
CUDA graphs need that). PNGs come from `io/png.py`.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from orbslam3_tpu_torch.io import png
from orbslam3_tpu_torch.viz import drawer

_PAGE = """<!doctype html>
<html><head><title>orbslam3_tpu_torch viewer</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:12px}
canvas,img{border:1px solid #444;background:#000}
#row{display:flex;gap:12px;flex-wrap:wrap}
</style></head><body>
<div id="hud">connecting...</div>
<div id="row"><canvas id="map" width="640" height="640"></canvas>
<img id="frame" width="480"/></div>
<script>
const cv = document.getElementById('map'), cx = cv.getContext('2d');
function draw(s){
  cx.fillStyle='#000'; cx.fillRect(0,0,cv.width,cv.height);
  const xs=[], ys=[];
  for(const p of s.map_points){xs.push(p[0]); ys.push(p[2]);}
  for(const k of s.keyframes){xs.push(k[0]); ys.push(k[2]);}
  if(!xs.length) return;
  const x0=Math.min(...xs), x1=Math.max(...xs), y0=Math.min(...ys), y1=Math.max(...ys);
  const sc=0.9*cv.width/Math.max(x1-x0, y1-y0, 1e-3);
  const mx=(x0+x1)/2, my=(y0+y1)/2;
  const T=(x,z)=>[cv.width/2+(x-mx)*sc, cv.height/2-(z-my)*sc];
  cx.fillStyle='#999';
  for(const p of s.map_points){const[a,b]=T(p[0],p[2]); cx.fillRect(a,b,1.5,1.5);}
  cx.strokeStyle='#e33'; cx.beginPath();
  s.trajectory.forEach((p,i)=>{const[a,b]=T(p[0],p[2]); i?cx.lineTo(a,b):cx.moveTo(a,b);});
  cx.stroke();
  cx.fillStyle='#3e3';
  for(const k of s.keyframes){const[a,b]=T(k[0],k[2]); cx.fillRect(a-2,b-2,4,4);}
  if(s.current_pose){const[a,b]=T(s.current_pose[0],s.current_pose[2]);
    cx.fillStyle='#ff0'; cx.beginPath(); cx.arc(a,b,5,0,7); cx.fill();}
}
async function tick(){
  try{
    const s = await (await fetch('state.json')).json();
    document.getElementById('hud').textContent =
      `state=${s.state} keyframes=${s.n_keyframes} points=${s.n_map_points}`+
      ` frame=${s.frame_id} loops=${s.n_loops}`;
    draw(s);
    document.getElementById('frame').src = 'frame.png?t=' + Date.now();
  }catch(e){}
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


class LiveViewer:
    """Embedded viewer server. `update(...)` publishes; HTTP serves."""

    def __init__(self, system, port: int = 0, host: str = "127.0.0.1",
                 min_period_s: float = 0.2, max_points: int = 4000):
        self._system = system
        self.min_period_s = float(min_period_s)
        self.max_points = int(max_points)
        self._state_json = b'{"state": "STARTING", "map_points": [], ' \
                           b'"keyframes": [], "trajectory": [], ' \
                           b'"n_keyframes": 0, "n_map_points": 0, ' \
                           b'"frame_id": -1, "n_loops": 0, ' \
                           b'"current_pose": null}'
        self._frame_png: Optional[bytes] = None
        self._map_snap: Optional[dict] = None
        self._last_pub = 0.0
        self.n_published = 0
        self._lock = threading.Lock()  # swaps the snapshot references only

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    body, ctype = _PAGE.encode(), "text/html"
                elif path == "/state.json":
                    with viewer._lock:
                        body = viewer._state_json
                    ctype = "application/json"
                elif path == "/frame.png":
                    with viewer._lock:
                        body = viewer._frame_png
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    ctype = "image/png"
                elif path == "/map.png":
                    body = viewer._render_map_png()
                    ctype = "image/png"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True,
                                        name="orbslam3_tpu_torch-viewer")
        self._thread.start()

    # -- publishing (the tracking thread) --------------------------------
    def update(self, img: Optional[np.ndarray] = None, frame=None) -> None:
        """Publish the current map and (with `img` and `frame`) the frame
        overlay, after a frame, as `FrameDrawer::Update` and
        `MapDrawer::SetCurrentCameraPose`. Throttled: it reads the device at
        most every `min_period_s`."""
        now = time.monotonic()
        if now - self._last_pub < self.min_period_s:
            return
        self._last_pub = now
        from orbslam3_tpu_torch.pipeline.tracking import fetch_bundle

        sysm = self._system
        s = sysm.store.state
        bundle = dict(mp_pos=s.mp_pos, mp_valid=s.mp_valid, kf_R=s.kf_R, kf_t=s.kf_t,
                      kf_valid=s.kf_valid)
        with_frame = img is not None and frame is not None
        if with_frame:
            bundle.update(uv=frame.features.uv, valid=frame.features.valid)
        h = fetch_bundle(bundle)  # the map and the frame in one copy
        mp, mv = h["mp_pos"], h["mp_valid"].astype(bool)
        kf_R, kf_t, kv = h["kf_R"], h["kf_t"], h["kf_valid"].astype(bool)
        rows = sysm.tracker.reconstructed_trajectory(known={sysm.store: (kf_R, kf_t)})
        traj_all = np.asarray([r[2] for r in rows]).reshape(-1, 3)
        pts = mp[mv]
        if len(pts) > self.max_points:
            pts = pts[:: max(1, len(pts) // self.max_points)]
        centers = np.einsum("kji,kj->ki", kf_R[kv], -kf_t[kv])
        traj = traj_all
        if len(traj) > 2000:
            traj = traj[:: len(traj) // 2000]
        cur = None
        tr = sysm.tracker
        if tr.last_frame is not None:
            _, twc = tr.last_frame.Twc()
            cur = np.asarray(twc).round(4).tolist()
        lc = sysm.loop_closer
        snap = {
            "state": sysm.tracking_state.name,
            "n_keyframes": int(kv.sum()),
            "n_map_points": int(mv.sum()),
            "frame_id": -1 if tr.last_frame is None else tr.last_frame.frame_id,
            "n_loops": 0 if lc is None else lc.n_loops_closed,
            "map_points": np.round(pts, 4).tolist(),
            "keyframes": np.round(centers, 4).tolist(),
            "trajectory": np.round(np.asarray(traj), 4).tolist(),
            "current_pose": cur,
        }
        state_json = json.dumps(snap).encode()
        all_centers = (np.einsum("kij->kji", kf_R) @ (-kf_t[..., None]))[..., 0]
        map_snap = dict(mp_pos=mp, mp_valid=mv, kf_centers=all_centers, kf_valid=kv,
                        traj=traj_all if len(rows) else None)
        frame_png = None
        if with_frame:
            ok = h["valid"].astype(bool)
            tracked = np.asarray(frame.mp_assoc) >= 0
            out, text = drawer.draw_frame(np.asarray(img), h["uv"][ok], tracked[ok],
                                          state_text=f"{snap['state']}  kp={int(ok.sum())}")
            frame_png = png.encode(out, text={"state": text})
        with self._lock:
            self._state_json = state_json
            self._map_snap = map_snap
            if frame_png is not None:
                self._frame_png = frame_png
        self.n_published += 1

    def _render_map_png(self) -> bytes:
        """/map.png from the last snapshot (numpy only)."""
        with self._lock:
            snap = self._map_snap
        if snap is None:
            return png.encode(np.zeros((640, 640, 3), np.uint8))
        return png.encode(drawer.render_map(snap))

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
