"""Headless visualization in numpy: frame overlays and top-down map renders —
the port of `orbslam3_tpu/viz/drawer.py` (ORB-SLAM3's FrameDrawer and
MapDrawer, `FrameDrawer.cc`, `MapDrawer.cc`) without OpenCV.

The rectangles, lines and tilted crosses are rasterized as OpenCV draws them
at thickness 1 with 8-connected lines (`cv::LineIterator` after
`cv::clipLine`), pixel for pixel. `cv2.putText`'s font is OpenCV's own, so
`draw_frame` draws no state text: it returns the text beside the image, and
the viewer writes it into the PNG's `tEXt` chunk (`state`).
Images are BGR uint8, as OpenCV's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _to_bgr(gray: np.ndarray) -> np.ndarray:
    g = np.clip(gray, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """`cv::clipLine` on a w x h image: the clipped end points, or None when
    the segment misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return None if (c1 | c2) else (x1, y1, x2, y2)


def line_pixels(w: int, h: int, p1, p2) -> list:
    """The (x, y) pixels of `cv2.line(img, p1, p2, color, 1, cv2.LINE_8)` on a
    w x h image: `cv::LineIterator` (8-connected, left to right) between the
    clipped end points."""
    x1, y1 = int(p1[0]), int(p1[1])
    x2, y2 = int(p2[0]), int(p2[1])
    if not (0 <= x1 < w and 0 <= y1 < h and 0 <= x2 < w and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return []
        x1, y1, x2, y2 = clipped
    if x2 < x1:  # left to right
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    out = []
    x, y = x1, y1
    for _ in range(dx + 1):
        out.append((x, y))
        if err < 0:  # the step along the minor axis too
            err += 2 * dx - 2 * dy
            if steep:
                x += 1
            else:
                y += sy
        else:
            err -= 2 * dy
        if steep:
            y += sy
        else:
            x += 1
    return out


def _line(img: np.ndarray, p1, p2, color) -> None:
    h, w = img.shape[:2]
    for x, y in line_pixels(w, h, p1, p2):
        img[y, x] = color


def _squares(img: np.ndarray, x: np.ndarray, y: np.ndarray, colors: np.ndarray) -> None:
    """`cv2.rectangle(img, (x - 3, y - 3), (x + 3, y + 3), color, 1)` for each
    centre in turn: a square's outline is four axis-aligned lines, which
    clipping leaves as their pixels inside the image; where squares overlap
    the later one's colour stays, as when OpenCV draws them one by one."""
    h, w = img.shape[:2]
    off = np.arange(-3, 4)
    x, y = np.asarray(x, np.int64)[:, None], np.asarray(y, np.int64)[:, None]
    xs = np.concatenate([x + off, x + off, np.broadcast_to(x - 3, (len(x), 7)),
                         np.broadcast_to(x + 3, (len(x), 7))], axis=1).reshape(-1)
    ys = np.concatenate([np.broadcast_to(y - 3, (len(y), 7)), np.broadcast_to(y + 3, (len(y), 7)),
                         y + off, y + off], axis=1).reshape(-1)
    cols = np.repeat(np.asarray(colors, np.uint8).reshape(-1, 3), 28, axis=0)
    inside = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    flat = (ys * w + xs)[inside]
    # the last write of each pixel wins: keep its last occurrence
    _, first_rev = np.unique(flat[::-1], return_index=True)
    last = len(flat) - 1 - first_rev
    img.reshape(-1, img.shape[2])[flat[last]] = cols[inside][last]


def draw_frame(img: np.ndarray, uv: np.ndarray, tracked: np.ndarray,
               state_text: str = "") -> tuple[np.ndarray, str]:
    """`FrameDrawer::DrawFrame`: keypoints as 7x7 squares, green where
    tracked (a map point), blue where only detected. Returns (BGR image,
    `state_text`), the text for the PNG's `tEXt` chunk."""
    out = _to_bgr(img)
    uv = np.asarray(uv).reshape(-1, 2)
    colors = np.where(np.asarray(tracked, bool)[:, None], [0, 255, 0], [255, 128, 0])
    _squares(out, uv[:, 0].astype(np.int64), uv[:, 1].astype(np.int64), colors)
    return out, state_text


def draw_map_topdown(mp_pos: np.ndarray, mp_valid: np.ndarray, kf_centers: np.ndarray,
                     kf_valid: np.ndarray, traj: Optional[np.ndarray] = None, size: int = 640,
                     axes=(0, 2)) -> np.ndarray:
    """`MapDrawer::DrawMapPoints/DrawKeyFrames` as an orthographic top-down
    (x-z by default) render: points grey, the frame trajectory red,
    keyframes as green tilted crosses (`cv2.MARKER_TILTED_CROSS`, size 6)."""
    img = np.zeros((size, size, 3), np.uint8)
    pts = mp_pos[mp_valid]
    all_xy = [pts[:, list(axes)]] if len(pts) else []
    kfs = kf_centers[kf_valid]
    if len(kfs):
        all_xy.append(kfs[:, list(axes)])
    if traj is not None and len(traj):
        all_xy.append(traj[:, list(axes)])
    if not all_xy:
        return img
    allp = np.concatenate(all_xy)
    lo = np.percentile(allp, 2, axis=0)
    hi = np.percentile(allp, 98, axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (size * 0.9) / span.max()
    off = (size - scale * (hi - lo)) / 2

    def to_px(xy):
        p = (xy - lo) * scale + off
        return np.clip(p, 0, size - 1).astype(np.int32)

    if len(pts):
        px = to_px(pts[:, list(axes)])
        img[px[:, 1], px[:, 0]] = (200, 200, 200)
    if traj is not None and len(traj):
        px = to_px(traj[:, list(axes)])
        for a, b in zip(px[:-1], px[1:]):
            _line(img, a, b, (0, 0, 255))
    if len(kfs):
        for x, y in to_px(kfs[:, list(axes)]):
            _line(img, (x - 3, y - 3), (x + 3, y + 3), (0, 255, 0))
            _line(img, (x + 3, y - 3), (x - 3, y + 3), (0, 255, 0))
    return img


def map_snapshot(system) -> dict:
    """What `render_map` needs of a `System`, read to the host: the points,
    the keyframe centres and the trajectory. Read on the thread that drives
    the system, between frames."""
    s = system.store.state
    kf_R, kf_t = s.kf_R.cpu().numpy(), s.kf_t.cpu().numpy()
    centers = (np.einsum("kij->kji", kf_R) @ (-kf_t[..., None]))[..., 0]
    ts, traj = system.get_trajectory()
    return dict(mp_pos=s.mp_pos.cpu().numpy(), mp_valid=s.mp_valid.cpu().numpy(),
                kf_centers=centers, kf_valid=s.kf_valid.cpu().numpy(),
                traj=traj if len(ts) else None)


def render_map(snap: dict) -> np.ndarray:
    """The top-down render of a `map_snapshot`."""
    return draw_map_topdown(snap["mp_pos"], snap["mp_valid"], snap["kf_centers"],
                            snap["kf_valid"], snap["traj"])


def render_system(system, out_path: Optional[str] = None) -> np.ndarray:
    """Render the current map of a `System` (top-down); with `out_path`,
    write it as a PNG."""
    img = render_map(map_snapshot(system))
    if out_path:
        from orbslam3_tpu_torch.io import png

        png.imwrite(out_path, img)
    return img
