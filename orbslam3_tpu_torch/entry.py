"""Entry points of the port's main path — the counterparts of
`__graft_entry__.py::entry`, `::staged_pipeline` and `::mapping_pass`, at
the same shapes by default.

Tracking (`entry`, `staged_pipeline`) runs at EuRoC shapes: 752x480 image,
8 levels, 1024 features, Kmax 64 keyframes, Pmax 16384 map points, an
8192-point local mask and 600 keypoints of the frame back-projected into the
map, so the motion-model stage tracks. `staged_pipeline(device)` is the
per-frame entry point: extraction, then `_track_step` with the cached
`compute_obs_count`, then one fetch of the decision bundle.

The mapping pass (`mapping_pass`) is what runs once per keyframe: two-view
triangulation of keyframe 71 against 10 neighbours, the fuse of 1024
candidate points into those neighbours, and the dense-Schur local BA over a
48-keyframe window with a fixed bucket of 32 (24 valid), on a 128-keyframe
map whose observations are consistent projections.

The `System` end to end (`replay`; `mono_replay` for the monocular one) is
the counterpart of `scripts/drive_slam.py` and `drive_slam_stereo.py` at
EuRoC width: `System.track_monocular`, `track_stereo` (config 2: the
rectified pair at a 0.11 m baseline, or the raw pair through
`enable_rectification`) or `track_rgbd` (the left image and its ray-cast
depth) on a stream of frames rendered by `scripts/make_synth_euroc.py`
(752x480, the synthetic room's circle), 1000 features on 8 levels, Kmax
256, Pmax 16384, scored by the Sim3 and the SE3 ATE against the rendered
camera centres; with a vocabulary, place recognition on, over a shortened
lap and a kidnap (earlier images at later timestamps); with `multimap`, the
Atlas too, over a lap with a blind interval (a covered lens: the map is
stored, a new one starts, and the two merge when the camera returns). The
inertial sensors add the script's 200 Hz IMU stream: monocular-inertial (config 3),
stereo-inertial on the rectified pair, and config 4, the stereo-inertial
two-camera fisheye rig of `make_synth_euroc.py --fisheye` (512x512
Kannala-Brandt 8 cameras 0.15 m apart in a smaller room).

The same sequences go to disk in each dataset layout the runner reads
(`write_euroc_sequence`), and `drive_files` drives a `System` (`make_system`
builds `replay`'s) directly on a directory's decoded files, the runner's
counterpart; `record_frames` watches either run frame by frame.

Scenes are built with numpy from a seed (`make_scene`, `make_mapping_scene`
draw from the generator in the reference's order), so a test can hand the
same map to the JAX package and to the port.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert, spans
from orbslam3_tpu_torch.ate import ate_rmse
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.pipeline import local_mapping as lmap
from orbslam3_tpu_torch.pipeline import tracking as trk


class SceneConfig(NamedTuple):
    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float
    n_features: int
    n_levels: int
    Kmax: int
    Pmax: int
    n_kf: int  # valid keyframes of the synthetic map
    n_mp: int  # valid random map points
    n_local: int  # first n_local points form the local mask
    n_back: int  # frame keypoints back-projected into the map
    first_id: int  # map slot of the first back-projected point
    ref_kf: int

    @property
    def orb(self) -> feat.OrbParams:
        return feat.OrbParams(n_features=self.n_features, n_levels=self.n_levels)


EUROC = SceneConfig(H=480, W=752, fx=458.654, fy=457.296, cx=376.0, cy=240.0,
                    n_features=1024, n_levels=8, Kmax=64, Pmax=16384, n_kf=24,
                    n_mp=12288, n_local=8192, n_back=600, first_id=12500, ref_kf=23)


def _synth_map(rng: np.random.Generator, Kmax=64, Pmax=16384, Nf=1024, n_kf=24,
               n_mp=12288, consistent=False, px_noise=0.5) -> st.MapState:
    """numpy MapState: n_mp random points over n_kf keyframes on a forward
    trajectory; the reference's `_synth_map`, same draws in the same order.
    `consistent=True` also stores each keyframe's observation pixels as the
    EuRoC-camera projections of its points plus `px_noise` pixels of noise,
    so a bundle adjustment over the map is a near-converged problem."""
    s = convert.to_numpy(st.empty_map(Kmax=Kmax, Pmax=Pmax, Nf=Nf, device="cpu"))
    pos = np.stack(
        [rng.uniform(-4, 4, n_mp), rng.uniform(-3, 3, n_mp), rng.uniform(2, 12, n_mp)], -1
    ).astype(np.float32)
    desc = rng.integers(0, 256, (n_mp, 32), dtype=np.uint8)
    normal = np.zeros((n_mp, 3), np.float32)
    normal[:, 2] = -1.0
    dist = np.linalg.norm(pos, axis=1)
    valid = np.zeros(Pmax, bool)
    valid[:n_mp] = True
    kf_R = np.tile(np.eye(3, dtype=np.float32), (Kmax, 1, 1))
    kf_t = np.zeros((Kmax, 3), np.float32)
    kf_t[:n_kf, 0] = np.linspace(0, 2.0, n_kf)
    kf_valid = np.zeros(Kmax, bool)
    kf_valid[:n_kf] = True
    kf_mp = np.full((Kmax, Nf), -1, np.int32)
    for k in range(n_kf):
        ids = rng.choice(n_mp, size=min(Nf, 600), replace=False)
        kf_mp[k, : len(ids)] = ids
    kf_uv = s.kf_uv
    if consistent:
        fx, fy, cx, cy = 458.654, 457.296, 376.0, 240.0
        kf_uv = kf_uv.copy()
        for k in range(n_kf):
            ids = kf_mp[k][kf_mp[k] >= 0]
            Xc = pos[ids] @ kf_R[k].T + kf_t[k]
            u = fx * Xc[:, 0] / Xc[:, 2] + cx
            v = fy * Xc[:, 1] / Xc[:, 2] + cy
            uv = np.stack([u, v], -1) + rng.normal(0, px_noise, (len(ids), 2))
            kf_uv[k, : len(ids)] = uv.astype(np.float32)
    pad = Pmax - n_mp
    return s._replace(
        kf_R=kf_R, kf_t=kf_t, kf_uv=kf_uv,
        kf_valid=kf_valid, kf_mp=kf_mp, kf_feat_valid=kf_mp >= 0,
        mp_pos=np.pad(pos, ((0, pad), (0, 0))),
        mp_desc=np.pad(desc, ((0, pad), (0, 0))),
        mp_normal=np.pad(normal, ((0, pad), (0, 0))),
        mp_min_dist=np.pad(dist * 0.2, (0, pad)).astype(np.float32),
        mp_max_dist=np.pad(dist * 5.0, (0, pad)).astype(np.float32),
        mp_valid=valid,
    )


class Scene(NamedTuple):
    """numpy inputs of one tracked frame."""

    img: np.ndarray  # (H, W) float32
    state: st.MapState  # of numpy arrays
    local_mask: np.ndarray  # (Pmax,) bool
    R_pred: np.ndarray  # (3, 3)
    t_pred: np.ndarray  # (3,)
    last_mp: np.ndarray  # (n_features,) int32
    last_octave: np.ndarray  # (n_features,) int32


def make_scene(cfg: SceneConfig, extract_np: Callable) -> Scene:
    """The synthetic map plus a random image whose own keypoints
    (`extract_np(img) -> numpy Features`) are back-projected at depth 5
    into map points carrying their descriptors, associated to the "last
    frame": the motion-model stage then genuinely succeeds."""
    rng = np.random.default_rng(0)
    s = _synth_map(rng, Kmax=cfg.Kmax, Pmax=cfg.Pmax, Nf=cfg.n_features,
                   n_kf=cfg.n_kf, n_mp=cfg.n_mp)
    local_mask = np.zeros(cfg.Pmax, bool)
    local_mask[: cfg.n_local] = True
    img = rng.uniform(0, 255, (cfg.H, cfg.W)).astype(np.float32)
    f = extract_np(img)
    sel = np.flatnonzero(f.valid)[: cfg.n_back]
    R_pred = np.eye(3, dtype=np.float32)
    t_pred = np.asarray([0.0, 0.0, 0.1], np.float32)
    z0 = 5.0
    Xc = np.stack([
        (f.uv[sel, 0] - cfg.cx) / cfg.fx * z0,
        (f.uv[sel, 1] - cfg.cy) / cfg.fy * z0,
        np.full(len(sel), z0),
    ], -1).astype(np.float32)
    Xw = (Xc - t_pred) @ R_pred  # R^T (Xc - t)
    ids = np.arange(cfg.first_id, cfg.first_id + len(sel), dtype=np.int32)
    dist = np.linalg.norm(Xw, axis=1)
    nrm = np.zeros((len(sel), 3), np.float32)
    nrm[:, 2] = -1.0
    arrays = {k: np.array(v, copy=True) for k, v in s._asdict().items()}
    arrays["mp_pos"][ids] = Xw
    arrays["mp_desc"][ids] = f.desc[sel]
    arrays["mp_normal"][ids] = nrm
    arrays["mp_min_dist"][ids] = (dist * 0.2).astype(np.float32)
    arrays["mp_max_dist"][ids] = (dist * 5.0).astype(np.float32)
    arrays["mp_valid"][ids] = True
    local_mask[cfg.first_id : cfg.first_id + len(sel)] = True
    last_mp = np.full(len(f.valid), -1, np.int32)
    last_mp[sel] = ids
    return Scene(img=img, state=st.MapState(**arrays), local_mask=local_mask,
                 R_pred=R_pred, t_pred=t_pred, last_mp=last_mp,
                 last_octave=np.asarray(f.octave, np.int32))


def scene_to_device(scene: Scene, device) -> tuple:
    """(img, state, local_mask, R_pred, t_pred, last_mp, last_octave) as
    tensors on `device` — the argument tuple of `entry`'s step and of
    `staged_pipeline`'s run."""
    return (
        convert.tensor(scene.img, device), convert.to_torch(scene.state, device),
        convert.tensor(scene.local_mask, device), convert.tensor(scene.R_pred, device),
        convert.tensor(scene.t_pred, device), convert.tensor(scene.last_mp, device),
        convert.tensor(scene.last_octave, device),
    )


def _port_extract_np(cfg: SceneConfig, device):
    def run(img: np.ndarray) -> feat.Features:
        return convert.to_numpy(feat.extract(convert.tensor(img, device), cfg.orb))
    return run


class _Consts(NamedTuple):
    model: cam.CameraModel
    params: torch.Tensor
    sigma2: torch.Tensor
    scale_f: torch.Tensor
    img_wh: torch.Tensor


def _consts(cfg: SceneConfig, device) -> _Consts:
    orb = cfg.orb
    return _Consts(
        model=cam.CameraModel.PINHOLE,
        params=cam.make_pinhole(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=device),
        sigma2=convert.tensor(feat.sigma2(orb), device),
        scale_f=convert.tensor(feat.scale_factors(orb), device),
        img_wh=torch.tensor([float(cfg.W), float(cfg.H)], dtype=torch.float32, device=device),
    )


def entry(device, cfg: SceneConfig = EUROC):
    """(step, args): the flagship per-frame hot path — extraction ->
    motion-model projection match -> pose solve #1 -> frustum + local-map
    projection match -> pose solve #2. `step(*args)` returns (R, t, n_inl)."""
    c = _consts(cfg, device)
    orb = cfg.orb

    def step(img, state, local_mask, R_pred, t_pred, last_mp, last_octave):
        f = feat.extract(img, orb)
        assoc1, _ = trk._track_last_frame(
            c.model, c.params, R_pred, t_pred, last_mp, state.mp_pos, state.mp_valid,
            state.mp_desc, f, 15.0, c.scale_f, last_octave,
        )
        res1 = trk._pose_opt_from_assoc(c.model, c.params, R_pred, t_pred, assoc1, f,
                                        state.mp_pos, state.mp_valid, c.sigma2)
        assoc1 = torch.where(res1.inlier, assoc1, torch.full_like(assoc1, -1))
        assoc2, _ = trk._track_local_map_match(
            c.model, c.params, res1.R, res1.t, state, local_mask, f, assoc1, c.img_wh,
            n_levels=orb.n_levels,
        )
        res2 = trk._pose_opt_from_assoc(c.model, c.params, res1.R, res1.t, assoc2, f,
                                        state.mp_pos, state.mp_valid, c.sigma2)
        return res2.R, res2.t, res2.n_inliers

    scene = make_scene(cfg, _port_extract_np(cfg, device))
    return step, scene_to_device(scene, device)


def staged_pipeline(device, cfg: SceneConfig = EUROC):
    """run(img, state, local_mask, R_pred, t_pred, last_mp, last_octave) ->
    the frame's decision bundle as numpy (`tracking.fetch_bundle`): extraction,
    then the whole two-stage track, with per-map-state cached observation
    counts, as the production tracker dispatches them."""
    c = _consts(cfg, device)
    orb = cfg.orb
    ref_kf = torch.tensor(cfg.ref_kf, dtype=torch.int32, device=device)
    min_obs = torch.tensor(3, dtype=torch.int32, device=device)
    have_pred = torch.tensor(True, device=device)
    obs_cache = {}

    def run(img, state, local_mask, R_pred, t_pred, last_mp, last_octave):
        f = feat.extract(img, orb)
        key = id(state)
        if key not in obs_cache:
            obs_cache[key] = trk.compute_obs_count(state)
        bundle, _ = trk._track_step(
            c.model, c.params, state, f, R_pred, t_pred, have_pred, last_mp, last_octave,
            ref_kf, R_pred, t_pred, c.scale_f, c.sigma2, c.img_wh, min_obs,
            obs_count=obs_cache[key], n_levels=orb.n_levels,
        )
        return trk.fetch_bundle(bundle)

    return run


# ---------------------------------------------------------------------------
# The per-keyframe mapping pass
# ---------------------------------------------------------------------------


class MappingConfig(NamedTuple):
    """Shapes of the mapping scene (the camera and ORB levels of `EUROC`)."""

    Kmax: int
    Pmax: int
    Nf: int
    n_kf: int  # valid keyframes; the newest one is the current keyframe
    n_mp: int
    n_nb: int  # covisible neighbours: the n_nb keyframes before the current one
    n_cand: int  # fuse candidates
    n_window: int  # optimizable keyframes: the newest n_window
    n_fixed: int  # fixed bucket, -1 padded
    n_fixed_valid: int  # fixed keyframes 0 .. n_fixed_valid - 1
    iters: int  # LM iterations of the local BA


EUROC_MAPPING = MappingConfig(Kmax=128, Pmax=16384, Nf=1024, n_kf=72, n_mp=12288, n_nb=10,
                              n_cand=1024, n_window=48, n_fixed=32, n_fixed_valid=24, iters=5)


class MappingScene(NamedTuple):
    """numpy inputs of one mapping pass."""

    state: st.MapState  # of numpy arrays
    kf: int  # the current keyframe
    nb_ids: np.ndarray  # (n_nb,) int32
    cand_ids: np.ndarray  # (n_cand,) int32
    cand_valid: np.ndarray  # (n_cand,) bool
    window_ids: np.ndarray  # (n_window,) int32
    fixed_ids: np.ndarray  # (n_fixed,) int32, -1 padded


def make_mapping_scene(cfg: MappingConfig = EUROC_MAPPING) -> MappingScene:
    """The reference's mapping scene: a consistent map, every keyframe
    translation perturbed by 4 mm and every point by 1 cm (the increment a
    keyframe insertion leaves for the local BA), then the candidates."""
    rng = np.random.default_rng(1)
    s = _synth_map(rng, Kmax=cfg.Kmax, Pmax=cfg.Pmax, Nf=cfg.Nf, n_kf=cfg.n_kf,
                   n_mp=cfg.n_mp, consistent=True)
    kf_t = s.kf_t + rng.normal(0, 0.004, s.kf_t.shape).astype(np.float32)
    mp_pos = s.mp_pos + rng.normal(0, 0.01, s.mp_pos.shape).astype(np.float32)
    kf = cfg.n_kf - 1
    cand_ids = rng.choice(cfg.n_mp, cfg.n_cand, replace=False).astype(np.int32)
    fixed = np.full(cfg.n_fixed, -1, np.int32)
    fixed[: cfg.n_fixed_valid] = np.arange(cfg.n_fixed_valid, dtype=np.int32)
    return MappingScene(
        state=s._replace(kf_t=kf_t, mp_pos=mp_pos), kf=kf,
        nb_ids=np.arange(kf - cfg.n_nb, kf, dtype=np.int32), cand_ids=cand_ids,
        cand_valid=np.ones(cfg.n_cand, bool),
        window_ids=np.arange(cfg.n_kf - cfg.n_window, cfg.n_kf, dtype=np.int32),
        fixed_ids=fixed,
    )


def _project_np(R, t, X, c: SceneConfig):
    Xc = X @ R.T + t
    return np.stack([c.fx * Xc[:, 0] / Xc[:, 2] + c.cx, c.fy * Xc[:, 1] / Xc[:, 2] + c.cy], -1), Xc


def mapping_variant(scene: MappingScene, n_tri: int = 200, n_fuse: int = 100) -> MappingScene:
    """The mapping scene with work for triangulation and fuse. The
    reference's scene has none: its keyframe descriptors are zeros and its
    normals face away from the cameras, so both stages find nothing. Here:

    * normals point along the viewing rays and every observed slot carries
      its point's descriptor;
    * `n_tri` new points 2-4 m in front of the current keyframe are planted
      in free slots of it and of up to 4 neighbours each (one shared random
      descriptor per point, 0.5 px noise, octave 0);
    * per neighbour, `n_fuse` candidates it does not observe are planted as
      free keypoints at their projections, at their predicted octave;
    * per neighbour, 3 observed slots are moved onto the
      projection of another unobserved candidate, with its descriptor: fuse
      reports them as conflicts (and the local BA as outliers);
    * one observation of keyframe 0 (fixed, with the fixed list padded) is
      moved by 30 px: the local BA must erase it.
    """
    rng = np.random.default_rng(7)
    n_conflict = 3
    c = EUROC
    a = {k: np.array(v, copy=True) for k, v in scene.state._asdict().items()}
    kf_mp, kf_uv, kf_oct, kf_desc = a["kf_mp"], a["kf_uv"], a["kf_octave"], a["kf_desc"]
    kf_fv = a["kf_feat_valid"]
    n_kf = int(a["kf_valid"].sum())
    centers = np.stack([-a["kf_R"][k].T @ a["kf_t"][k] for k in range(n_kf)])
    valid = a["mp_valid"]
    nrm = a["mp_pos"] - centers.mean(0)
    a["mp_normal"][valid] = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True))[valid]
    obs = kf_mp >= 0
    kf_desc[obs] = a["mp_desc"][kf_mp[obs]]

    free = {k: list(np.flatnonzero((kf_mp[k] < 0) & ~kf_fv[k]))
            for k in [scene.kf, *scene.nb_ids.tolist()]}

    def plant(k, uv, octave, desc):
        j = free[k].pop(0)
        kf_uv[k, j], kf_oct[k, j], kf_desc[k, j], kf_fv[k, j] = uv, octave, desc, True

    def in_image(uv, Xc, margin=8.0):
        return (Xc[:, 2] > 0.5) & (uv[:, 0] >= margin) & (uv[:, 0] < c.W - margin) \
            & (uv[:, 1] >= margin) & (uv[:, 1] < c.H - margin)

    # New points for triangulation.
    R1, t1 = a["kf_R"][scene.kf], a["kf_t"][scene.kf]
    uv0 = np.stack([rng.uniform(40, c.W - 40, n_tri), rng.uniform(40, c.H - 40, n_tri)], -1)
    z = rng.uniform(2.0, 4.0, n_tri)
    Xc = np.stack([(uv0[:, 0] - c.cx) / c.fx * z, (uv0[:, 1] - c.cy) / c.fy * z, z], -1)
    Xw = ((Xc - t1) @ R1).astype(np.float32)
    desc = rng.integers(0, 256, (n_tri, 32), dtype=np.uint8)
    for i in range(n_tri):
        nbs = rng.choice(scene.nb_ids, size=min(4, len(scene.nb_ids)), replace=False)
        for k in [scene.kf, *nbs.tolist()]:
            uv, Xc_k = _project_np(a["kf_R"][k], a["kf_t"][k], Xw[i : i + 1], c)
            if in_image(uv, Xc_k)[0] and free[k]:
                plant(k, uv[0] + rng.normal(0, 0.5, 2), 0, desc[i])

    # Fuse candidates planted as keypoints, and conflicts.
    scale = 1.2
    for k in scene.nb_ids.tolist():
        seen = set(kf_mp[k][kf_mp[k] >= 0].tolist())
        cands = [int(p) for p in scene.cand_ids if int(p) not in seen]
        R, t = a["kf_R"][k], a["kf_t"][k]
        X = a["mp_pos"][cands]
        uv, Xc_k = _project_np(R, t, X, c)
        dist = np.linalg.norm(X - centers[k], axis=1)
        q = np.log(a["mp_max_dist"][cands] / dist) / np.log(scale)
        lvl = np.clip(np.ceil(q), 0, c.n_levels - 1).astype(np.int32)
        # Keep clear of the rounding edges of the predicted octave.
        saturated = q > c.n_levels - 2 + 0.05
        safe = in_image(uv, Xc_k) & (saturated | (np.abs(q - np.round(q)) > 0.05))
        pick = rng.permutation(np.flatnonzero(safe))
        for i in pick[:n_fuse]:
            if free[k]:
                plant(k, uv[i] + rng.normal(0, 0.3, 2), lvl[i], a["mp_desc"][cands[i]])
        occupied = np.flatnonzero(kf_mp[k] >= 0)
        for i, j in zip(pick[n_fuse : n_fuse + n_conflict], occupied[:n_conflict]):
            kf_uv[k, j], kf_oct[k, j] = uv[i], lvl[i]
            kf_desc[k, j] = a["mp_desc"][cands[i]]

    # An outlier observation in keyframe 0 of a point the local BA keeps
    # (the window sees it, and it is among the first POINT_CAP such points).
    win = np.zeros(len(valid), bool)
    win_mp = kf_mp[scene.window_ids]
    win[win_mp[win_mp >= 0]] = True
    kept = set(np.flatnonzero(win & valid)[: lmap.POINT_CAP].tolist())
    j = next(j for j in range(kf_mp.shape[1]) if kf_mp[0, j] in kept)
    kf_uv[0, j] += 30.0
    return scene._replace(state=st.MapState(**a))


class MappingOut(NamedTuple):
    """One mapping pass: triangulation and fuse per neighbour (leading axis),
    and the map after the local BA."""

    Xw: torch.Tensor  # (n_nb, Nf, 3) triangulated points per current-KF feature
    good: torch.Tensor  # (n_nb, Nf) bool
    idx: torch.Tensor  # (n_nb, Nf) int32 matched neighbour feature
    rows: torch.Tensor  # (n_nb, Nf) int32 fused kf_mp rows
    adds: torch.Tensor  # (n_nb,) int32
    incumbent: torch.Tensor  # (n_nb, n_cand) int32
    conflict: torch.Tensor  # (n_nb, n_cand) bool
    state: st.MapState  # after the local BA write-back and outlier erase
    cost: torch.Tensor  # local BA cost at the accepted state
    n_bad: torch.Tensor  # erased outlier observations


def mapping_pass(device, cfg: MappingConfig = EUROC_MAPPING):
    """(run, (state,)): the device programs of one per-keyframe mapping pass
    on `make_mapping_scene(cfg)`. `run(state)` returns a `MappingOut` of
    device tensors; it reads nothing back to the host."""
    scene = make_mapping_scene(cfg)
    c = _consts(EUROC, device)
    T = lambda x: convert.tensor(x, device)  # noqa: E731
    kf = scene.kf
    nb_ids, cand_ids, cand_valid = T(scene.nb_ids), T(scene.cand_ids), T(scene.cand_valid)
    window_ids, fixed_ids = T(scene.window_ids), T(scene.fixed_ids)
    nb = nb_ids.to(torch.int64)

    def run(state: st.MapState) -> MappingOut:
        Xw, good, idx = lmap.triangulate_batch(
            c.model, c.params, state.kf_R[kf], state.kf_t[kf], state.kf_uv[kf],
            state.kf_octave[kf], state.kf_desc[kf], state.kf_mp[kf] < 0,
            state.kf_R[nb], state.kf_t[nb], state.kf_uv[nb], state.kf_octave[nb],
            state.kf_desc[nb], state.kf_mp[nb] < 0, c.sigma2, c.scale_f, EUROC.fx,
        )
        rows, adds, incumbent, conflict = lmap._fuse_batch(
            c.model, c.params, state, nb_ids, cand_ids, cand_valid, c.img_wh, c.sigma2,
            n_levels=EUROC.n_levels,
        )
        new_state, cost, n_bad = lmap.local_ba(c.model, c.params, state, window_ids,
                                               fixed_ids, c.sigma2, iters=cfg.iters)
        return MappingOut(Xw, good, idx, rows, adds, incumbent, conflict, new_state, cost, n_bad)

    return run, (convert.to_torch(scene.state, device),)


def fetch_mapping(out: MappingOut) -> dict:
    """The pass's results on the host as numpy, in one device-to-host copy
    (`tracking.fetch_bundle`)."""
    st_new = out.state
    return trk.fetch_bundle(dict(
        Xw=out.Xw, good=out.good, idx=out.idx, rows=out.rows, adds=out.adds,
        conflict=out.conflict, cost=out.cost, n_bad=out.n_bad, kf_R=st_new.kf_R,
        kf_t=st_new.kf_t, kf_mp=st_new.kf_mp, mp_pos=st_new.mp_pos,
    ))


# ---------------------------------------------------------------------------
# The monocular System end to end
# ---------------------------------------------------------------------------

EUROC_MONO = dict(camera=[458.0, 458.0, 376.0, 240.0, 0.0, 0.0, 0.0, 0.0], img_wh=(752, 480),
                  orb=feat.OrbParams(), Kmax=256, Pmax=16384, fps=20.0)
# Config 2: the script's `--stereo` settings, Camera.bf = FX * 0.11 m (ThDepth
# 35, so the close/far cutoff is 3.85 m). RGB-D uses the same bf.
EUROC_STEREO = dict(EUROC_MONO, bf=458.0 * 0.11)
# Config 3 (mono-inertial): the script's IMU.* settings and Tbc = I.
EUROC_MONO_VI = dict(EUROC_MONO, imu=dict(noise_gyro=1.7e-4, noise_acc=2.0e-3,
                                          walk_gyro=1.9e-5, walk_acc=3.0e-3, freq=200.0),
                     Tbc=np.eye(4))
# Config 2 with the IMU (stereo-inertial on the rectified pair).
EUROC_STEREO_VI = dict(EUROC_STEREO, imu=EUROC_MONO_VI["imu"], Tbc=np.eye(4))
# Config 4 (stereo-fisheye-inertial): the numbers of the script's
# `FE_SETTINGS_YAML` — two KB8 cameras, Tlr = [I | (0.15, 0, 0)], lapping
# areas the whole width, the IMU.* settings and Tbc = I, 1000 features on 8
# levels (FAST 20 / 7).
_FE_TLR = np.eye(4)
_FE_TLR[0, 3] = 0.15
EUROC_STEREO_VI_FISHEYE = dict(
    camera=[190.97, 190.97, 254.93, 256.90, 0.0034823894, 0.00071503485, -0.0020532361,
            0.00020293674],
    camera2=([190.44, 190.44, 252.20, 254.00, 0.0034003171, 0.0017662782, -0.0026631257,
              0.00032995174], _FE_TLR, (0.0, 511.0), (0.0, 511.0)),
    img_wh=(512, 512), orb=feat.OrbParams(), Kmax=256, Pmax=16384, fps=20.0,
    imu=EUROC_MONO_VI["imu"], Tbc=np.eye(4))
_SYNTH = Path(__file__).resolve().parent.parent / "scripts" / "make_synth_euroc.py"


def synth_euroc():
    """`scripts/make_synth_euroc.py` (numpy only, not a package), loaded by
    its file path: `make_textures`, `pose_at`, `render`."""
    spec = importlib.util.spec_from_file_location("make_synth_euroc", _SYNTH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def euroc_frames(n_frames: int, seed: int = 0, t_loop: float | None = None,
                 kidnap: tuple[int, int] | None = None, stereo: bool = False,
                 raw: bool = False, depth: bool = False, imu: bool = False,
                 fisheye: bool = False, blind: tuple[int, int] | None = None):
    """(timestamps (n,), uint8 images, camera centres (n, 3)) of the synthetic
    sequence, rendered as the script's `main` renders them: t = k / 20 s,
    then sensor noise of 1.5 grey levels from the same generator as the
    textures. The images are (n, 480, 752), or with `stereo` (n, 2, 480, 752)
    left and right: the right camera's centre is the left's plus
    R_wc (0.11, 0, 0) m, and each frame draws the left image's noise, then
    the right's (the script's `--stereo` output). `raw` renders the pair
    unrectified as `--raw-stereo` does (radial-tangential distortion, both
    cameras pitched by the script's 2 degrees); `raw_stereo_rig()` holds
    its rectification. `depth` appends a fourth output, the left camera's
    z-depth in metres (n, 480, 752) float32, noise-free (`ray_depth`).
    `imu` appends the script's 200 Hz IMU stream over the frames' span as
    (t (m,), acc (m, 3), gyro (m, 3)), float64: the ideal samples of
    `imu_sample` plus the script's constant biases and white noise of
    density 2e-3 (acc) and 1.7e-4 (gyro) scaled by sqrt(200), drawn from the
    same generator after every image, as the script's `main` draws them.
    `fisheye` renders the pair of `--fisheye` instead (n, 2, 512, 512): the
    script's smaller room (`BOX_LO`/`BOX_HI`, `TRAJ_R`, `TRAJ_Z`, a 40 s
    lap), each camera's Kannala-Brandt 8 ray grid (`kb8_dir_grid`, the
    script's `FE_INTR_L` / `FE_INTR_R`), the right eye at R_wc (0.15, 0, 0)
    from the left; the noise drawn left then right per frame.

    `t_loop` sets the script's lap length (`T_LOOP`, seconds; its default
    60 s when None). `kidnap` = (at, src): frame k >= at shows the scene of
    frame src + k - at, still at time k / 20 s (a camera carried back along
    its path, timestamps increasing), and its centre is that frame's.
    `blind` = (at, n): frames at ... at + n - 1 are a uniform grey 35 image
    (a covered lens, both cameras of a pair); the camera moves on along its
    path, and the noise of those frames is still drawn, so every other frame
    is the one the sequence without `blind` has.

    Frame k depends only on the arguments other than `n_frames` and `imu`
    and on the generator's state after frame k - 1, so the process keeps each
    sequence it rendered with the generator's state after every frame
    (`_Sequence`): a shorter one is its prefix, a longer one renders only its
    new frames, and the IMU stream of an n-frame sequence is drawn from the
    state after frame n - 1. A sequence with a kidnap or a blind interval is
    the one without them up to its first such frame, so those frames are
    shared too; two that differ in their blind interval alone share every
    frame that neither covers. `clear_frames()` drops them. A sequence
    `load_frames` read is served as saved: exactly its frames, without IMU
    or depth."""
    key = _Sequence.key_of(seed, t_loop, kidnap, stereo, raw, depth, fisheye, blind)
    if key in _LOADED:
        if n_frames != len(_LOADED[key][0]) or imu:
            raise ValueError(f"the loaded sequence holds exactly {len(_LOADED[key][0])} "
                             "frames and no IMU stream")
        return _LOADED[key]
    seq = _SEQUENCES.get(key)
    if seq is None:
        seq = _SEQUENCES[key] = _Sequence(*key)
        for other in list(_SEQUENCES.values()):
            seq.adopt_prefix(other)
    seq.extend(n_frames)
    out = (np.asarray(seq.ts[:n_frames]), np.stack(seq.imgs[:n_frames]),
           np.asarray(seq.centres[:n_frames]))
    if depth:
        out += (np.stack(seq.depths[:n_frames]),)
    if imu:
        out += (_imu_stream(seq.M, seq.generator_after(n_frames), n_frames),)
    return out


_SEQUENCES: dict = {}  # euroc_frames' arguments but n_frames and imu -> _Sequence
_LOADED: dict = {}  # the same key -> (ts, imgs, centres) that load_frames read
RENDER_THREADS = min(8, os.cpu_count() or 1)  # threads that ray-cast a sequence's frames


def clear_frames() -> None:
    """Forget every sequence `euroc_frames` rendered or `load_frames` read in
    this process."""
    _SEQUENCES.clear()
    _LOADED.clear()


def save_frames(path: str, n_frames: int, seed: int = 0, **kw) -> None:
    """Write `euroc_frames(n_frames, seed, **kw)`'s times, images and centres
    and its arguments to `path` (an uncompressed npz), for `load_frames` in
    another process: the ranks of a distributed replay read the lap instead
    of each rendering it. Not for one with depth or an IMU stream."""
    if "depth" in kw or "imu" in kw:
        raise ValueError("save_frames keeps no depth and no IMU stream")
    ts, imgs, centres = euroc_frames(n_frames, seed, **kw)
    with open(path, "wb") as f:
        np.savez(f, args=np.array(json.dumps(dict(seed=seed, **kw))), ts=ts, imgs=imgs,
                 centres=centres)


def load_frames(path: str) -> None:
    """Serve the frames `save_frames` wrote to `path` as this process's
    `euroc_frames` of the same arguments, at exactly the saved length."""
    with np.load(path) as d:
        key = _Sequence.key_of(**json.loads(str(d["args"])))
        _LOADED[key] = (d["ts"], d["imgs"], d["centres"])


class _Sequence:
    """One synthetic sequence as far as it was rendered: per frame its time,
    image(s), centre, depth and the generator's state after it."""

    @staticmethod
    def key_of(seed=0, t_loop=None, kidnap=None, stereo=False, raw=False, depth=False,
               fisheye=False, blind=None):
        return (int(seed), None if t_loop is None else float(t_loop),
                None if kidnap is None else tuple(kidnap), bool(stereo or raw or fisheye),
                bool(raw), bool(depth), bool(fisheye), None if blind is None else tuple(blind))

    def __init__(self, seed, t_loop, kidnap, stereo, raw, depth, fisheye, blind):
        self.key = (seed, t_loop, kidnap, stereo, raw, depth, fisheye, blind)
        self.seed, self.kidnap, self.stereo, self.raw = seed, kidnap, stereo, raw
        self.depth, self.blind = depth, blind
        self.M = _configured(fisheye, t_loop)
        M = self.M
        self.R_raw, self.dirs, self.dirs_r, self.baseline = np.eye(3), None, None, M.BASELINE_M
        if fisheye:
            self.dirs = M.kb8_dir_grid((M.FE_W, M.FE_H), M.FE_INTR_L)
            self.dirs_r = M.kb8_dir_grid((M.FE_W, M.FE_H), M.FE_INTR_R)
            self.baseline = M.FE_BASELINE_M
        if raw:
            c, s = np.cos(np.radians(M.RAW_PITCH_DEG)), np.sin(np.radians(M.RAW_PITCH_DEG))
            self.R_raw = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
            self.dirs = self.dirs_r = M.radtan_dir_grid((M.W, M.H), (M.FX, M.FY, M.CX, M.CY),
                                                        M.RAW_DIST)
        self.ts, self.imgs, self.centres, self.depths, self.states = [], [], [], [], []
        self.tex = None

    def adopt_prefix(self, other: "_Sequence") -> None:
        """Take the frames `other` rendered that this sequence shares: all
        those before the first kidnapped or blind frame of either, when the
        two differ in their kidnap or blind interval only; when both differ
        in their blind interval only, every frame (a frame blind in `other`
        but not here is left to `extend` to render)."""
        a, b = self.key, other.key
        if other is self or a[:2] + a[3:7] != b[:2] + b[3:7] or len(other.ts) <= len(self.ts):
            return
        if a[2] is None and b[2] is None and b[7] is not None and b[7][0] > 0:
            # Blind frames draw their noise too: the generator states, times and
            # centres are the same, and so is every frame that neither covers.
            n = len(other.ts)
            self.imgs = [self.imgs[k] if k < len(self.imgs) else
                         self._grey() if self.covered(k) else
                         other.imgs[k] if not other.covered(k) else None for k in range(n)]
            for name in ("ts", "centres", "depths", "states"):
                setattr(self, name, list(getattr(other, name)))
            self.tex = other.tex
            return
        starts = [e[0] for e in (a[2], a[7], b[2], b[7]) if e is not None]
        n = min([len(other.ts)] + starts)
        if n > len(self.ts):
            for name in ("ts", "imgs", "centres", "depths", "states"):
                setattr(self, name, list(getattr(other, name)[:n]))
            self.tex = other.tex

    def covered(self, k: int) -> bool:
        return self.blind is not None and self.blind[0] <= k < self.blind[0] + self.blind[1]

    def _grey(self) -> np.ndarray:
        """A covered lens: frame k's image(s) in a blind interval."""
        M = self.M
        shape = (M.H, M.W) if self.dirs is None else self.dirs.shape[:2]
        img = np.full(shape, 35, np.uint8)
        return np.stack([img, img]) if self.stereo else img

    def generator_after(self, n: int) -> np.random.Generator:
        """A generator in the state the sequence's was in after frame n - 1."""
        rng = np.random.default_rng(self.seed)
        if n:
            rng.bit_generator.state = self.states[n - 1]
        return rng

    def _views(self, k: int):
        """Frame k's noise-free view(s) (None for a covered lens), its time,
        centre and depth: a function of k alone."""
        M = self.M
        kidnap = self.kidnap
        src = k if kidnap is None or k < kidnap[0] else kidnap[1] + k - kidnap[0]
        R_wc, p = M.pose_at(src / M.CAM_HZ)
        R_render = R_wc @ self.R_raw if self.raw else R_wc
        covered = self.covered(k)
        views = [None if covered else M.render(self.tex, R_render, p, dirs=self.dirs)]
        if self.stereo:
            p_r = p + R_wc @ np.array([self.baseline, 0.0, 0.0])
            views.append(None if covered else M.render(self.tex, R_render, p_r, dirs=self.dirs_r))
        return views, k / M.CAM_HZ, p, ray_depth(M, R_wc, p) if self.depth else None

    def _noisy(self, views: list, rng: np.random.Generator):
        """A frame's image(s) from its views, each drawing its noise from `rng`
        in turn (a covered lens's noise is drawn all the same)."""
        M = self.M
        shape = (M.H, M.W) if self.dirs is None else self.dirs.shape[:2]
        imgs = []
        for v in views:
            noise = rng.normal(0, 1.5, shape if v is None else v.shape)
            imgs.append(np.full(shape, 35, np.uint8) if v is None
                        else np.clip(v + noise, 0, 255).astype(np.uint8))
        return np.stack(imgs) if self.stereo else imgs[0]

    def _render(self, k: int, rng: np.random.Generator):
        """Frame k's image(s), drawing its noise from `rng` (in the state
        after frame k - 1), and its time, centre and depth."""
        views, t, p, depth = self._views(k)
        return self._noisy(views, rng), t, p, depth

    def extend(self, n_frames: int) -> None:
        """Render the frames up to n_frames - 1 that are not there yet. The
        noise-free views are ray-cast by RENDER_THREADS threads (numpy's
        array work releases the interpreter lock); the noise is drawn in
        frame order, so the frames are those of one thread."""
        for k in range(min(n_frames, len(self.imgs))):
            if self.imgs[k] is None:  # adopted from a sequence that covered it
                self.imgs[k] = self._render(k, self.generator_after(k))[0]
        if len(self.ts) >= n_frames:
            return
        rng = np.random.default_rng(self.seed)
        if self.tex is None:
            self.tex = self.M.make_textures(rng)
        if self.states:
            rng.bit_generator.state = self.states[-1]
        ks = list(range(len(self.ts), n_frames))
        with ThreadPoolExecutor(RENDER_THREADS) as pool:
            for i in range(0, len(ks), 4 * RENDER_THREADS):  # a bounded number in flight
                for views, t, p, depth in pool.map(self._views, ks[i:i + 4 * RENDER_THREADS]):
                    self.imgs.append(self._noisy(views, rng))
                    if self.depth:
                        self.depths.append(depth)
                    self.ts.append(t)
                    self.centres.append(p)
                    self.states.append(rng.bit_generator.state)


def _configured(fisheye: bool = False, t_loop: float | None = None):
    """`synth_euroc()` with the globals its `main` sets: the `--fisheye`
    room and lap, and `T_LOOP` = t_loop when given."""
    M = synth_euroc()
    if fisheye:  # the script's --fisheye room and rig
        M.BOX_LO = np.array([-3.5, -3.5, 0.0])
        M.BOX_HI = np.array([3.5, 3.5, 3.0])
        M.TRAJ_R, M.TRAJ_Z, M.T_LOOP = 1.4, 1.3, 40.0
    if t_loop is not None:
        M.T_LOOP = float(t_loop)
    return M


def _imu_stream(M, rng: np.random.Generator, n_frames: int):
    """The IMU samples of `make_synth_euroc.py`'s main (its lines after the
    frames): t = j / 200 s over the frames' span, each sample's gyro noise
    drawn before its acc noise."""
    bias_g = np.array([0.002, -0.0015, 0.001])
    bias_a = np.array([0.02, 0.015, -0.01])
    sg = 1.7e-4 * np.sqrt(M.IMU_HZ)
    sa = 2.0e-3 * np.sqrt(M.IMU_HZ)
    n_imu = int(round((n_frames - 1) / M.CAM_HZ * M.IMU_HZ)) + 1
    t_imu, acc, gyro = [], [], []
    for j in range(n_imu):
        t = j / M.IMU_HZ
        g, a = M.imu_sample(t)
        gyro.append(g + bias_g + rng.normal(0, sg, 3))
        acc.append(a + bias_a + rng.normal(0, sa, 3))
        t_imu.append(t)
    return np.asarray(t_imu), np.asarray(acc), np.asarray(gyro)


def imu_batches(t_frames: np.ndarray, imu) -> list:
    """Per frame, the IMU samples (t, acc, gyro) with t at or before the
    frame's time and after the previous frame's batch (the cursor of
    `scripts/drive_slam_vi.py`)."""
    t_imu, acc, gyro = imu
    out, j = [], 0
    for t in t_frames:
        batch = []
        while j < len(t_imu) and t_imu[j] <= t:
            batch.append((float(t_imu[j]), acc[j], gyro[j]))
            j += 1
        out.append(batch)
    return out


START_NS = 1403636579763555584  # make_synth_euroc.py's --start-ns default


def write_euroc_sequence(out_dir: str, n_frames: int, seed: int = 0,
                         t_loop: float | None = None, imu: bool = False, stereo: bool = False,
                         fisheye: bool = False, depth: bool = False,
                         layout: str = "euroc") -> None:
    """`euroc_frames(n_frames, seed, t_loop, imu=imu, stereo=stereo,
    fisheye=fisheye, depth=depth)` written to `out_dir` with the settings
    text of `make_synth_euroc.py` for that mode: its `SETTINGS_YAML` (752x480,
    1000 features, 8 levels), with `stereo` plus its `--stereo` lines
    (`Camera.bf` = FX x 0.11, `ThDepth` 35), with `depth` plus those and
    `DepthMapFactor` 5000, with `fisheye` its `FE_SETTINGS_YAML` (the KB8 pair,
    `Camera2.*`, `Tlr`). `layout` picks the directory's format:

    - "euroc": the script's mav0 layout (`datasets.write_euroc`) at its
      timestamps (`START_NS` + t in ns): the images (and `cam1` for a pair,
      the TUM-VI layout of `--fisheye`), the ground truth at every frame (the
      script's `rot_to_quat_wxyz` of `pose_at`) and the IMU stream;
    - "kitti": `datasets.write_kitti` (`image_0/`, `image_1/` for a pair,
      `times.txt` at t = k / 20 s);
    - "tumrgbd" (with `depth`, which no other layout takes):
      `datasets.write_tum_rgbd`, the left images, the ray-cast depth at
      `DepthMapFactor` and `associations.txt`, at t = k / 20 s."""
    from orbslam3_tpu_torch.io import datasets

    if layout not in ("euroc", "kitti", "tumrgbd"):
        raise ValueError(f"layout {layout!r} is not euroc, kitti or tumrgbd")
    if depth != (layout == "tumrgbd"):
        raise ValueError("depth is written in the tumrgbd layout, and only there")
    out = euroc_frames(n_frames, seed=seed, t_loop=t_loop, imu=imu, stereo=stereo,
                       fisheye=fisheye, depth=depth)
    ts, imgs = out[0], out[1]
    pair = stereo or fisheye
    left, right = (imgs[:, 0], imgs[:, 1]) if pair else (imgs, None)
    M = _configured(fisheye, t_loop)
    settings = M.FE_SETTINGS_YAML if fisheye else M.SETTINGS_YAML
    if stereo or depth:
        settings += f"Camera.bf: {M.FX * M.BASELINE_M}\nThDepth: 35.0\n"
    if depth:
        settings += f"DepthMapFactor: {datasets.DEPTH_MAP_FACTOR}\n"
    if layout == "euroc":
        poses = [M.pose_at(t) for t in ts]
        quats = np.asarray([M.rot_to_quat_wxyz(R) for R, _ in poses])
        ns = [START_NS + int(round(t * 1e9)) for t in ts]
        imu_rows = None
        if imu:
            t_imu, acc, gyro = out[-1]
            imu_rows = ([START_NS + int(round(t * 1e9)) for t in t_imu], gyro, acc)
        datasets.write_euroc(out_dir, ns, left, settings, right=right, imu=imu_rows,
                             groundtruth=(np.asarray([p for _, p in poses]), quats))
        return
    if layout == "kitti":
        datasets.write_kitti(out_dir, ts, left, right=right)
    else:
        datasets.write_tum_rgbd(out_dir, ts, left, out[3])
    with open(os.path.join(out_dir, "settings.yaml"), "w") as f:
        f.write(settings)


def ray_depth(M, R_wc: np.ndarray, p: np.ndarray) -> np.ndarray:
    """(480, 752) float32 z-depth of the pinhole camera at (R_wc, p) in the
    synthetic room: the nearest hit of each pixel's ray (z = 1) on the box's
    faces, which is the parameter `best_t` of `M.render`'s ray cast. `M` is
    the loaded script (`synth_euroc()`), for its room and camera."""
    u, v = np.meshgrid(np.arange(M.W, dtype=np.float32), np.arange(M.H, dtype=np.float32))
    d_w = np.stack([(u - M.CX) / M.FX, (v - M.CY) / M.FY, np.ones_like(u)], axis=-1) @ R_wc.T
    o = p.astype(np.float32)
    best = np.full((M.H, M.W), np.inf, np.float32)
    for ax, hi in M.FACES:
        bound = (M.BOX_HI if hi else M.BOX_LO)[ax]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (bound - o[ax]) / d_w[..., ax]
        best = np.where((t > 1e-3) & np.isfinite(t) & (t < best), t, best)
    return best.astype(np.float32)


class RectifySide(NamedTuple):
    """One camera's rectification block (the reference's LEFT./RIGHT. K/D/R/P
    settings), as `ops/rectify.StereoRectifier` takes it."""

    K: np.ndarray
    D: np.ndarray
    R: np.ndarray
    P: np.ndarray
    width: int
    height: int


def raw_stereo_rig():
    """(left, right) `RectifySide`s of `euroc_frames(..., raw=True)`: the
    script's `raw_stereo_yaml` blocks (its K, RAW_DIST, the 2-degree R, and
    the two P with the right's -FX * 0.11 translation)."""
    M = synth_euroc()
    c, s = np.cos(np.radians(M.RAW_PITCH_DEG)), np.sin(np.radians(M.RAW_PITCH_DEG))
    R = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
    K = np.array([[M.FX, 0.0, M.CX], [0.0, M.FY, M.CY], [0.0, 0.0, 1.0]])
    return tuple(
        RectifySide(K=K, D=np.asarray(M.RAW_DIST), R=R,
                    P=np.array([[M.FX, 0.0, M.CX, pr3], [0.0, M.FY, M.CY, 0.0],
                                [0.0, 0.0, 1.0, 0.0]]), width=M.W, height=M.H)
        for pr3 in (0.0, -M.FX * M.BASELINE_M))


IMU_STAGE_KEYS = ("init", "init_kfs", "viba1", "viba1_kfs", "viba2", "viba2_kfs")


class ReplayResult(NamedTuple):
    """One replay; the per-frame lists have one entry per frame."""

    ts: np.ndarray  # (N,) timestamps of the logged trajectory
    pos: np.ndarray  # (N, 3) its camera centres (map frame)
    gt_ts: np.ndarray  # (n_frames,)
    gt_pos: np.ndarray  # (n_frames, 3) rendered camera centres
    states: list  # TrackState name after each frame
    keyframe: list  # whether the frame inserted a keyframe (its mapping pass ran)
    ms: list  # host-clock ms of each frame's `track_*` call, the device drained after it
    syncs: list  # host synchronisations inside it (None off CUDA)
    b2: list  # kernel B2 launches inside it
    b1: list  # kernel B1 launches inside it
    gba_chunk: list  # whether a background GBA chunk ran after it
    n_kf: int
    n_mp: int
    ate: float  # Sim3-aligned ATE RMSE (m)
    ate_se3: float  # SE3-aligned (unscaled) ATE RMSE (m): stereo and RGB-D observe metric depth
    scale: float  # the Sim3 alignment's scale
    render_s: float
    # Place recognition (empty / 0 / None without a vocabulary):
    loops: list  # per closure: dict(kf, loop_kf, frame, ate_before, ate_after)
    gba_finished: int  # background GBA runs folded into the map
    gba_aborted: int
    lost: list  # frames after `kidnap[0]` that ended not OK
    relocalized: int | None  # the first OK frame after a not-OK one since the kidnap
    system: object  # the System after the last frame
    # Inertial ("mono_vi"; None / False / empty otherwise):
    imu_init_frame: int | None = None  # the frame whose mapping pass initialized the IMU
    imu_init_kfs: int | None = None  # keyframe count of the map at that moment
    viba1: int | None = None  # the frame of VIBA1
    viba2: int | None = None  # the frame of VIBA2
    pi_taken: list = []  # per frame: whether the pose-inertial result was taken
    inertial_ms: dict = {}  # per inertial call: list of (frame, host ms, device ms)
    imu_maps: list = []  # per map, in the order they started: dict(first_frame, and the frame
    #                      and keyframe count of its IMU initialization, VIBA1 and VIBA2 under
    #                      IMU_STAGE_KEYS, None where the stage did not run)
    # Multi-map (`multimap=True`; empty otherwise):
    n_maps: list = []  # per frame: the Atlas's map count after it
    stored: list = []  # per stored map: dict(frame, n_kf of the map stored)
    merges: list = []  # per merge: dict(frame, kf, cand, R, t, s (the world Sim3), n_kf_active
    #                    (the merged map's keyframes), n_kf (the target's after it)); inertial
    #                    sensors add imu_metric (the scale and yaw gate applied), log_R (so3
    #                    log of the gated R), weld ("inertial" or "visual" BA), weld_window,
    #                    dof4 (the essential graph's)
    multimap_ms: dict = {}  # per span ("try merge", "merge: ..."): list of (frame, host ms,
    #                         device ms)
    # Distributed (`distributed=True`; empty otherwise):
    collectives: list = []  # per frame: (collectives over the group, their host ms); each
    #                         is a host wait that `syncs` does not count

    def frame_kinds(self) -> list:
        """Each frame's kind: "init" (before the first OK), "lost" (not OK),
        "reloc" (OK after a not-OK frame), "keyframe", "gba" (a GBA chunk
        ran after it) or "tracked"."""
        kinds, seen_ok = [], False
        for k, state in enumerate(self.states):
            if not seen_ok:
                kind = "init"
            elif state != "OK":
                kind = "lost"
            elif self.states[k - 1] != "OK":
                kind = "reloc"
            elif self.keyframe[k]:
                kind = "keyframe"
            elif self.gba_chunk[k]:
                kind = "gba"
            else:
                kind = "tracked"
            seen_ok |= state == "OK"
            kinds.append(kind)
        return kinds


SENSORS = ("mono", "stereo", "rgbd", "raw_stereo", "mono_vi", "stereo_vi", "stereo_vi_fisheye")
INERTIAL_SENSORS = ("mono_vi", "stereo_vi", "stereo_vi_fisheye")


def vi_calib(device, cfg: dict = EUROC_MONO_VI):
    """The `ImuCalib` of an inertial config (`EUROC_MONO_VI` by default) on
    `device`."""
    from orbslam3_tpu_torch.ops.imu import ImuCalib

    Tbc = cfg["Tbc"]
    return ImuCalib.create(Tbc[:3, :3], Tbc[:3, 3], **cfg["imu"], device=device)


def make_system(device, sensor: str, orb: feat.OrbParams = EUROC_MONO["orb"],
                Kmax: int | None = None, Pmax: int | None = None):
    """The `System` that `replay` drives for `sensor` (one of `SENSORS`) on
    `device`: its config's camera, bf, rig, IMU calibration and capacities
    (Kmax, Pmax unless given); "raw_stereo" with `raw_stereo_rig()`'s
    rectification."""
    from orbslam3_tpu_torch.system import Sensor, System

    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r} is not one of {SENSORS}")
    dev = torch.device(device)
    cfg = {"mono": EUROC_MONO, "mono_vi": EUROC_MONO_VI, "stereo_vi": EUROC_STEREO_VI,
           "stereo_vi_fisheye": EUROC_STEREO_VI_FISHEYE}.get(sensor, EUROC_STEREO)
    kind = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD, "mono_vi": Sensor.IMU_MONOCULAR,
            "stereo_vi": Sensor.IMU_STEREO,
            "stereo_vi_fisheye": Sensor.IMU_STEREO}.get(sensor, Sensor.STEREO)
    slam = System(kind, cam.CameraModel.KB8 if sensor == "stereo_vi_fisheye"
                  else cam.CameraModel.PINHOLE, cfg["camera"], cfg["img_wh"], orb, device=dev,
                  bf=cfg.get("bf", 0.0), camera2=cfg.get("camera2"), Kmax=Kmax or cfg["Kmax"],
                  Pmax=Pmax or cfg["Pmax"], fps=cfg["fps"],
                  imu_calib=vi_calib(dev, cfg) if sensor in INERTIAL_SENSORS else None)
    if sensor == "raw_stereo":
        slam.enable_rectification(*raw_stereo_rig())
    return slam


class FrameRecord(NamedTuple):
    """What `record_frames` keeps of one `track_*` call, after it."""

    state: str  # TrackState name
    n_kf: int  # keyframe slots of the active map (a keyframe may take a freed one)
    keyframe: bool  # the frame inserted a keyframe
    R: np.ndarray  # the returned frame's Tcw
    t: np.ndarray
    imu_init: bool  # the IMU initialized (False without one)
    viba1: bool
    viba2: bool
    pi_taken: bool  # the frame took the pose-inertial result
    refined: bool = False  # a scale refinement moved the map in this call
    pred: np.ndarray | None = None  # the camera centre of the frame's IMU prediction
    centre: np.ndarray | None = None  # the tracked camera centre, before the call's tick
    loop: bool = False  # a loop correction completed in this call
    gba_done: bool = False  # a background global BA finished in this call

    def pred_err(self) -> float | None:
        """|IMU prediction - tracked camera centre| (m), where the frame had both."""
        if self.pred is None or self.centre is None:
            return None
        return float(np.linalg.norm(self.pred - self.centre))


def imu_stage_frames(rows: list) -> dict:
    """{stage: the frame whose call completed it} of `record_frames` rows:
    the IMU initialization, VIBA1, VIBA2 and each applied scale refinement
    ("refinement 1", ...). Under asynchronous mapping a stage completes in
    the tick after the frame's tracking, so the next frame is the first that
    starts from it."""
    out = {}
    for name in ("imu_init", "viba1", "viba2"):
        k = next((k for k, r in enumerate(rows) if getattr(r, name)), None)
        if k is not None:
            out[name] = k
    for i, k in enumerate(k for k, r in enumerate(rows) if r.refined):
        out[f"refinement {i + 1}"] = k
    return out


def map_event_frames(rows: list) -> dict:
    """{event: the frame whose call completed it} of `record_frames` rows:
    each loop correction ("loop 1", ...) and each background global BA's
    finish ("GBA 1", ...)."""
    out = {f"loop {i + 1}": k for i, k in enumerate(k for k, r in enumerate(rows) if r.loop)}
    out.update({f"GBA {i + 1}": k
                for i, k in enumerate(k for k, r in enumerate(rows) if r.gba_done)})
    return out


def imu_prediction_errors(rows: list) -> dict:
    """Fault C20's numbers from `record_frames` rows: `stages`
    (`imu_stage_frames`) and `events` (`map_event_frames`); `after`, per
    stage and event, the distance (m) between the IMU prediction and the
    tracked camera centre on the frame after the call that completed it, the
    first frame to start from it (None past the last frame); and over the
    other frames after the IMU initialization that have both, their
    `median`, their count `n` and the three `largest` (frame, m)."""
    stages = imu_stage_frames(rows)
    events = map_event_frames(rows)
    marks = {**stages, **events}
    after = {k + 1 for k in marks.values()}
    init = stages.get("imu_init")
    rest = {k: r.pred_err() for k, r in enumerate(rows) if init is not None and k > init
            and k not in after and r.pred_err() is not None}
    return dict(stages=stages, events=events,
                after={name: rows[k + 1].pred_err() if k + 1 < len(rows) else None
                       for name, k in marks.items()},
                median=float(np.median(list(rest.values()))) if rest else None, n=len(rest),
                largest=sorted(rest.items(), key=lambda x: -x[1])[:3])


@contextlib.contextmanager
def record_frames():
    """Within the block, every `System.track_monocular` / `track_stereo` /
    `track_rgbd` call of any System appends its `FrameRecord` (numpy copies,
    host state only: no device read) to the list it yields. It watches a run
    from outside, the runner's as well as a direct drive. With an IMU it also
    keeps the frame's IMU prediction (the host copy `Tracker._imu_predict`
    fetched), the tracked camera centre before the frame's tick of background
    work (`System._tick_gba`) may move the map, and whether a scale
    refinement was applied. It notes whether the call completed a loop
    correction or a background global BA."""
    from orbslam3_tpu_torch.pipeline import inertial_support as isup
    from orbslam3_tpu_torch.pipeline.tracking import Tracker
    from orbslam3_tpu_torch.system import System

    rows, originals, seen = [], {}, {}

    def gba_finished(slam):
        g = None if slam.loop_closer is None else slam.loop_closer.gba_async
        return 0 if g is None else g.n_finished

    def recording(name):
        fn = originals[System, name] = getattr(System, name)

        def track(self, *args, **kw):
            seen.clear()
            loops, gbas = self.n_loops_closed, gba_finished(self)
            out = fn(self, *args, **kw)
            ini = self.mapper.imu_init
            rows.append(FrameRecord(self.tracking_state.name, self.n_keyframes,
                                    self.tracker.last_kf_frame_id == out.frame_id, np.array(out.R),
                                    np.array(out.t), bool(self.mapper.imu_initialized),
                                    bool(ini is not None and ini.viba1_done),
                                    bool(ini is not None and ini.viba2_done),
                                    bool(self.tracker.pi_taken), bool(seen.get("refined")),
                                    seen.get("pred"), seen.get("centre"),
                                    self.n_loops_closed > loops, gba_finished(self) > gbas))
            return out

        return track

    def tick(self):
        last = self.tracker.last_frame
        if self.tracker.imu_calib is not None and last is not None \
                and self.tracking_state.name == "OK":
            R, t = np.asarray(last.R, np.float64), np.asarray(last.t, np.float64)
            seen["centre"] = -R.T @ t
        return originals[System, "_tick_gba"](self)

    def imu_predict(self, last):
        out = originals[Tracker, "_imu_predict"](self, last)
        R, t = np.asarray(out[0], np.float64), np.asarray(out[1], np.float64)
        seen["pred"] = -R.T @ t
        return out

    def refine_scale(self, *args, **kw):
        ok = originals[isup.ImuInitializer, "refine_scale"](self, *args, **kw)
        seen["refined"] = seen.get("refined", False) or bool(ok)
        return ok

    for name in ("track_monocular", "track_stereo", "track_rgbd"):
        setattr(System, name, recording(name))
    for cls, name, fn in ((System, "_tick_gba", tick), (Tracker, "_imu_predict", imu_predict),
                          (isup.ImuInitializer, "refine_scale", refine_scale)):
        originals[cls, name] = getattr(cls, name)
        setattr(cls, name, fn)
    try:
        yield rows
    finally:
        for (cls, name), fn in originals.items():
            setattr(cls, name, fn)


RUNNER_MODES = ("mono", "mono-vi", "stereo", "stereo-vi", "rgbd")  # run_sequence's --mode


def drive_files(slam, mode: str, seq, imu=None) -> None:
    """Drive `slam` directly over a dataset directory's decoded files, as
    `run_sequence` would in `mode` (one of `RUNNER_MODES`): `seq` is the
    `datasets` loader's `ImageSequence` (left images, the right ones or the
    depth PNGs), `imu` its `load_euroc_imu` samples, fed per frame by
    `imu_batches`. A depth PNG is divided by `datasets.DEPTH_MAP_FACTOR`, the
    factor the writers use, not by the settings' (the runner reads those)."""
    from orbslam3_tpu_torch.io import datasets

    if mode not in RUNNER_MODES:
        raise ValueError(f"mode {mode!r} is not one of {RUNNER_MODES}")
    ts = np.asarray(seq.timestamps, np.float64)
    batches = (imu_batches(ts, (imu.timestamps, imu.acc, imu.gyro)) if imu is not None
               else [None] * len(ts))
    for k in range(len(ts)):
        t = float(ts[k])
        if mode in ("mono", "mono-vi"):
            slam.track_monocular(seq.read(k), t, imu_measurements=batches[k])
        elif mode in ("stereo", "stereo-vi"):
            slam.track_stereo(seq.read(k), seq.read_right(k), t, imu_measurements=batches[k])
        else:
            slam.track_rgbd(seq.read(k), seq.read_depth(k) / datasets.DEPTH_MAP_FACTOR, t)


def _rendered(sensor: str, n_frames: int, seed: int, t_loop, kidnap, blind=None):
    """`euroc_frames` for a replay of `sensor`."""
    return euroc_frames(n_frames, seed, t_loop=t_loop, kidnap=kidnap, blind=blind,
                        stereo=sensor in ("stereo", "stereo_vi"), raw=sensor == "raw_stereo",
                        depth=sensor == "rgbd", imu=sensor in INERTIAL_SENSORS,
                        fisheye=sensor == "stereo_vi_fisheye")


def mono_replay(device, n_frames: int, **kw) -> ReplayResult:
    """`replay(device, "mono", n_frames, ...)`."""
    return replay(device, "mono", n_frames, **kw)


def replay(device, sensor: str, n_frames: int, seed: int = 0,
           orb: feat.OrbParams = EUROC_MONO["orb"], vocabulary: str | None = None,
           t_loop: float | None = None, kidnap: tuple[int, int] | None = None,
           on_frame: Callable | None = None, n_track: int | None = None,
           multimap: bool = False, blind: tuple[int, int] | None = None,
           distributed: bool = False) -> ReplayResult:
    """Drive the `System` of `sensor` with ORB parameters `orb` over the
    first `n_frames` of the synthetic EuRoC sequence on `device` and score
    it against the rendered camera centres. `sensor` is one of `SENSORS`:
    "mono" (`track_monocular`), "stereo" (config 2, `track_stereo` on the
    rectified pair, bf = 50.38), "rgbd" (`track_rgbd` on the left image and
    its ray-cast depth, the same bf), "raw_stereo" (the unrectified pair
    through `enable_rectification` and `track_stereo`) or "mono_vi" (config
    3: `Sensor.IMU_MONOCULAR` with `EUROC_MONO_VI`'s calibration, each frame
    fed the 200 Hz samples with t at or before its time; the result then
    carries the frames of IMU initialization, VIBA1 and VIBA2, the frames
    whose pose-inertial result was taken, and the ms of each inertial call),
    "stereo_vi" (`Sensor.IMU_STEREO` on the rectified pair, `EUROC_STEREO_VI`)
    or "stereo_vi_fisheye" (config 4: `Sensor.IMU_STEREO` with
    `CameraModel.KB8` and the two-camera rig of `EUROC_STEREO_VI_FISHEYE` on
    the `--fisheye` pair). The inertial sensors also record the ms of the
    rig's calls (the fisheye match, the pose solves).
    On a CUDA device every frame runs with PyTorch's sync debug mode at
    "warn", and the synchronisations each frame makes are counted.

    With `vocabulary` (the path of a DBoW2 binary vocabulary) place
    recognition runs at the reference's defaults, and the ATE is read
    before and after each loop correction. `t_loop` and `kidnap` shape the
    sequence (`euroc_frames`); after the last frame a running background
    GBA is run to its end (`System.shutdown`). `on_frame(k, system)` is
    called after each frame. `n_track` tracks only the first frames of the
    `n_frames` rendered: "mono_vi"'s IMU noise is drawn after every image,
    so a shorter sequence has other IMU samples, and a prefix of a run is
    this.

    `multimap` (with a vocabulary) enables the Atlas after place recognition,
    as `scripts/run_sequence.py` does, and records per frame the map count,
    each stored map (its frame and keyframe count), each merge (its frame,
    keyframe pair, world Sim3) and the ms of each multi-map span: "try
    merge" on each keyframe frame of a map while another is stored, and
    `_do_merge`'s split ("merge: merge maps", "merge: weld fuse", "merge:
    weld BA", "merge: essential graph", "merge: GBA start"); with an
    inertial sensor, each map's IMU stages (`imu_maps`) and each merge's
    inertial facts (the gate, the weld's BA, the graph's DoF). `blind` =
    (at, n) covers the lens for n frames from frame `at` (`euroc_frames`);
    the ATEs are then over the other frames.

    `distributed` calls `System.enable_distributed()` on the world group of
    an initialized process group (BASELINE config 5, one SPMD replica per
    rank: `parallel/launch.py::replay`); the map's digests are compared
    across the ranks at every GBA start and after the last frame
    (`system.dist.replica_checks`), and each frame's collectives over the
    group are counted beside its syncs (`collectives`): the sync-debug
    warnings that count `syncs` do not see a collective's host wait."""
    from orbslam3_tpu_torch.ate import associate, umeyama
    from orbslam3_tpu_torch.io.vocab_io import load_binary_vocabulary
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match, lie
    from orbslam3_tpu_torch.parallel import comm

    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r} is not one of {SENSORS}")
    t0 = time.perf_counter()
    inertial = sensor in INERTIAL_SENSORS
    if multimap and vocabulary is None:
        raise ValueError("multimap needs a vocabulary")
    frames = _rendered(sensor, n_frames, seed, t_loop, kidnap, blind)
    gt_ts, imgs, gt_pos = frames[:3]
    seen = np.ones(n_frames, bool)  # the frames the ATE is scored on
    if blind is not None:
        seen[blind[0]:blind[0] + blind[1]] = False
    imu = imu_batches(gt_ts, frames[3]) if inertial else None
    render_s = time.perf_counter() - t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    slam = make_system(dev, sensor, orb)

    def track(k, t):
        if sensor == "mono":
            return slam.track_monocular(imgs[k], t)
        if sensor == "mono_vi":
            return slam.track_monocular(imgs[k], t, imu_measurements=imu[k])
        if sensor == "rgbd":
            return slam.track_rgbd(imgs[k], frames[3][k], t)
        return slam.track_stereo(imgs[k, 0], imgs[k, 1], t,
                                 imu_measurements=imu[k] if inertial else None)

    loops = []
    if vocabulary is not None:
        voc = load_binary_vocabulary(vocabulary, dev)
        slam.enable_place_recognition(voc)
        if multimap:
            slam.enable_multimap(voc)
        frame_no = [0]

        def on_correction(phase, kf_id, loop_kf):
            ts, pos = slam.get_trajectory()
            ate = ate_rmse(ts, pos, gt_ts[seen], gt_pos[seen], with_scale=True, max_dt=0.01)
            if phase == "before":
                loops.append(dict(kf=int(kf_id), loop_kf=int(loop_kf), frame=frame_no[0],
                                  ate_before=ate))
            else:
                loops[-1]["ate_after"] = ate

        slam.loop_closer.on_correction = on_correction
    if distributed:
        slam.enable_distributed()
    gba = slam.loop_closer.gba_async if slam.loop_closer is not None else None
    states, keyframe, ms, syncs, b2, b1, chunks = [], [], [], [], [], [], []
    vi_frames = dict(init=None, kfs=None, viba1=None, viba2=None)
    pi_taken, imu_maps = [], []
    n_maps, stored, merges, collectives = [], [], [], []
    mm = slam.multimap
    timer = spans.Recorder(cuda)
    with timer if inertial or multimap else contextlib.nullcontext():
        for k, t in enumerate(gt_ts[:n_track]):
            timer.frame = k
            if vocabulary is not None:
                frame_no[0] = k
            n2, n1 = cuda_fast.LAUNCHES, cuda_match.LAUNCHES
            nc, cms = comm.totals()
            n_chunks = gba.n_chunks if gba is not None else 0
            store0, merges0 = slam.store, mm.n_merges if mm is not None else 0
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.set_sync_debug_mode("warn")
            start = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                frame = track(k, float(t))
            if cuda:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - start) * 1e3)
            syncs.append(sum("synchroniz" in str(w.message) for w in caught) if cuda else None)
            if distributed:
                nc1, cms1 = comm.totals()
                collectives.append((nc1 - nc, cms1 - cms))
            states.append(slam.tracking_state.name)
            keyframe.append(slam.tracker.last_kf_frame_id == frame.frame_id)
            b2.append(cuda_fast.LAUNCHES - n2)
            b1.append(cuda_match.LAUNCHES - n1)
            chunks.append(gba is not None and gba.n_chunks > n_chunks)
            if mm is not None:
                if mm.atlas.n_maps > (n_maps[-1] if n_maps else 1) and store0 in mm.atlas.maps:
                    stored.append(dict(frame=k, n_kf=store0.n_kf))
                if mm.n_merges > merges0:
                    v = mm.last_verify
                    R, tw, sw = v["world"]
                    merges.append(dict(frame=k, kf=v["kf"], cand=v["cand"], R=R.tolist(),
                                       t=tw.tolist(), s=sw, n_kf_active=store0.n_kf,
                                       n_kf=slam.store.n_kf))
                    if inertial:
                        merges[-1].update(
                            imu_metric=v["imu_metric"], weld=mm.last_weld["ba"],
                            weld_window=mm.last_weld["window"], dof4=mm.last_weld["dof4"],
                            log_R=lie.log_so3(torch.from_numpy(np.asarray(R, np.float32)))
                            .tolist())
                n_maps.append(mm.atlas.n_maps)
            if inertial:
                pi_taken.append(slam.tracker.pi_taken)
                ini = slam.mapper.imu_init
                if vi_frames["init"] is None and ini.initialized:
                    vi_frames.update(init=k, kfs=slam.store.n_kf)
                if vi_frames["viba1"] is None and ini.viba1_done:
                    vi_frames["viba1"] = k
                if vi_frames["viba2"] is None and ini.viba2_done:
                    vi_frames["viba2"] = k
                if not imu_maps or imu_maps[-1][0] is not ini:  # a new map's initializer
                    imu_maps.append((ini, dict(first_frame=k, **dict.fromkeys(IMU_STAGE_KEYS))))
                m = imu_maps[-1][1]
                for key, done in (("init", ini.initialized), ("viba1", ini.viba1_done),
                                  ("viba2", ini.viba2_done)):
                    if m[key] is None and done:
                        m[key], m[key + "_kfs"] = k, slam.store.n_kf
            if on_frame is not None:
                on_frame(k, slam)
    slam.shutdown()
    if distributed:
        slam.dist.check_replicas(slam.store, "end")
    ts, pos = slam.get_trajectory()
    gt_ts_s, gt_pos_s = gt_ts[seen], gt_pos[seen]
    ate = ate_rmse(ts, pos, gt_ts_s, gt_pos_s, with_scale=True, max_dt=0.01)
    ia, ib = associate(ts, gt_ts_s, 0.01)
    scale = (float(umeyama(pos[ia], gt_pos_s[ib], with_scale=True)[0]) if len(ia) >= 3
             else float("nan"))
    lost, reloc = [], None
    if kidnap is not None:
        lost = [k for k in range(kidnap[0], n_frames) if states[k] != "OK"]
        reloc = next((k for k in range(kidnap[0] + 1, n_frames)
                      if states[k] == "OK" and states[k - 1] != "OK"), None)
    return ReplayResult(ts=ts, pos=pos, gt_ts=gt_ts, gt_pos=gt_pos, states=states,
                        keyframe=keyframe, ms=ms, syncs=syncs, b2=b2, b1=b1, gba_chunk=chunks,
                        n_kf=slam.n_keyframes, n_mp=slam.n_map_points, ate=ate,
                        ate_se3=ate_rmse(ts, pos, gt_ts_s, gt_pos_s, with_scale=False,
                                         max_dt=0.01),
                        scale=scale, render_s=render_s, loops=loops,
                        gba_finished=gba.n_finished if gba is not None else 0,
                        gba_aborted=gba.n_aborted if gba is not None else 0,
                        lost=lost, relocalized=reloc, system=slam,
                        imu_init_frame=vi_frames["init"], imu_init_kfs=vi_frames["kfs"],
                        viba1=vi_frames["viba1"], viba2=vi_frames["viba2"], pi_taken=pi_taken,
                        inertial_ms=timer.result() if inertial else {},
                        imu_maps=[m for _, m in imu_maps], n_maps=n_maps,
                        stored=stored, merges=merges,
                        multimap_ms=timer.result() if multimap else {}, collectives=collectives)


# The production GBA problem of `__graft_entry__.py::dryrun_multichip`:
# C keyframes on a line, P points, obs_per_cam observations a keyframe.
DRYRUN_SHAPE = dict(C=128, P=16384, obs_per_cam=512, iters=3, pcg_iters=20)


def dryrun_problem(device, C: int = 128, P: int = 16384, obs_per_cam: int = 512):
    """(BAProblem, camera params) of the reference's `dryrun_multichip` at
    its shapes, drawn from `default_rng(0)` in its order: identity rotations,
    centres along x, two fixed keyframes, each keyframe observing
    `obs_per_cam` distinct random points (0.5 px noise), the poses moved by
    1 cm and the points by 2 cm."""
    from orbslam3_tpu_torch.optim import ba as ba_mod

    rng = np.random.default_rng(0)
    params = cam.make_pinhole(458.654, 457.296, 376.0, 240.0)
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-3, 3, P), rng.uniform(4, 12, P)],
                   -1).astype(np.float32)
    cam_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    cam_t = np.zeros((C, 3), np.float32)
    cam_t[:, 0] = np.linspace(0, 1.5, C)
    obs_cam = np.repeat(np.arange(C, dtype=np.int32), obs_per_cam)
    obs_pt = np.concatenate([rng.choice(P, obs_per_cam, replace=False)
                             for _ in range(C)]).astype(np.int32)
    Xc = pts[obs_pt] + cam_t[obs_cam]
    uv = cam.pinhole_project(params, torch.from_numpy(Xc)).numpy()
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    O = len(obs_cam)
    T = functools.partial(convert.tensor, device=device)
    prob = ba_mod.BAProblem(
        cam_R=T(cam_R), cam_t=T(cam_t + rng.normal(0, 0.01, cam_t.shape).astype(np.float32)),
        cam_fixed=T(np.arange(C) < 2),
        points=T(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)),
        point_valid=T(np.ones(P, bool)), obs_cam=T(obs_cam), obs_point=T(obs_pt), obs_uv=T(uv),
        obs_ur=T(np.full(O, -1.0, np.float32)), obs_sigma2=T(np.ones(O, np.float32)),
        obs_valid=T(np.ones(O, bool)))
    return prob, params.to(device)


def _timed_solve(device, fn):
    """(result, ms, peak bytes above what was allocated before; None off CUDA)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    res = fn()
    if cuda:
        torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(device) - base if cuda else None
    return res, ms, peak


def dryrun_rank(rank: int, n: int, device, shape: dict) -> dict:
    """One rank of `dryrun_multichip`: both layouts over the world group,
    each with its result, ms, collectives (timed with the device drained) and
    peak memory."""
    from orbslam3_tpu_torch.parallel import ba_sharded, comm

    prob, params = dryrun_problem(device, shape["C"], shape["P"], shape["obs_per_cam"])
    kw = dict(iters=shape["iters"], pcg_iters=shape["pcg_iters"])
    out = {}
    for layout, solve in (("obs", ba_sharded.solve_ba_sharded),
                          ("point", ba_sharded.solve_ba_point_sharded)):
        comm.reset_stats()
        with comm.sync_timing():
            res, ms, peak = _timed_solve(device, lambda: solve(cam.CameraModel.PINHOLE, params,
                                                               prob, **kw))
        out[layout] = dict(res=res._asdict(), ms=ms, peak=peak, collectives=comm.stats_copy())
    return out


def dryrun_multichip(n: int, device=None, timeout: float = 300.0, **shape) -> dict:
    """The sharded bundle adjustment at the production GBA shape
    (`DRYRUN_SHAPE`: C = 128 keyframes, P = 16384 points, 512 observations a
    keyframe, 3 LM iterations, 20 CG steps; keywords override it) on `n`
    ranks (`parallel/launch.py`, on the card unless `device` says otherwise)
    in both layouts: observations sharded (the PCG path, one all-reduce per
    CG product) and the point axis block-partitioned (the dense Schur path,
    one all-reduce per LM iteration). Each is held against the same solve
    on one device here: poses within 2e-3, the points that 4 or more
    keyframes observe within 5e-3, fewer than 2% of `obs_inlier` flipped, the
    cost finite and within 5% (or 1.0); every rank's result equal. A point
    seen from two neighbouring keyframes (1.2 cm apart, 4-12 m away) has
    almost no depth: float32 sums in another order move it by up to 1e-2
    after 3 iterations (in float64 the layouts agree with the single solve
    to 1e-10), so the largest difference over every point is returned, not
    gated. Returns the numbers (ms, ms per LM iteration, collectives per
    solve with bytes and ms, peak memory); raises AssertionError where a gate
    fails."""
    from orbslam3_tpu_torch.device import require_cuda
    from orbslam3_tpu_torch.optim import ba as ba_mod
    from orbslam3_tpu_torch.parallel import launch

    dev = require_cuda() if device is None else torch.device(device)
    shape = {**DRYRUN_SHAPE, **shape}
    ranks = launch.run(dryrun_rank, n, (shape,), device=dev, timeout=timeout)
    prob, params = dryrun_problem(dev, shape["C"], shape["P"], shape["obs_per_cam"])
    well = np.bincount(prob.obs_point.cpu().numpy(), minlength=shape["P"]) >= 4
    out = dict(shape=shape, n=n)
    for layout, dense in (("obs", False), ("point", True)):
        ref, ms, peak = _timed_solve(dev, lambda: ba_mod.solve_ba(
            cam.CameraModel.PINHOLE, params, prob, iters=shape["iters"],
            pcg_iters=shape["pcg_iters"], dense_schur=dense))
        ref = convert.to_numpy(ref)
        r0 = ranks[0][layout]
        got = r0["res"]
        d_pose = max(float(np.abs(got[k] - getattr(ref, k)).max()) for k in ("cam_R", "cam_t"))
        d_all = np.abs(got["points"] - ref.points).max(axis=1)
        d_pts = float(d_all[well].max())
        flips = float(np.mean(got["obs_inlier"] != ref.obs_inlier))
        d_cost = abs(float(got["cost"]) - float(ref.cost))
        same_ranks = all(np.array_equal(r[layout]["res"][k], got[k])
                         for r in ranks for k in ("cam_R", "cam_t", "points", "cost"))
        out[layout] = dict(
            ms=[r[layout]["ms"] for r in ranks], ms_per_iter=[r[layout]["ms"] / shape["iters"]
                                                              for r in ranks],
            single_ms=ms, single_ms_per_iter=ms / shape["iters"], cost=float(got["cost"]),
            single_cost=float(ref.cost), d_pose=d_pose, d_points=d_pts,
            d_points_all=float(d_all.max()), inlier_flips=flips,
            d_cost=d_cost, same_ranks=same_ranks, collectives=r0["collectives"],
            peak=[r[layout]["peak"] for r in ranks], single_peak=peak)
        for ok, what in ((np.isfinite(float(got["cost"])), f"cost {got['cost']}"),
                         (d_pose <= 2e-3, f"poses {d_pose}"), (d_pts <= 5e-3, f"points {d_pts}"),
                         (flips < 0.02, f"inliers flipped {flips}"),
                         (d_cost <= max(0.05 * abs(float(ref.cost)), 1.0),
                          f"cost {float(got['cost'])} against {float(ref.cost)}"),
                         (same_ranks, "the ranks' results differ")):
            if not ok:
                raise AssertionError(f"dryrun_multichip {layout}: {what}")
    return out
