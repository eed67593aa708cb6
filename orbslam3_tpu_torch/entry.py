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
lap and a kidnap (earlier images at later timestamps). The inertial sensors
add the script's 200 Hz IMU stream: monocular-inertial (config 3),
stereo-inertial on the rectified pair, and config 4, the stereo-inertial
two-camera fisheye rig of `make_synth_euroc.py --fisheye` (512x512
Kannala-Brandt 8 cameras 0.15 m apart in a smaller room).

Scenes are built with numpy from a seed (`make_scene`, `make_mapping_scene`
draw from the generator in the reference's order), so a test can hand the
same map to the JAX package and to the port.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import time
import warnings
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
                 fisheye: bool = False):
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
    its path, timestamps increasing), and its centre is that frame's."""
    M = synth_euroc()
    R_raw, dirs, dirs_r, baseline = np.eye(3), None, None, M.BASELINE_M
    if fisheye:  # the script's --fisheye room and rig
        stereo = True
        M.BOX_LO = np.array([-3.5, -3.5, 0.0])
        M.BOX_HI = np.array([3.5, 3.5, 3.0])
        M.TRAJ_R, M.TRAJ_Z, M.T_LOOP = 1.4, 1.3, 40.0
        dirs = M.kb8_dir_grid((M.FE_W, M.FE_H), M.FE_INTR_L)
        dirs_r = M.kb8_dir_grid((M.FE_W, M.FE_H), M.FE_INTR_R)
        baseline = M.FE_BASELINE_M
    if t_loop is not None:
        M.T_LOOP = float(t_loop)
    rng = np.random.default_rng(seed)
    tex = M.make_textures(rng)
    if raw:
        stereo = True
        c, s = np.cos(np.radians(M.RAW_PITCH_DEG)), np.sin(np.radians(M.RAW_PITCH_DEG))
        R_raw = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        dirs = dirs_r = M.radtan_dir_grid((M.W, M.H), (M.FX, M.FY, M.CX, M.CY), M.RAW_DIST)

    def noisy(img):
        return np.clip(img + rng.normal(0, 1.5, img.shape), 0, 255).astype(np.uint8)

    ts, imgs, centres, depths = [], [], [], []
    for k in range(n_frames):
        t = k / M.CAM_HZ
        src = k if kidnap is None or k < kidnap[0] else kidnap[1] + k - kidnap[0]
        R_wc, p = M.pose_at(src / M.CAM_HZ)
        R_render = R_wc @ R_raw if raw else R_wc
        img = noisy(M.render(tex, R_render, p, dirs=dirs))
        if stereo:
            p_r = p + R_wc @ np.array([baseline, 0.0, 0.0])
            img = np.stack([img, noisy(M.render(tex, R_render, p_r, dirs=dirs_r))])
        imgs.append(img)
        if depth:
            depths.append(ray_depth(M, R_wc, p))
        ts.append(t)
        centres.append(p)
    out = (np.asarray(ts), np.stack(imgs), np.asarray(centres))
    if depth:
        out += (np.stack(depths),)
    if imu:
        out += (_imu_stream(M, rng, n_frames),)
    return out


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


@functools.lru_cache(maxsize=1)
def _rendered(sensor: str, n_frames: int, seed: int, t_loop, kidnap):
    """`euroc_frames` for a replay of `sensor`; the last sequence is kept, so
    a replay of a prefix of the same sequence (`n_track`, the plain run
    after the kernels' one) does not render it again."""
    return euroc_frames(n_frames, seed, t_loop=t_loop, kidnap=kidnap,
                        stereo=sensor in ("stereo", "stereo_vi"), raw=sensor == "raw_stereo",
                        depth=sensor == "rgbd", imu=sensor in INERTIAL_SENSORS,
                        fisheye=sensor == "stereo_vi_fisheye")


def mono_replay(device, n_frames: int, **kw) -> ReplayResult:
    """`replay(device, "mono", n_frames, ...)`."""
    return replay(device, "mono", n_frames, **kw)


def replay(device, sensor: str, n_frames: int, seed: int = 0,
           orb: feat.OrbParams = EUROC_MONO["orb"], vocabulary: str | None = None,
           t_loop: float | None = None, kidnap: tuple[int, int] | None = None,
           on_frame: Callable | None = None, n_track: int | None = None) -> ReplayResult:
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
    this."""
    from orbslam3_tpu_torch.ate import associate, umeyama
    from orbslam3_tpu_torch.io.vocab_io import load_binary_vocabulary
    from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
    from orbslam3_tpu_torch.system import Sensor, System

    if sensor not in SENSORS:
        raise ValueError(f"sensor {sensor!r} is not one of {SENSORS}")
    t0 = time.perf_counter()
    inertial = sensor in INERTIAL_SENSORS
    fisheye = sensor == "stereo_vi_fisheye"
    frames = _rendered(sensor, n_frames, seed, t_loop, kidnap)
    gt_ts, imgs, gt_pos = frames[:3]
    imu = imu_batches(gt_ts, frames[3]) if inertial else None
    render_s = time.perf_counter() - t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cfg = {"mono": EUROC_MONO, "mono_vi": EUROC_MONO_VI, "stereo_vi": EUROC_STEREO_VI,
           "stereo_vi_fisheye": EUROC_STEREO_VI_FISHEYE}.get(sensor, EUROC_STEREO)
    kind = {"mono": Sensor.MONOCULAR, "rgbd": Sensor.RGBD, "mono_vi": Sensor.IMU_MONOCULAR,
            "stereo_vi": Sensor.IMU_STEREO,
            "stereo_vi_fisheye": Sensor.IMU_STEREO}.get(sensor, Sensor.STEREO)
    slam = System(kind, cam.CameraModel.KB8 if fisheye else cam.CameraModel.PINHOLE,
                  cfg["camera"], cfg["img_wh"], orb, device=dev, bf=cfg.get("bf", 0.0),
                  camera2=cfg.get("camera2"), Kmax=cfg["Kmax"], Pmax=cfg["Pmax"],
                  fps=cfg["fps"], imu_calib=vi_calib(dev, cfg) if inertial else None)
    if sensor == "raw_stereo":
        slam.enable_rectification(*raw_stereo_rig())

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
        slam.enable_place_recognition(load_binary_vocabulary(vocabulary, dev))
        frame_no = [0]

        def on_correction(phase, kf_id, loop_kf):
            ts, pos = slam.get_trajectory()
            ate = ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
            if phase == "before":
                loops.append(dict(kf=int(kf_id), loop_kf=int(loop_kf), frame=frame_no[0],
                                  ate_before=ate))
            else:
                loops[-1]["ate_after"] = ate

        slam.loop_closer.on_correction = on_correction
    gba = slam.loop_closer.gba_async if slam.loop_closer is not None else None
    states, keyframe, ms, syncs, b2, b1, chunks = [], [], [], [], [], [], []
    vi_frames = dict(init=None, kfs=None, viba1=None, viba2=None)
    pi_taken = []
    timer = spans.Recorder(cuda)
    with timer if inertial else contextlib.nullcontext():
        for k, t in enumerate(gt_ts[:n_track]):
            timer.frame = k
            if vocabulary is not None:
                frame_no[0] = k
            n2, n1 = cuda_fast.LAUNCHES, cuda_match.LAUNCHES
            n_chunks = gba.n_chunks if gba is not None else 0
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
            states.append(slam.tracking_state.name)
            keyframe.append(slam.tracker.last_kf_frame_id == frame.frame_id)
            b2.append(cuda_fast.LAUNCHES - n2)
            b1.append(cuda_match.LAUNCHES - n1)
            chunks.append(gba is not None and gba.n_chunks > n_chunks)
            if inertial:
                pi_taken.append(slam.tracker.pi_taken)
                ini = slam.mapper.imu_init
                if vi_frames["init"] is None and ini.initialized:
                    vi_frames.update(init=k, kfs=slam.store.n_kf)
                if vi_frames["viba1"] is None and ini.viba1_done:
                    vi_frames["viba1"] = k
                if vi_frames["viba2"] is None and ini.viba2_done:
                    vi_frames["viba2"] = k
            if on_frame is not None:
                on_frame(k, slam)
    slam.shutdown()
    ts, pos = slam.get_trajectory()
    ate = ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=True, max_dt=0.01)
    ia, ib = associate(ts, gt_ts, 0.01)
    scale = (float(umeyama(pos[ia], gt_pos[ib], with_scale=True)[0]) if len(ia) >= 3
             else float("nan"))
    lost, reloc = [], None
    if kidnap is not None:
        lost = [k for k in range(kidnap[0], n_frames) if states[k] != "OK"]
        reloc = next((k for k in range(kidnap[0] + 1, n_frames)
                      if states[k] == "OK" and states[k - 1] != "OK"), None)
    return ReplayResult(ts=ts, pos=pos, gt_ts=gt_ts, gt_pos=gt_pos, states=states,
                        keyframe=keyframe, ms=ms, syncs=syncs, b2=b2, b1=b1, gba_chunk=chunks,
                        n_kf=slam.n_keyframes, n_mp=slam.n_map_points, ate=ate,
                        ate_se3=ate_rmse(ts, pos, gt_ts, gt_pos, with_scale=False, max_dt=0.01),
                        scale=scale, render_s=render_s, loops=loops,
                        gba_finished=gba.n_finished if gba is not None else 0,
                        gba_aborted=gba.n_aborted if gba is not None else 0,
                        lost=lost, relocalized=reloc, system=slam,
                        imu_init_frame=vi_frames["init"], imu_init_kfs=vi_frames["kfs"],
                        viba1=vi_frames["viba1"], viba2=vi_frames["viba2"], pi_taken=pi_taken,
                        inertial_ms=timer.result() if inertial else {})
