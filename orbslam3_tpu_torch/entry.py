"""Entry points of the port's tracking slice — the counterparts of
`__graft_entry__.py::entry` and `::staged_pipeline`, at the same EuRoC
shapes by default: 752x480 image, 8 levels, 1024 features, Kmax 64 keyframes,
Pmax 16384 map points, an 8192-point local mask and 600 keypoints of the
frame back-projected into the map, so the motion-model stage tracks.

`staged_pipeline(device)` is the slice's normal entry point: extraction,
then `_track_step` with the cached `compute_obs_count`, then one fetch of
the decision bundle. The scene is built with numpy from a seed (`make_scene`
draws from the generator in the reference's order), so a test can hand the
same map to the JAX package and to the port.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st
from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
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
               n_mp=12288) -> st.MapState:
    """numpy MapState: n_mp random points over n_kf keyframes on a forward
    trajectory; the reference's `_synth_map` (consistent=False), same draws."""
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
    kf_t = np.zeros((Kmax, 3), np.float32)
    kf_t[:n_kf, 0] = np.linspace(0, 2.0, n_kf)
    kf_valid = np.zeros(Kmax, bool)
    kf_valid[:n_kf] = True
    kf_mp = np.full((Kmax, Nf), -1, np.int32)
    for k in range(n_kf):
        ids = rng.choice(n_mp, size=min(Nf, 600), replace=False)
        kf_mp[k, : len(ids)] = ids
    pad = Pmax - n_mp
    return s._replace(
        kf_R=np.tile(np.eye(3, dtype=np.float32), (Kmax, 1, 1)), kf_t=kf_t,
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
