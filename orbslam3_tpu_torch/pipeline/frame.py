"""The per-frame container `FrameData` and the frustum and scale
prediction over the whole map-point array — the port of
`orbslam3_tpu/pipeline/frame.py` (`Frame`, `Frame::isInFrustum`,
`MapPoint::PredictScale`, `ORBmatcher::RadiusByViewingCos`)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from orbslam3_tpu_torch.ops import cameras as cam
from orbslam3_tpu_torch.ops import features as feat
from orbslam3_tpu_torch.ops import lie


@dataclass
class FrameData:
    """One processed frame: its features stay on the device; the pose and
    the associations are host numpy, as the control logic reads them."""

    features: feat.Features
    timestamp: float
    frame_id: int
    R: np.ndarray  # (3,3) Tcw estimate
    t: np.ndarray  # (3,)
    mp_assoc: np.ndarray  # (Nf,) int32 map-point id per feature (-1 none)

    @property
    def n_features(self) -> int:
        """Valid keypoints (a host read: the initializer's gate only)."""
        return int(self.features.valid.sum())


def frustum_and_scale(model: cam.CameraModel, params: torch.Tensor, R: torch.Tensor,
                      t: torch.Tensor, mp_pos, mp_valid, mp_normal, mp_min_dist,
                      mp_max_dist, img_wh: torch.Tensor, scale_factor: float = 1.2,
                      n_levels: int = 8, view_cos_limit: float = 0.5):
    """Returns (uv (P,2), visible (P,), pred_octave (P,) int32, view_cos (P,)).

    The predicted octave is ceil(log(max_dist/dist) / log(scale)); a point
    whose quotient lands within a rounding error of an integer can take the
    other octave than in the reference (the parity tests count these)."""
    Xc = lie.se3_apply(R, t, mp_pos)
    z = Xc[..., 2]
    uv = cam.project(model, params, Xc)
    Rwc = R.transpose(-1, -2)
    Ow = -Rwc @ t
    PO = mp_pos - Ow[None, :]
    dist = torch.linalg.norm(PO, dim=-1)
    view_cos = torch.sum(PO * mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0]) & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    in_depth = (dist >= mp_min_dist * 0.8) & (dist <= mp_max_dist * 1.2)
    visible = mp_valid & (z > 0.1) & in_img & in_depth & (view_cos > view_cos_limit)
    ratio = torch.clamp(mp_max_dist, min=1e-9) / torch.clamp(dist, min=1e-9)
    lvl = torch.ceil(torch.log(ratio) / math.log(scale_factor)).to(torch.int32)
    lvl = torch.clamp(lvl, 0, n_levels - 1)
    return uv, visible, lvl, view_cos


def search_radius(view_cos: torch.Tensor, pred_octave: torch.Tensor, scale_factor: float = 1.2):
    """2.5 px if view_cos > 0.998 else 4.0 px, scaled by the predicted octave."""
    base = torch.where(view_cos > 0.998, 2.5, 4.0)
    return base * scale_factor ** pred_octave.to(torch.float32)
