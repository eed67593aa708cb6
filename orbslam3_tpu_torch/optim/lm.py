"""Robust-kernel constants and weights shared by the port's solvers — the
slice's subset of `orbslam3_tpu/optim/lm.py`."""

from __future__ import annotations

import torch

# Chi2 gates at 95% for 2/3 DoF (ref Optimizer.cc chi2Mono / chi2Stereo).
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """Huber IRLS weight on the squared error: 1 if chi2 <= delta2 else
    delta / sqrt(chi2)."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / safe))
