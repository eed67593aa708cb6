"""Port parity: the Sim3 refinement (`orbslam3_tpu_torch/optim/sim3.py`,
`Optimizer::OptimizeSim3`) against the JAX package on the CPU, on the
scenes of `tests/test_sim3_opt.py` (a start near the solution; 25 outlier
pairs; weightless backward edges; fixed scale). Tolerance: R, t and s within 1e-4, the inlier
set and `n_inliers` equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import sim3 as sim3_j
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.optim import sim3 as sim3_t
from test_sim3_opt import _setup

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _t(x):
    return torch.from_numpy(np.array(x, np.float32) if np.asarray(x).dtype != bool
                            else np.array(x))


@pytest.mark.parametrize("case", ["perturbed", "outliers", "forward_only", "fix_scale"])
def test_optimize_sim3_matches_reference(case):
    rng = np.random.default_rng(3)
    params, X1, X2, uv1, uv2, R_gt, t_gt, s_gt = _setup(rng, n_out=25 if case == "outliers" else 0)
    N = len(X1)
    # A start inside the chi2 gates (as RANSAC hands over): from the far
    # start of `test_sim3_opt.py` two pairs pass, and the first steps
    # amplify float32 rounding differences without bound.
    R0 = np.asarray(lie_j.exp_so3(jnp.asarray([0.003, -0.002, 0.004]))) @ R_gt
    t0, s0 = t_gt + 0.01, s_gt * 1.01
    s2_1 = np.ones(N, np.float32)
    s2_2 = np.ones(N, np.float32)
    if case == "forward_only":
        s2_2[::3] = 0.0  # weightless backward edges
    valid = np.ones(N, bool)
    valid[::17] = False
    fix = case == "fix_scale"
    args = (R0, t0, np.float32(s0 if not fix else s_gt), X1, X2, uv1, uv2, s2_1, s2_2)
    ref = sim3_j.optimize_sim3(cam_j.CameraModel.PINHOLE, params,
                               *(jnp.asarray(np.asarray(a, np.float32)) for a in args),
                               jnp.asarray(valid), fix_scale=fix)
    got = sim3_t.optimize_sim3(cam_t.CameraModel.PINHOLE, _t(np.asarray(params)),
                               *(_t(a) for a in args), _t(valid), fix_scale=fix)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    assert int(got.n_inliers) == int(ref.n_inliers) >= N * 0.6
    assert np.abs(got.R.numpy() - R_gt).max() < 5e-3
