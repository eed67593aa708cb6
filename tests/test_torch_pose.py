"""Port parity: pose-only optimization (`orbslam3_tpu_torch.optim.pose_only`)
against the JAX package on the CPU, on the same seeded observations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import lm as lm_j
from orbslam3_tpu.optim import pose_only as po_j
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.optim import lm as lm_t
from orbslam3_tpu_torch.optim import pose_only as po_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

K = (458.654, 457.296, 376.0, 240.0)
BF = 47.9  # EuRoC-like stereo baseline x fx


def _problem(seed, n=600, stereo=False):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 12.0, n)
    Xc = np.stack([rng.uniform(-0.7, 0.7, n) * z, rng.uniform(-0.45, 0.45, n) * z, z], -1)
    w = rng.normal(0, 0.05, 3)
    R_true = np.asarray(lie_j.exp_so3(jnp.asarray(w, jnp.float32)))
    t_true = rng.normal(0, 0.2, 3).astype(np.float32)
    Xw = ((Xc - t_true) @ R_true).astype(np.float32)  # R^T (Xc - t)
    uv = np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2], K[1] * Xc[:, 1] / Xc[:, 2] + K[3]], -1)
    octave = rng.integers(0, 8, n)
    sigma2 = (1.2 ** (2 * octave)).astype(np.float32)
    uv = uv + rng.normal(0, 1.0, (n, 2)) * np.sqrt(sigma2)[:, None]
    out = rng.random(n) < 0.2
    uv[out] += rng.uniform(-60, 60, (out.sum(), 2))
    ur = np.full(n, -1.0)
    if stereo:
        has = rng.random(n) < 0.5
        ur[has] = uv[has, 0] - BF / Xc[has, 2] + rng.normal(0, 1.0, has.sum())
    valid = rng.random(n) > 0.05
    dR = np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32)))
    R0 = (dR @ R_true).astype(np.float32)
    t0 = (t_true + rng.normal(0, 0.05, 3)).astype(np.float32)
    arrays = dict(Xw=Xw, uv=uv.astype(np.float32), ur=ur.astype(np.float32),
                  sigma2=sigma2, valid=valid)
    return arrays, R0, t0, (0.0 if not stereo else BF)


@pytest.mark.parametrize("seed,stereo", [(0, False), (1, False), (2, True)])
def test_optimize_pose_matches(seed, stereo):
    """R and t within 1e-4 (float32 normal equations summed in another
    order); the inlier sets equal except for observations whose final
    chi2 lies within 1e-3 of their gate, where that order decides."""
    obs, R0, t0, bf = _problem(seed, stereo=stereo)
    ref = po_j.optimize_pose(
        cam_j.CameraModel.PINHOLE, cam_j.make_pinhole(*K), jnp.asarray(R0), jnp.asarray(t0),
        po_j.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}), bf=bf,
    )
    got = po_t.optimize_pose(
        cam_t.CameraModel.PINHOLE, cam_t.make_pinhole(*K), torch.from_numpy(R0),
        torch.from_numpy(t0), po_t.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
        bf=bf,
    )
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-4)
    c2 = np.asarray(ref.chi2)
    gate = np.where(obs["ur"] >= 0, lm_j.CHI2_STEREO, lm_j.CHI2_MONO)
    near = np.abs(c2 - gate) < 1e-3
    inl_r, inl_g = np.asarray(ref.inlier), got.inlier.numpy()
    assert not np.any((inl_r != inl_g) & ~near)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= int(near.sum())
    assert int(ref.n_inliers) > 300


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_on_the_cpu_runs_op_by_op(stereo):
    """On CPU tensors `optimize_pose` is `optimize_pose_eager` bit for bit
    (its arguments packed for `graphed.run` and unpacked again, right
    camera rows included) and neither captures nor replays a CUDA graph."""
    from orbslam3_tpu_torch.optim import graphed

    obs, R0, t0, bf = _problem(3, stereo=stereo)
    o = po_t.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()})
    args = (cam_t.CameraModel.PINHOLE, cam_t.make_pinhole(*K), torch.from_numpy(R0),
            torch.from_numpy(t0), o)
    rig = dict(obs_r=o._replace(uv=o.uv + 0.5), params_r=cam_t.make_pinhole(*K),
               R_rl=torch.eye(3), t_rl=torch.tensor([-0.1, 0.0, 0.0])) if stereo else {}
    counts = graphed.CAPTURES, graphed.REPLAYS
    got = po_t.optimize_pose(*args, bf=bf, **rig)
    ref = po_t.optimize_pose_eager(*args, bf=bf, **rig)
    assert (graphed.CAPTURES, graphed.REPLAYS) == counts
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref.n_inliers) > 300


def test_huber_weight_matches():
    c2 = np.linspace(0, 40, 101).astype(np.float32)
    np.testing.assert_allclose(
        lm_t.huber_weight(torch.from_numpy(c2), lm_t.CHI2_MONO).numpy(),
        np.asarray(lm_j.huber_weight(jnp.asarray(c2), lm_j.CHI2_MONO)), rtol=1e-6)
    assert (lm_t.CHI2_MONO, lm_t.CHI2_STEREO) == (lm_j.CHI2_MONO, lm_j.CHI2_STEREO)
