"""Port parity: the matrix-free bundle adjustment (`optim/lm.py::pcg`,
`optim/ba.py::_solve_ba_pcg`) against the JAX package on the CPU.

* `lm.pcg` on one SPD system with a block-Jacobi preconditioner: within
  1e-5 of the reference's, at a few iteration counts (the early-out state
  included);
* `solve_ba` on the PCG path on `tests/test_optim.py`'s scene (6 cameras
  on an arc, 120 points, the same perturbed start as
  `test_ba_dense_schur_matches_pcg`): poses within 1e-4 and points within
  1e-3 of the reference's PCG path, and within that test's tolerances
  (cam_t 2e-3, points 5e-3) of the port's own dense path;
* `auto_dense_schur(512, 65536)` is False, as in the reference;
* an `AsyncGBA` at the runner's default map size (Kmax 512, Pmax 65536)
  runs to its end on the PCG path and lowers the reprojection cost.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loop_scene as LS
from orbslam3_tpu.optim import ba as ba_j
from orbslam3_tpu.optim import lm as lm_j
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.optim import ba as ba_t
from orbslam3_tpu_torch.optim import lm as lm_t
from orbslam3_tpu_torch.pipeline import gba as gba_t
from tests.synthetic import make_scene

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _spd_system(seed=0, n=12, k=6):
    """A block SPD matrix (n blocks of k) with strong diagonal blocks, and a
    right-hand side."""
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (n * k, n * k)).astype(np.float32)
    M = (A @ A.T / (n * k) + np.eye(n * k)).astype(np.float32)
    for i in range(n):
        M[i * k:(i + 1) * k, i * k:(i + 1) * k] += 4 * np.eye(k, dtype=np.float32)
    b = rng.normal(0, 1, (n, k)).astype(np.float32)
    blocks = np.stack([np.linalg.inv(M[i * k:(i + 1) * k, i * k:(i + 1) * k])
                       for i in range(n)]).astype(np.float32)
    return M, b, blocks


@pytest.mark.parametrize("iters", [1, 5, 40])
def test_pcg_matches_reference(iters):
    M, b, blocks = _spd_system()
    Mj, Bj = jnp.asarray(M), jnp.asarray(blocks)
    Mt, Bt = torch.from_numpy(M), torch.from_numpy(blocks)
    ref = lm_j.pcg(lambda x: (Mj @ x.reshape(-1)).reshape(x.shape), jnp.asarray(b),
                   lambda r: jnp.einsum("cij,cj->ci", Bj, r), iters=iters)
    got = lm_t.pcg(lambda x: (Mt @ x.reshape(-1)).reshape(x.shape), torch.from_numpy(b),
                   lambda r: torch.einsum("cij,cj->ci", Bt, r), iters=iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(got.residual_norm), float(ref.residual_norm), rtol=0,
                               atol=1e-5)
    if iters == 40:  # converged: the early-out froze the state at the solution
        np.testing.assert_allclose(got.x.numpy().reshape(-1), np.linalg.solve(M, b.reshape(-1)),
                                   rtol=0, atol=1e-4)


def _optim_scene():
    """`test_ba_dense_schur_matches_pcg`'s problem, in numpy."""
    rng = np.random.default_rng(0)
    scene = make_scene(rng, n_cams=6, n_pts=120)
    C, P, O = len(scene["cam_R"]), len(scene["points"]), len(scene["obs_cam"])
    fixed = np.zeros(C, bool)
    fixed[[0, 1]] = True
    d = dict(cam_R=scene["cam_R"], cam_t=scene["cam_t"], cam_fixed=fixed,
             points=scene["points"], point_valid=np.ones(P, bool), obs_cam=scene["obs_cam"],
             obs_point=scene["obs_point"], obs_uv=scene["obs_uv"],
             obs_ur=np.full(O, -1.0, np.float32), obs_sigma2=np.ones(O, np.float32),
             obs_valid=np.ones(O, bool))
    d["cam_t"] = (d["cam_t"] + rng.normal(0, 0.02, d["cam_t"].shape).astype(np.float32)
                  * (~fixed)[:, None]).astype(np.float32)
    d["points"] = (d["points"] + rng.normal(0, 0.03, d["points"].shape).astype(np.float32)
                   ).astype(np.float32)
    return np.asarray(scene["params"]), d


def test_solve_ba_pcg_matches_reference_and_dense():
    params, d = _optim_scene()
    prob_j = ba_j.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})
    prob_t = ba_t.BAProblem(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})
    pt = torch.from_numpy(params.astype(np.float32))
    model_j = ba_j.cam.CameraModel.PINHOLE
    ref = ba_j.solve_ba(model_j, jnp.asarray(params), prob_j, iters=12, pcg_iters=60)
    got = ba_t.solve_ba(cam_t.CameraModel.PINHOLE, pt, prob_t, iters=12, pcg_iters=60)
    np.testing.assert_allclose(got.cam_R.numpy(), np.asarray(ref.cam_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))
    dense = ba_t.solve_ba(cam_t.CameraModel.PINHOLE, pt, prob_t, iters=12, dense_schur=True)
    assert float(got.cost) < 1e-1 and float(dense.cost) < 1e-1
    np.testing.assert_allclose(dense.cam_t.numpy(), got.cam_t.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(dense.points.numpy(), got.points.numpy(), rtol=0, atol=5e-3)


def test_runner_default_map_takes_the_pcg_path():
    assert not ba_t.auto_dense_schur(512, 65536)
    assert not ba_j.auto_dense_schur(512, 65536)
    assert ba_t.dense_schur_bytes(512, 65536) > 4 << 30


def test_async_gba_at_kmax_512_runs_the_pcg_path(monkeypatch):
    """`loop_scene.make_ba_map`'s 12 keyframes (cameras moved by 2 cm,
    points by 5 cm) in a Kmax 512, Pmax 65536 map (16 features a keyframe
    slot): `AsyncGBA` takes the PCG path, runs its 10 iterations in chunks
    of 2 to the end and lowers the reprojection cost."""
    Kmax, Pmax, Nf = 512, 65536, 16
    arrays, info = LS.make_ba_map(Kmax=Kmax, Pmax=Pmax, Nf=Nf, n_pts=Nf - 1)
    rng = np.random.default_rng(5)
    K = info["n_kf"]
    arrays["kf_t"][1:K] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    arrays["mp_pos"][1:info["n_mp"]] += rng.normal(0, 0.05, (info["n_mp"] - 1, 3)).astype(
        np.float32)
    store = st_t.MapStore(Kmax=Kmax, Pmax=Pmax, Nf=Nf, device="cpu")
    store.state = st_t.MapState(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    store.n_kf, store.n_mp, store.kf_ts = K, info["n_mp"], info["kf_ts"].copy()
    orb = feat_t.OrbParams(n_features=256, n_levels=4)
    sigma2 = torch.from_numpy(feat_t.sigma2(orb))
    params = torch.from_numpy(LS.PARAMS.copy())
    paths = []
    solve = ba_t.solve_ba
    monkeypatch.setattr(ba_t, "solve_ba", lambda *a, **kw: paths.append(
        (kw["dense_schur"], kw["obs_per_cam"])) or solve(*a, **kw))
    cost = lambda s: float(gba_t.gba_step(cam_t.CameraModel.PINHOLE, params, s,  # noqa: E731
                                          gba_t._fixed(store), sigma2, 30.0, 0)[1])
    before = cost(store.state)
    gba = gba_t.AsyncGBA(cam_t.CameraModel.PINHOLE, params, sigma2, bf=30.0)
    gba.start(store)
    while not gba.tick(store):
        pass
    assert gba.n_finished == 1 and gba.n_chunks == 5 and not gba.running
    assert set(paths) == {(False, Nf)}
    assert cost(store.state) < 0.5 * before
