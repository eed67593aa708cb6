"""Port parity: global bundle adjustment (`orbslam3_tpu_torch/pipeline/gba.py`)
against the JAX package on the CPU, on a 12-keyframe map of
`tests/loop_scene.py` (Kmax 16, Pmax 1024, 256 features: the dense reduced
system over every camera, as `auto_dense_schur` picks at config 1's Kmax
256).

* `global_ba` (10 LM iterations, keyframe 0 fixed): poses and points within
  1e-4 of the reference's.
* `AsyncGBA` in chunks of 2: equal to `global_ba` run chunk by chunk (each
  chunk a fresh solve from the last, as the reference's), and within 1e-4
  of the reference's `AsyncGBA`.
* `_finish` with a keyframe and points made while the solve ran: they are
  carried through their anchors as the reference carries them (within
  1e-4).
* `auto_dense_schur`, and the whole-map problem on the matrix-free PCG path
  against the reference's PCG path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import loop_scene as LS
from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.optim import ba as ba_j
from orbslam3_tpu.pipeline import gba as gba_j
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.optim import ba as ba_t
from orbslam3_tpu_torch.pipeline import gba as gba_t
from test_torch_loop import jax_store, port_store

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ORB = feat_j.OrbParams(n_features=256, n_levels=4)
KEYS = ("kf_R", "kf_t", "mp_pos")


BF = 30.0  # the stereo rows' baseline x fx (10 cm)


@pytest.fixture(scope="module")
def scene():
    """`loop_scene.make_ba_map` with its cameras moved by 2 cm and its points
    by 5 cm: keyframe 0 and four keyframes' stereo rows fix the gauge, so
    the solution is unique and two float32 solvers can agree within 1e-4
    (on the drifted circle of `test_torch_loop.py`, with points seen from
    a few nearby keyframes, they land 1e-3 apart along flat valleys of the
    same cost)."""
    arrays, info = LS.make_ba_map(bf=BF)
    rng = np.random.default_rng(5)
    K = info["n_kf"]
    arrays["kf_t"][1:K] += rng.normal(0, 0.02, (K - 1, 3)).astype(np.float32)
    arrays["mp_pos"][1:info["n_mp"]] += rng.normal(0, 0.05, (info["n_mp"] - 1, 3)).astype(
        np.float32)
    return arrays, info


def _pair(scene):
    store_j = jax_store(*scene, Kmax=16, Pmax=1024)
    return store_j, port_store(store_j)


def _args_j():
    return (cam_j.CameraModel.PINHOLE, jnp.asarray(LS.PARAMS), jnp.asarray(feat_j.sigma2(ORB)))


def _args_t():
    return (cam_t.CameraModel.PINHOLE, torch.from_numpy(LS.PARAMS.copy()),
            torch.from_numpy(feat_j.sigma2(ORB)))


def _same(store_t, store_j, atol=1e-4):
    for k in KEYS:
        np.testing.assert_allclose(getattr(store_t.state, k).numpy(),
                                   np.asarray(getattr(store_j.state, k)), rtol=0, atol=atol,
                                   err_msg=k)


def test_global_ba_matches_reference(scene):
    store_j, store_t = _pair(scene)
    t0 = store_t.state.kf_t.clone()
    m, p, s2 = _args_j()
    cost_j = gba_j.global_ba(store_j, m, p, s2, bf=BF, iters=10)
    cost_t = gba_t.global_ba(store_t, *_args_t(), bf=BF, iters=10)
    _same(store_t, store_j)
    assert abs(cost_t - cost_j) <= 1e-3 * max(cost_j, 1.0)
    assert float((store_t.state.kf_t - t0).abs().max()) > 1e-3  # the solve moved the cameras
    assert torch.equal(store_t.state.kf_t[0], t0[0])  # keyframe 0 fixed


def test_async_gba_in_chunks(scene):
    store_j, store_t = _pair(scene)
    store_c = port_store(store_j)  # global_ba chunk by chunk
    a_j = gba_j.AsyncGBA(*_args_j(), bf=BF, iters=10, chunk=2)
    a_t = gba_t.AsyncGBA(*_args_t(), bf=BF, iters=10, chunk=2)
    a_j.start(store_j)
    a_t.start(store_t)
    done = [a_t.tick(store_t) for _ in range(5)]
    a_j.join(store_j)
    assert done == [False] * 4 + [True] and a_t.n_finished == a_j.n_finished == 1
    assert a_t.n_chunks == 5 and not a_t.running
    for _ in range(5):
        gba_t.global_ba(store_c, *_args_t(), bf=BF, iters=2)
    for k in KEYS:
        assert torch.equal(getattr(store_t.state, k), getattr(store_c.state, k)), k
    _same(store_t, store_j)


def test_finish_carries_what_was_made_during_the_solve(scene):
    """A keyframe inserted and points created while the solve ran (in both
    packages the same way) ride the correction of their anchors."""
    store_j, store_t = _pair(scene)
    a_j = gba_j.AsyncGBA(*_args_j(), bf=BF, iters=4, chunk=2)
    a_t = gba_t.AsyncGBA(*_args_t(), bf=BF, iters=4, chunk=2)
    a_j.start(store_j)
    a_t.start(store_t)
    a_j.tick(store_j)
    a_t.tick(store_t)
    K = store_j.n_kf
    new_kf = K  # a keyframe after the last one, near it
    R_new = np.asarray(store_j.state.kf_R)[K - 1]
    t_new = np.asarray(store_j.state.kf_t)[K - 1] + np.asarray([0.05, 0.0, 0.0], np.float32)
    new_pts = np.arange(store_j.n_mp, store_j.n_mp + 5)
    pos = np.random.default_rng(6).normal(0, 1, (5, 3)).astype(np.float32) + [0, 0, 5]
    for store, T in ((store_j, jnp.asarray), (store_t, torch.from_numpy)):
        s = store.state
        arr = {k: np.array(getattr(s, k)) for k in ("kf_R", "kf_t", "kf_valid", "mp_pos",
                                                     "mp_valid", "mp_first_kf")}
        arr["kf_R"][new_kf], arr["kf_t"][new_kf], arr["kf_valid"][new_kf] = R_new, t_new, True
        arr["mp_pos"][new_pts], arr["mp_valid"][new_pts] = pos, True
        arr["mp_first_kf"][new_pts] = [new_kf, new_kf, 3, 7, K - 1]
        store.state = s._replace(**{k: T(v) for k, v in arr.items()})
        store.n_kf, store.n_mp = K + 1, store.n_mp + 5
        store.kf_ts[new_kf] = store.kf_ts[K - 1] + 0.5
    a_j.tick(store_j)
    assert a_t.tick(store_t) and a_t.n_finished == 1
    _same(store_t, store_j)
    moved = np.abs(store_t.state.mp_pos.numpy()[new_pts] - pos).max()
    assert moved > 0  # carried by their anchors' corrections


def test_auto_dense_schur_and_the_pcg_path(scene):
    """The choice of path is the reference's, and the whole-map problem on
    the matrix-free PCG path lands within 1e-4 (poses) and 1e-3 (points) of
    the reference's PCG path."""
    for C, P in ((32, 4096), (256, 16384), (512, 65536), (1024, 65536)):
        assert ba_t.auto_dense_schur(C, P) == ba_j.auto_dense_schur(C, P)
    assert ba_t.auto_dense_schur(256, 16384)  # config 1: dense
    assert not ba_t.auto_dense_schur(512, 65536)  # the runner's default map: PCG
    store_j, store_t = _pair(scene)
    fixed = np.zeros(16, bool)
    fixed[0] = True
    fixed |= ~np.asarray(store_j.state.kf_valid)
    model_j, params_j, s2_j = _args_j()
    model_t, params_t, s2_t = _args_t()
    prob_j = gba_j.build_gba_problem(store_j.state, jnp.asarray(fixed), s2_j)
    prob_t = gba_t.build_gba_problem(store_t.state, torch.from_numpy(fixed), s2_t)
    ref = ba_j.solve_ba(model_j, params_j, prob_j, bf=BF, iters=10, pcg_iters=50)
    got = ba_t.solve_ba(model_t, params_t, prob_t, bf=BF, iters=10, pcg_iters=50, obs_per_cam=256)
    np.testing.assert_allclose(got.cam_R.numpy(), np.asarray(ref.cam_R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(ref.cam_t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points), rtol=0, atol=1e-3)
    assert float(got.cost) < float(ba_t.solve_ba(model_t, params_t, prob_t, bf=BF, iters=0).cost)
