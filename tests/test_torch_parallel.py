"""Port parity: the sharded bundle adjustment and the sharded keyframe-database
query (`orbslam3_tpu_torch/parallel/`) against the JAX package's
(`orbslam3_tpu/parallel/`) on the CPU, on the inputs of `tests/test_parallel.py`
(same scenes, same seeds).

The port's ranks are spawned processes in one gloo group each
(`parallel/launch.py`, one thread a rank; their functions are
`tests/dist_cases.py`, which imports no JAX); the cases of one world size run
in one spawn. The JAX side runs `shard_map` on the suite's virtual CPU
devices (`tests/conftest.py`: 8). Tolerances, the JAX suite's own for its
sharded solves: poses within 2e-3, points within 5e-3, `obs_inlier` equal or
fewer than 2% flipped, the cost within 5% (or 1.0). Exact: the KFDB query's
ids (against JAX up to keyframes whose scores tie within 1e-6) and
`prep_point_sharded`'s layout. In float64 the sharded layouts equal the
single-device solve within 1e-8 (the float32 gaps are summation order)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import dist_cases  # noqa: E402
from orbslam3_tpu.ops import bow as bow_j  # noqa: E402
from orbslam3_tpu.optim import ba as ba_j  # noqa: E402
from orbslam3_tpu.parallel import ba_sharded as bs_j  # noqa: E402
from orbslam3_tpu.parallel import kfdb_sharded as kq_j  # noqa: E402
from orbslam3_tpu_torch.ops import cameras as cam_t  # noqa: E402
from orbslam3_tpu_torch.optim import ba as ba_t  # noqa: E402
from orbslam3_tpu_torch.parallel import ba_sharded as bs_t  # noqa: E402
from orbslam3_tpu_torch.parallel import launch  # noqa: E402
from tests.synthetic import make_scene, perturb_poses  # noqa: E402
from tests.test_optim import _ba_problem_from_scene  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

KW = dict(iters=5, pcg_iters=30)  # test_parallel.py's


def _problem(n_pts: int):
    """`test_parallel.py`'s perturbed 5-camera scene (its `rng` fixture's
    seed 0), as the JAX `BAProblem`, its numpy dict, and the params."""
    rng = np.random.default_rng(0)
    scene = make_scene(rng, n_cams=5, n_pts=n_pts, noise_px=0.3)
    Rs2, ts2 = perturb_poses(rng, scene["cam_R"], scene["cam_t"], keep_first=2)
    prob = _ba_problem_from_scene(scene)._replace(cam_R=jnp.asarray(Rs2), cam_t=jnp.asarray(ts2))
    d = {k: None if v is None else np.asarray(v) for k, v in prob._asdict().items()}
    return prob, d, np.array(scene["params"])


def _single_t(d: dict, params, dtype=None, **kw):
    p = dist_cases.ba_problem(d, dtype)
    return ba_t.solve_ba(cam_t.CameraModel.PINHOLE, torch.from_numpy(params).to(p.cam_R.dtype),
                         p, **{**KW, **kw})


def _query_inputs(K: int):
    """`test_parallel.py::test_sharded_kfdb_query`'s database and query
    (30 prototype descriptors, a 5x3 vocabulary), K rows."""
    rng = np.random.default_rng(0)
    protos = rng.integers(0, 256, size=(30, 32), dtype=np.uint8)
    descs = []
    for p in protos:
        for _ in range(30):
            d = p.copy()
            d[rng.integers(0, 32, 4)] ^= rng.integers(1, 255, 4).astype(np.uint8)
            descs.append(d)
    voc = bow_j.build_vocabulary(np.stack(descs), k=5, depth=3, seed=0)

    def make_vec(idx):
        d = []
        for i in idx:
            x = protos[i].copy()
            x[rng.integers(0, 32)] ^= 1
            d.append(x)
        w = bow_j.transform(voc, jnp.asarray(np.stack(d)), jnp.ones(len(idx), bool))
        return w, bow_j.bow_vector(voc, w)

    vecs, words = [], []
    for _ in range(K):
        w, v = make_vec(rng.integers(0, 30, size=12))
        vecs.append(v)
        words.append(w)
    qw, qv = make_vec(rng.integers(0, 30, size=12))
    valid = np.ones(K, bool)
    valid[5] = False  # one erased keyframe
    return (np.asarray(qv), np.asarray(qw), np.asarray(jnp.stack(vecs)), valid)


QUERY_K = (24, 22)  # a multiple of 4, and one padded


@pytest.fixture(scope="module")
def four():
    """Every 4-rank case in one spawn."""
    _, d80, params = _problem(80)
    todo = [("obs", "solve_sharded", ("obs", d80, params, KW)),
            ("obs_dense", "solve_sharded", ("obs", d80, params, dict(KW, dense_schur=True)))]
    for layout, kw in (("obs", {}), ("obs_dense", dict(dense_schur=True)), ("point", {})):
        todo.append((f"f64_{layout}", "solve_sharded",
                     ("point" if layout == "point" else "obs", d80, params, dict(KW, **kw),
                      torch.float64)))
    for K in QUERY_K:
        todo.append((f"query_{K}", "sharded_query", _query_inputs(K) + (5,)))
    return launch.run(dist_cases.cases, 4, (todo,), device="cpu", threads=1)


def _close(got: dict, ref, valid=None, what=""):
    for k in ("cam_R", "cam_t"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)), atol=2e-3,
                                   err_msg=f"{what} {k}")
    pts, ref_pts = got["points"], np.asarray(ref.points)
    if valid is not None:
        pts, ref_pts = pts[valid], ref_pts[valid]
    np.testing.assert_allclose(pts, ref_pts, atol=5e-3, err_msg=f"{what} points")
    c, rc = float(got["cost"]), float(ref.cost)
    assert abs(c - rc) < max(0.05 * rc, 1.0), (what, c, rc)
    inl, ref_inl = got["obs_inlier"], np.asarray(ref.obs_inlier)
    assert inl.shape == ref_inl.shape
    assert np.mean(inl != ref_inl) < 0.02, what


@pytest.mark.parametrize("n", range(1, 9))
def test_prep_point_sharded_equals_jax(n):
    """The point-partitioned layout (83 points: padding for most n) equal
    field for field, with `dst`, `fill` and the point count."""
    prob_j, d, _ = _problem(83)
    sj, dst_j, fill_j, pn_j = bs_j.prep_point_sharded(prob_j, n)
    st, dst_t, fill_t, pn_t = bs_t.prep_point_sharded(dist_cases.ba_problem(d), n)
    assert pn_t == pn_j == 83
    np.testing.assert_array_equal(dst_t, dst_j)
    np.testing.assert_array_equal(fill_t, fill_j)
    for f in sj._fields:
        a, b = getattr(st, f), getattr(sj, f)
        if b is None:
            assert a is None, f
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
        assert a.shape == np.asarray(b).shape, f


def test_solve_ba_sharded_matches_jax_and_single(four):
    """Observations sharded on 4 ranks (the PCG path) against JAX's
    `solve_ba_sharded` on 4 devices and against the port's one-device solve;
    every rank holds the same result."""
    prob_j, d, params = _problem(80)
    ref_j = bs_j.solve_ba_sharded(cam_t.CameraModel.PINHOLE, jnp.asarray(params), prob_j,
                                  bs_j.make_mesh(jax.devices()[:4]), **KW)
    ref_j = ref_j._replace(obs_inlier=np.asarray(ref_j.obs_inlier)[:len(d["obs_cam"])])
    got = four[0]["obs"]
    _close(got, ref_j, what="vs JAX")
    _close(got, _single_t(d, params), what="vs single")
    for r in four[1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(r["obs"][k], v)


def test_solve_ba_sharded_dense_matches_single(four):
    """The dense path with observations sharded (one all-reduce of the point
    and camera blocks, then the coupling tensor, the right-hand side and the
    back-substitution) against the port's and JAX's one-device dense solves."""
    prob_j, d, params = _problem(80)
    got = four[0]["obs_dense"]
    _close(got, _single_t(d, params, dense_schur=True), what="vs single")
    ref_j = ba_j.solve_ba(cam_t.CameraModel.PINHOLE, jnp.asarray(params), prob_j,
                          dense_schur=True, **KW)
    _close(got, ref_j, what="vs JAX")


@pytest.mark.parametrize("layout", ["obs", "obs_dense", "point"])
def test_sharded_layouts_equal_single_in_float64(four, layout):
    """In float64 each layout on 4 ranks equals the one-device solve of its
    path within 1e-8: the float32 gaps of the other tests are summation
    order, not a different sum."""
    _, d, params = _problem(80)
    ref = _single_t(d, params, torch.float64, dense_schur=layout != "obs")
    got = four[0][f"f64_{layout}"]
    for k in ("cam_R", "cam_t", "points"):
        np.testing.assert_allclose(got[k], getattr(ref, k).numpy(), rtol=0, atol=1e-8,
                                   err_msg=k)
    assert abs(float(got["cost"]) - float(ref.cost)) < 1e-8 * max(float(ref.cost), 1.0)
    np.testing.assert_array_equal(got["obs_inlier"], ref.obs_inlier.numpy())


def test_solve_ba_point_sharded_matches_jax():
    """The point axis block-partitioned over 3 ranks, 83 points (one padding
    point), the dense Schur path: against JAX's `solve_ba_point_sharded` on 3
    devices and against the single-device solve."""
    prob_j, d, params = _problem(83)
    res = launch.run(dist_cases.cases, 3,
                     ([("point", "solve_sharded", ("point", d, params, KW))],), device="cpu",
                     threads=1)
    got = res[0]["point"]
    ref_j = bs_j.solve_ba_point_sharded(cam_t.CameraModel.PINHOLE, jnp.asarray(params), prob_j,
                                        bs_j.make_mesh(jax.devices()[:3]), **KW)
    valid = d["point_valid"]
    _close(got, ref_j, valid, what="vs JAX")
    _close(got, _single_t(d, params, dense_schur=True), valid, what="vs single")
    for r in res[1:]:
        np.testing.assert_array_equal(r["point"]["cam_t"], got["cam_t"])
        np.testing.assert_array_equal(r["point"]["points"], got["points"])


@pytest.mark.parametrize("K", QUERY_K)
def test_sharded_query_matches_jax(four, K):
    """`sharded_query` on 4 ranks: ids and scores exact against the same
    query on one process (the port's unsharded ranking) and on every rank;
    against JAX's on 4 devices, scores within 1e-6 and ids exact, except that
    keyframes whose scores tie within 1e-6 may come in either order (the L1
    score's float sum rounds a tie apart by an ulp, in another direction in
    XLA than in PyTorch: here two keyframes score 1/3 each)."""
    from orbslam3_tpu_torch.parallel import kfdb_sharded as kq_t

    qv, qw, db, valid = _query_inputs(K)
    ids_j, sc_j = kq_j.sharded_query(jnp.asarray(qv), jnp.asarray(qw), jnp.asarray(db),
                                     jnp.asarray(valid), kq_j.make_mesh(jax.devices()[:4]),
                                     n_best=5)
    ids_j, sc_j = np.asarray(ids_j), np.asarray(sc_j)
    one = kq_t.sharded_query(*(torch.from_numpy(np.array(x)) for x in (qv, qw, db, valid)),
                             n_best=5)
    got = four[0][f"query_{K}"]
    np.testing.assert_array_equal(got["ids"], one[0].numpy())
    np.testing.assert_array_equal(got["scores"], one[1].numpy())
    for r in four[1:]:
        np.testing.assert_array_equal(r[f"query_{K}"]["ids"], got["ids"])
    np.testing.assert_allclose(got["scores"], sc_j, rtol=0, atol=1e-6)
    for i in range(len(ids_j)):
        tied = np.abs(sc_j - sc_j[i]) <= 1e-6
        assert got["ids"][i] == ids_j[i] or (tied.sum() > 1 and got["ids"][i] in ids_j[tied]), (
            got["ids"], ids_j, sc_j)


def test_dryrun_multichip_on_the_cpu():
    """`entry.dryrun_multichip` on 2 CPU ranks at a cut shape (32 keyframes,
    2048 points, 256 observations each): both layouts within its gates."""
    from orbslam3_tpu_torch import entry as E

    out = E.dryrun_multichip(2, device="cpu", C=32, P=2048, obs_per_cam=256)
    for layout in ("obs", "point"):
        o = out[layout]
        assert o["same_ranks"] and np.isfinite(o["cost"]), layout
        assert o["d_pose"] <= 2e-3 and o["d_points"] <= 5e-3, (layout, o)
    assert out["point"]["collectives"]["ba/dense packed system"][0] == 4  # 3 iterations + 1
