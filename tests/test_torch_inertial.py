"""Port parity: the inertial solvers (`orbslam3_tpu_torch.optim.inertial`)
against the JAX package on the CPU, on the chains and problems of
`tests/test_inertial.py` (same seeds). Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.optim import inertial as vi_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import imu as imu_t
from orbslam3_tpu_torch.ops import lie as lie_t
from orbslam3_tpu_torch.optim import inertial as vi_t
from tests.test_inertial import _make_vi_problem, simulate_kf_chain

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def T(x, dtype=None):
    return torch.from_numpy(np.array(x, copy=True)) if dtype is None else \
        torch.from_numpy(np.array(x, dtype=dtype, copy=True))


def edges_t(e) -> vi_t.ImuEdge:
    return convert.to_torch(e, "cpu", vi_t.ImuEdge)


def problem_t(prob) -> vi_t.VIProblem:
    d = {k: T(v) for k, v in prob._asdict().items() if k not in ("state", "edges")}
    return vi_t.VIProblem(state=convert.to_torch(prob.state, "cpu", vi_t.BodyState),
                          edges=edges_t(prob.edges), **d)


def chain(seed, **kw):
    return simulate_kf_chain(np.random.default_rng(seed), **kw)


def test_make_imu_edges():
    """Edges from the same stacked windows: info within 1e-4 relative to
    each edge's largest entry (the inverse of a ~1e-10 covariance)."""
    rng = np.random.default_rng(0)
    calib = imu_j.ImuCalib.create(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    acc = (np.array([0, 0, 9.81]) + rng.normal(0, 1, (4, 20, 3))).astype(np.float32)
    gyro = rng.normal(0, 0.3, (4, 20, 3)).astype(np.float32)
    dts = np.full((4, 20), 0.005, np.float32)
    pres = imu_j.integrate_batch(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts),
                                 jnp.zeros(3), jnp.zeros(3), calib)
    ej = vi_j.make_imu_edges(jnp.arange(4, dtype=jnp.int32), jnp.arange(1, 5, dtype=jnp.int32),
                             pres, jnp.asarray([True, True, False, True]))
    et = vi_t.make_imu_edges(T(np.arange(4, dtype=np.int32)), T(np.arange(1, 5, dtype=np.int32)),
                             convert.preintegrated(pres, "cpu"), T([True, True, False, True]))
    for name in ej._fields:
        w, g = np.asarray(getattr(ej, name)), getattr(et, name).numpy()
        if name in ("info", "info_rw"):
            scale = np.abs(w).max(axis=(1, 2), keepdims=True)
            assert np.all(np.abs(g - w) <= 1e-4 * scale), name
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7, err_msg=name)


def test_imu_residual_and_jacobians():
    """The residual within 1e-5; the IMU rows' Jacobians from the shared
    perturbation equal per-edge `torch.func.jacrev` ones within 1e-4; the
    hand-written reprojection Jacobians equal `torch.func.jacfwd` ones
    within 1e-4 relative."""
    kf_R, kf_p, kf_v, edges, _ = chain(1, n_kf=6)
    rng = np.random.default_rng(2)
    K = len(kf_R)
    bg = rng.normal(0, 0.01, (K, 3)).astype(np.float32)
    ba = rng.normal(0, 0.05, (K, 3)).astype(np.float32)
    vp = kf_v + rng.normal(0, 0.05, kf_v.shape).astype(np.float32)
    e = edges
    i, j = np.asarray(e.i), np.asarray(e.j)
    rj = np.stack([np.asarray(vi_j.imu_residual(
        kf_R[a], kf_p[a], vp[a], bg[a], ba[a], kf_R[b], kf_p[b], vp[b], e.dR[k], e.dV[k],
        e.dP[k], e.JRg[k], e.JVg[k], e.JVa[k], e.JPg[k], e.JPa[k], e.bg0[k], e.ba0[k], e.dT[k],
        vi_j.G0)) for k, (a, b) in enumerate(zip(i, j))])
    state = vi_t.BodyState(T(kf_R), T(kf_p), T(vp), T(bg), T(ba))
    et = edges_t(e)
    g = imu_t.gravity("cpu")
    r9, J9i, J9j, rrw, Jrwi, Jrwj = vi_t._edge_res_jac(state, et, g)
    np.testing.assert_allclose(r9.numpy(), rj, rtol=1e-5, atol=1e-5)
    for k in range(len(i)):
        one = vi_t.ImuEdge(*(x[k : k + 1] for x in et))
        si = vi_t.BodyState(*(x[i[k] : i[k] + 1] for x in state))
        sj = vi_t.BodyState(*(x[j[k] : j[k] + 1] for x in state))

        def f(di, dj):
            a = vi_t.retract(si, di[None])
            b = vi_t.retract(sj, dj[None])
            r = vi_t.imu_residual(a.R, a.p, a.v, a.bg, a.ba, b.R, b.p, b.v, one.dR, one.dV,
                                  one.dP, one.JRg, one.JVg, one.JVa, one.JPg, one.JPa, one.bg0,
                                  one.ba0, one.dT, g)
            return torch.cat([r[0], b.bg[0] - a.bg[0], b.ba[0] - a.ba[0]])

        z = torch.zeros(15)
        Ji, Jj = torch.func.jacrev(f, argnums=(0, 1))(z, z)
        np.testing.assert_allclose(torch.cat([J9i[k], Jrwi[k]]).numpy(), Ji.numpy(), atol=1e-4)
        np.testing.assert_allclose(torch.cat([J9j[k], Jrwj[k]]).numpy(), Jj.numpy(), atol=1e-4)

    params = cam_t.make_pinhole(450.0, 450.0, 376.0, 240.0)
    Tcb_R = lie_t.exp_so3(torch.tensor([0.02, -0.01, 0.03]))
    Tcb_t = torch.tensor([0.05, -0.02, 0.01])
    n = 40
    Xw = T(np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], -1),
           np.float32)
    idx = rng.integers(0, K, n)
    R, p = state.R[idx], state.p[idx]
    uv = torch.full((n, 2), 300.0)
    r, Jx, Jp, _ = vi_t._visual_res_jac(cam_t.CameraModel.PINHOLE, params, Tcb_R, Tcb_t, R, p,
                                        Xw, uv)

    def res(dx, dX):
        Rb = R @ lie_t.exp_so3(dx[:3].expand(n, 3))
        pb = p + torch.einsum("nij,j->ni", R, dx[3:6])
        Xb = torch.einsum("nji,nj->ni", Rb, Xw + dX - pb)
        Xc = Xb @ Tcb_R.T + Tcb_t
        return cam_t.project(cam_t.CameraModel.PINHOLE, params, Xc) - uv

    Jx_ad = torch.func.jacfwd(lambda d: res(d, torch.zeros(3)))(torch.zeros(6))
    Jp_ad = torch.func.jacfwd(lambda d: res(torch.zeros(6), d))(torch.zeros(3))
    scale = float(Jx.abs().max())
    np.testing.assert_allclose(Jx.numpy(), Jx_ad.numpy(), atol=1e-4 * scale)
    np.testing.assert_allclose(Jp.numpy(), Jp_ad.numpy(), atol=1e-4 * float(Jp.abs().max()))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_only_optimization(fix_scale):
    """The scaled, rotated chain of `test_inertial_only_recovers_scale_and_
    gravity`, padded with 4 invalid keyframes (as the initializer pads to
    Kmax): scale within 1e-3 relative, Rwg within 1e-4, biases within 1e-4
    (gyro) and 1e-3 (acc, whose prior is 1e6), velocities within 1e-3 m/s."""
    bias_g = np.array([0.01, -0.008, 0.005], np.float32) if fix_scale else None
    kf_R, kf_p, kf_v, edges, _ = chain(3, bias_g=bias_g)
    s_true = 1.0 if fix_scale else 2.5
    Rwg_true = np.asarray(lie_j.exp_so3(jnp.asarray([0.15, -0.1, 0.0], jnp.float32)))
    kf_p_obs = ((Rwg_true.T @ kf_p.T).T / s_true).astype(np.float32)
    kf_R_obs = np.einsum("ij,kjl->kil", Rwg_true.T, kf_R).astype(np.float32)
    pad = 4
    Rp = np.concatenate([kf_R_obs, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
    pp = np.concatenate([kf_p_obs, np.zeros((pad, 3), np.float32)])
    valid = np.arange(len(Rp)) < len(kf_R)
    rj = vi_j.inertial_only_optimization(jnp.asarray(Rp), jnp.asarray(pp), jnp.asarray(valid),
                                         edges, iters=25, fix_scale=fix_scale)
    rt = vi_t.inertial_only_optimization(T(Rp), T(pp), T(valid), edges_t(edges), iters=25,
                                         fix_scale=fix_scale)
    assert abs(float(rt.scale) / float(rj.scale) - 1) < 1e-3
    np.testing.assert_allclose(rt.Rwg.numpy(), np.asarray(rj.Rwg), atol=1e-4)
    np.testing.assert_allclose(rt.bg.numpy(), np.asarray(rj.bg), atol=1e-4)
    np.testing.assert_allclose(rt.ba.numpy(), np.asarray(rj.ba), atol=1e-3)
    np.testing.assert_allclose(rt.vel.numpy()[valid], np.asarray(rj.vel)[valid], atol=1e-3)
    if not fix_scale:
        assert abs(float(rt.scale) - s_true) / s_true < 0.05


def _vi_problem(seed=4, n_pts=200):
    """`test_vi_ba_converges`'s perturbed problem; returns (problem, camera
    params)."""
    rng = np.random.default_rng(seed)
    kf_R, kf_p, kf_v, edges, _ = simulate_kf_chain(rng, n_kf=6)
    prob, params = _make_vi_problem(rng, kf_R, kf_p, kf_v, edges, n_pts=n_pts)
    K = len(kf_R)
    dR = [np.eye(3, dtype=np.float32)] + [
        np.asarray(lie_j.exp_so3(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32))))
        for _ in range(K - 1)]
    Rp = np.stack([kf_R[k] @ dR[k] for k in range(K)]).astype(np.float32)
    pp = (kf_p + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.03, (K - 1, 3))])
          ).astype(np.float32)
    vp = (kf_v + rng.normal(0, 0.05, (K, 3))).astype(np.float32)
    # One invalid edge and one invalid point, as the mapper's padding makes.
    ev = np.ones(K - 1, bool)
    ev[-1] = False
    pv = np.ones(n_pts, bool)
    pv[3] = False
    prob = prob._replace(state=prob.state._replace(R=jnp.asarray(Rp), p=jnp.asarray(pp),
                                                   v=jnp.asarray(vp)),
                         edges=prob.edges._replace(valid=jnp.asarray(ev)),
                         point_valid=jnp.asarray(pv))
    return prob, params


def test_solve_vi_ba_dense():
    """K = 6 keyframes, ~200 points, the dense branch: poses and points
    within 1e-3, velocities within 2e-3 m/s, biases within 1e-4, the same
    inliers, the cost within 1e-3 relative."""
    prob, params = _vi_problem()
    rj = vi_j.solve_vi_ba(cam_j.CameraModel.PINHOLE, params, prob, iters=6)
    rt = vi_t.solve_vi_ba(cam_t.CameraModel.PINHOLE, T(np.asarray(params)), problem_t(prob),
                          iters=6)
    np.testing.assert_allclose(rt.state.R.numpy(), np.asarray(rj.state.R), atol=1e-3)
    np.testing.assert_allclose(rt.state.p.numpy(), np.asarray(rj.state.p), atol=1e-3)
    np.testing.assert_allclose(rt.state.v.numpy(), np.asarray(rj.state.v), atol=2e-3)
    np.testing.assert_allclose(rt.state.bg.numpy(), np.asarray(rj.state.bg), atol=1e-4)
    np.testing.assert_allclose(rt.state.ba.numpy(), np.asarray(rj.state.ba), atol=1e-4)
    np.testing.assert_allclose(rt.points.numpy(), np.asarray(rj.points), atol=1e-3)
    assert np.array_equal(rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier))
    assert abs(float(rt.cost) / float(rj.cost) - 1) < 1e-3


def _same_vi(rt, rj, pts_atol=1e-3, cost_rtol=1e-3):
    """The dense test's tolerances (`pts_atol`, `cost_rtol` aside)."""
    R, p_, v, bg, ba_, pts, inl, cost = rt
    np.testing.assert_allclose(R, np.asarray(rj.state.R), atol=1e-3)
    np.testing.assert_allclose(p_, np.asarray(rj.state.p), atol=1e-3)
    np.testing.assert_allclose(v, np.asarray(rj.state.v), atol=2e-3)
    np.testing.assert_allclose(bg, np.asarray(rj.state.bg), atol=1e-4)
    np.testing.assert_allclose(ba_, np.asarray(rj.state.ba), atol=1e-4)
    np.testing.assert_allclose(pts, np.asarray(rj.points), atol=pts_atol)
    assert np.array_equal(inl, np.asarray(rj.obs_inlier)[:len(inl)])
    assert abs(float(cost) / float(rj.cost) - 1) < cost_rtol


def _vi_fields(r):
    return (r.state.R.numpy(), r.state.p.numpy(), r.state.v.numpy(), r.state.bg.numpy(),
            r.state.ba.numpy(), r.points.numpy(), r.obs_inlier.numpy(), float(r.cost))


def test_solve_vi_ba_pcg_matches_jax():
    """The matrix-free branch (`dense_solve=False`: 50 CG steps an LM
    iteration, block-Jacobi) against JAX's on the dense test's problem:
    poses, velocities, biases, inliers and cost at the dense test's
    tolerances; points within 2e-3 (the CG steps stop 0.1 m short of the
    dense solution on these 10 m deep points, and what is left moves with
    the float rounding of the last steps: 1.1e-3 here)."""
    prob, params = _vi_problem()
    rj = vi_j.solve_vi_ba(cam_j.CameraModel.PINHOLE, params, prob, iters=6, dense_solve=False)
    rt = vi_t.solve_vi_ba(cam_t.CameraModel.PINHOLE, T(np.asarray(params)), problem_t(prob),
                          iters=6, dense_solve=False)
    _same_vi(_vi_fields(rt), rj, pts_atol=2e-3)


@pytest.mark.parametrize("dense_solve", [True, False])
def test_solve_vi_ba_group_on_two_ranks(vi_two_ranks, dense_solve):
    """`solve_vi_ba(group=)` with the observations sharded over 2 ranks
    (gloo, `tests/dist_cases.py`), both branches: against the port's one-rank
    solve (summation order only: poses and velocities within 2e-3, biases
    within 1e-4, points within 5e-3, the same inliers, the cost within 1e-5
    relative) and against JAX's `solve_vi_ba` under `shard_map` with
    `axis_name` on 2 devices at the tests above's tolerances; both ranks
    equal."""
    import jax
    from jax.sharding import PartitionSpec as P

    from orbslam3_tpu.parallel.ba_sharded import make_mesh

    prob, params, d = vi_two_ranks["problem"]
    got = vi_two_ranks[dense_solve]
    r0 = got[0]
    for r in got[1:]:
        np.testing.assert_array_equal(r["points"], r0["points"])
    one = vi_t.solve_vi_ba(cam_t.CameraModel.PINHOLE, T(np.asarray(params)), problem_t(prob),
                           iters=6, dense_solve=dense_solve)
    g = (r0["state"]["R"], r0["state"]["p"], r0["state"]["v"], r0["state"]["bg"],
         r0["state"]["ba"], r0["points"], np.concatenate([r["obs_inlier"] for r in got]),
         float(r0["cost"]))
    for a, b, tol in zip(g[:6], _vi_fields(one)[:6], (2e-3, 2e-3, 2e-3, 1e-4, 1e-4, 5e-3)):
        np.testing.assert_allclose(a, b, atol=tol)
    O = len(d["obs_cam"])
    assert np.array_equal(g[6][:O], one.obs_inlier.numpy())
    assert abs(g[7] / float(one.cost) - 1) < 1e-5

    # JAX: the observations padded to a multiple of 2 and sharded over 2 devices.
    pad = (-O) % 2
    jp = prob._replace(**{k: jnp.concatenate([getattr(prob, k), jnp.full(
        (pad,) + getattr(prob, k).shape[1:], v, getattr(prob, k).dtype)])
        for k, v in (("obs_cam", 0), ("obs_point", 0), ("obs_uv", 0.0), ("obs_sigma2", 1.0),
                     ("obs_valid", False))})
    obs = ("obs_cam", "obs_point", "obs_uv", "obs_sigma2", "obs_valid")
    spec = jax.tree_util.tree_map(lambda _: P(), jp)._replace(**{k: P("x") for k in obs})
    out = vi_j.VIResult(state=jax.tree_util.tree_map(lambda _: P(), jp.state), points=P(),
                        cost=P(), obs_inlier=P("x"))
    fn = jax.jit(jax.shard_map(
        lambda pr, q: vi_j.solve_vi_ba(cam_j.CameraModel.PINHOLE, pr, q, iters=6,
                                       dense_solve=dense_solve, axis_name="x"),
        mesh=make_mesh(jax.devices()[:2], axis="x"), in_specs=(P(), spec), out_specs=out,
        check_vma=False))
    rj = fn(jnp.asarray(params), jp)
    _same_vi(g, rj, pts_atol=1e-3 if dense_solve else 2e-3)


@pytest.fixture(scope="module")
def vi_two_ranks():
    """Both branches of `solve_vi_ba(group=)` on 2 ranks, in one spawn."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import dist_cases

    from orbslam3_tpu_torch.parallel import launch

    prob, params = _vi_problem()

    def host(t):
        return {k: (host(v) if hasattr(v, "_fields") else np.array(v))
                for k, v in t._asdict().items()}

    d = host(prob)
    todo = [(dense, "vi_group", (d, np.array(params), dict(iters=6, dense_solve=dense)))
            for dense in (True, False)]
    res = launch.run(dist_cases.cases, 2, (todo,), device="cpu", threads=1)
    return {True: [r[True] for r in res], False: [r[False] for r in res],
            "problem": (prob, params, d)}


def test_lm_loop_accepts_and_rejects():
    """The reference's accept/reject schedule on a 1-d quadratic whose
    second step overshoots: lambda halves on accept, quadruples on reject."""
    from orbslam3_tpu.optim import lm as lm_j
    from orbslam3_tpu_torch.optim import lm as lm_t

    def run(lm_mod, xp, asarray):
        def cost(p):
            return xp.sum((p[0] - 3.0) ** 2)

        def step(p, lam):
            return (p[0] + (3.0 - p[0]) * 1.6 / (1.0 + lam * 10),)

        (x,), c = lm_mod.lm_loop((asarray([0.0, 1.0]),), cost, step, 6)
        return np.asarray(x), float(c)

    xj, cj = run(lm_j, jnp, lambda v: jnp.asarray(v, jnp.float32))
    xt, ct = run(lm_t, torch, lambda v: torch.tensor(v, dtype=torch.float32))
    np.testing.assert_allclose(xt, xj, rtol=1e-6)
    assert abs(ct - cj) <= 1e-6 * max(cj, 1e-6)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_inertial_only_jacobian_equals_torch_func(fix_scale):
    """The inertial-only MAP's hand-written Jacobian (`_init_rows`) against
    `torch.func.jacfwd` of its residuals, at a point off the seed (nonzero
    biases, direction and log-scale): within 1e-4 of the largest entry."""
    kf_R, kf_p, _, edges, _ = chain(5)
    et = edges_t(edges)
    K = len(kf_R)
    rng = np.random.default_rng(6)
    x = T(np.concatenate([rng.normal(0, 0.3, 3 * K), rng.normal(0, 0.01, 6),
                          [0.05, -0.03, 0.4]]), np.float32)
    L = torch.linalg.cholesky(et.info)
    Rwg0 = lie_t.exp_so3(torch.tensor([0.1, -0.05, 0.02]))
    valid = torch.ones(K - 1, dtype=torch.bool)
    valid[2] = False
    args = (T(kf_R), T(kf_p), et, valid, L, Rwg0, 1e2, 1e6, fix_scale)
    r, J = vi_t._init_rows(x, *args, jac=True)
    J_ad = torch.func.jacfwd(lambda y: vi_t._init_rows(y, *args))(x)
    np.testing.assert_allclose(r.numpy(), vi_t._init_rows(x, *args).numpy(), rtol=1e-6)
    np.testing.assert_allclose(J.numpy(), J_ad.numpy(), atol=1e-4 * float(J_ad.abs().max()))
