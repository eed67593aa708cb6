"""Port parity: geometry (lie, cameras), static tables, conversion and the
kernel-dispatch rule of `orbslam3_tpu_torch`, against the JAX package on
the CPU. Inputs are drawn with numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import cameras as cam_j
from orbslam3_tpu.ops import features as feat_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.device import require_cuda
from orbslam3_tpu_torch.ops import cameras as cam_t
from orbslam3_tpu_torch.ops import cuda_fast, cuda_match
from orbslam3_tpu_torch.ops import features as feat_t
from orbslam3_tpu_torch.ops import lie as lie_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

# float32 results of the same formulas evaluated by two libraries: 1e-5
# relative, with 1e-6 absolute for entries that cancel to ~0.
TOL = dict(rtol=1e-5, atol=1e-6)

EUROC_DISTORTED = [458.654, 457.296, 367.215, 248.375, -0.28340811, 0.07395907,
                   0.00019359, 1.76187114e-05]


def _w(rng, n=64, scale=2.0):
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * rng.uniform(0.0, scale, size=(n, 1))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _rotations(rng, n=32):
    return np.asarray(lie_j.exp_so3(jnp.asarray(_w(rng, n, 3.0))))


@pytest.mark.parametrize("fn", ["hat", "exp_so3"])
def test_so3_functions_match(fn):
    w = _w(np.random.default_rng(1))
    w[:2] = [[1e-9, -1e-9, 1e-10], [0.0, 0.0, 0.0]]  # small-angle branch
    ref = np.asarray(getattr(lie_j, fn)(jnp.asarray(w)))
    got = getattr(lie_t, fn)(_t(w)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_exp_se3_matches():
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=(64, 3)), _w(rng)], -1).astype(np.float32)
    xi[0, 3:] = 0.0
    R_r, t_r = lie_j.exp_se3(jnp.asarray(xi))
    R_g, t_g = lie_t.exp_se3(_t(xi))
    np.testing.assert_allclose(R_g.numpy(), np.asarray(R_r), **TOL)
    np.testing.assert_allclose(t_g.numpy(), np.asarray(t_r), **TOL)


def test_quaternion_and_normalize_rotation_match():
    rng = np.random.default_rng(3)
    R = _rotations(rng)
    # Drifted near-rotations exercise the re-orthonormalisation.
    Rd = (R + rng.normal(0, 1e-3, R.shape)).astype(np.float32)
    for fn, x in (("quat_from_mat", R), ("normalize_rotation", Rd)):
        ref = np.asarray(getattr(lie_j, fn)(jnp.asarray(x)))
        np.testing.assert_allclose(getattr(lie_t, fn)(_t(x)).numpy(), ref, **TOL)
    q = np.asarray(lie_j.quat_from_mat(jnp.asarray(R)))
    np.testing.assert_allclose(lie_t.mat_from_quat(_t(q)).numpy(),
                               np.asarray(lie_j.mat_from_quat(jnp.asarray(q))), **TOL)


def test_se3_apply_inv_compose_match():
    rng = np.random.default_rng(4)
    Ra, Rb = _rotations(rng, 8), _rotations(rng, 8)
    ta, tb = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    p = rng.normal(size=(8, 3)).astype(np.float32)
    J, T = jnp.asarray, _t
    np.testing.assert_allclose(lie_t.se3_apply(T(Ra), T(ta), T(p)).numpy(),
                               np.asarray(lie_j.se3_apply(J(Ra), J(ta), J(p))), **TOL)
    for got, ref in zip(lie_t.se3_inv(T(Ra), T(ta)), lie_j.se3_inv(J(Ra), J(ta))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for got, ref in zip(lie_t.se3_compose(T(Ra), T(ta), T(Rb), T(tb)),
                        lie_j.se3_compose(J(Ra), J(ta), J(Rb), J(tb))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # One pose applied to a whole point array (the pose solve's broadcast).
    P = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_allclose(lie_t.se3_apply(T(Ra[0]), T(ta[0]), T(P)).numpy(),
                               np.asarray(lie_j.se3_apply(J(Ra[0]), J(ta[0]), J(P))), **TOL)


@pytest.mark.parametrize("distorted", [False, True])
def test_pinhole_project_and_jacobian_match(distorted):
    rng = np.random.default_rng(5)
    z = rng.uniform(0.5, 10.0, 256)
    Xc = np.stack([rng.uniform(-0.6, 0.6, 256) * z, rng.uniform(-0.45, 0.45, 256) * z, z],
                  -1).astype(np.float32)
    k = EUROC_DISTORTED if distorted else EUROC_DISTORTED[:4]
    pj, pt = cam_j.make_pinhole(*k), cam_t.make_pinhole(*k)
    M_j, M_t = cam_j.CameraModel.PINHOLE, cam_t.CameraModel.PINHOLE
    np.testing.assert_allclose(cam_t.project(M_t, pt, _t(Xc)).numpy(),
                               np.asarray(cam_j.project(M_j, pj, jnp.asarray(Xc))), **TOL)
    np.testing.assert_allclose(cam_t.project_jac(M_t, pt, _t(Xc)).numpy(),
                               np.asarray(cam_j.project_jac(M_j, pj, jnp.asarray(Xc))),
                               rtol=1e-5, atol=1e-4)  # entries up to ~1e3 px/m
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


@pytest.mark.parametrize("n_features,n_levels", [(1024, 8), (300, 3), (1000, 8)])
def test_static_tables_equal(n_features, n_levels):
    np.testing.assert_array_equal(feat_t._FAST_OFFSETS, feat_j._FAST_OFFSETS)
    np.testing.assert_array_equal(feat_t._PATTERN, feat_j._PATTERN)
    for a, b in zip(feat_t._ic_weights(feat_t._PATCH, feat_t._PCTR),
                    feat_j._ic_weights(feat_j._PATCH, feat_j._PCTR)):
        np.testing.assert_array_equal(a, b)
    po_t = feat_t.OrbParams(n_features=n_features, n_levels=n_levels)
    po_j = feat_j.OrbParams(n_features=n_features, n_levels=n_levels)
    assert list(feat_t.level_budgets(po_t)) == list(feat_j.level_budgets(po_j))
    assert feat_t._atlas_layout(480, 752, po_t) == feat_j._atlas_layout(480, 752, po_j)
    np.testing.assert_array_equal(feat_t.scale_factors(po_t), feat_j.scale_factors(po_j))
    np.testing.assert_array_equal(feat_t.sigma2(po_t), feat_j.sigma2(po_j))
    if (n_features, n_levels) == (1024, 8):
        assert list(feat_t.level_budgets(po_t)) == [222, 185, 154, 129, 107, 89, 74, 64]


def test_convert_roundtrip_keeps_dtypes():
    from orbslam3_tpu.atlas import store as st_j
    from orbslam3_tpu_torch.atlas import store as st_t

    ref = st_j.empty_map(Kmax=4, Pmax=32, Nf=8)
    np_state = st_j.MapState(*(np.asarray(x) for x in ref))
    t_state = convert.to_torch(np_state, "cpu", st_t.MapState)
    back = convert.to_numpy(t_state)
    for name, a, b in zip(st_j.MapState._fields, np_state, back):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # The port's own empty map is the reference's, field by field.
    for name, a, b in zip(st_j.MapState._fields, np_state,
                          convert.to_numpy(st_t.empty_map(Kmax=4, Pmax=32, Nf=8))):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_require_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            require_cuda()


def test_kernel_wrappers_never_fall_back_off_cpu(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel; where the kernel
    cannot run (here: no nvcc for a build), the wrapper raises instead of
    running the plain version."""
    from orbslam3_tpu_torch.ops import _build

    def no_build():
        raise RuntimeError("no kernel library")

    monkeypatch.setattr(_build, "library", no_build)
    img = torch.zeros((64, 64), device="meta")
    n0, m0 = cuda_fast.LAUNCHES, cuda_match.LAUNCHES
    with pytest.raises(RuntimeError):
        cuda_fast.fast_score_nms(img, 7.0, 20.0)
    d = torch.zeros((16, 32), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError):
        cuda_match.hamming_top2(d, d)
    # Inputs the kernel would read through a wrong pointer are refused first.
    with pytest.raises(ValueError):
        cuda_match.hamming_top2(d, torch.zeros((16, 32), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cuda_match.hamming_top2(d, d, torch.ones(15, dtype=torch.bool, device="meta"))
    assert (cuda_fast.LAUNCHES, cuda_match.LAUNCHES) == (n0, m0)
    # The CPU path runs the plain version and counts no launch.
    cuda_fast.fast_score_nms(torch.zeros((16, 16)), 7.0, 20.0)
    assert cuda_fast.LAUNCHES == n0
