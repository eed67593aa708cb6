"""Port parity: the inertial support of the pipelines
(`orbslam3_tpu_torch.pipeline.inertial_support`) against the JAX package on
the CPU: the IMU queue and the per-gap preintegration, the camera <-> body
conversions, the state prediction, the map's gravity and scale alignment,
and the IMU initialization and scale refinement on a keyframe chain made as
`tests/test_inertial.py` makes it. Tolerances are stated per test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu.ops import lie as lie_j
from orbslam3_tpu.pipeline import inertial_support as is_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st_t
from orbslam3_tpu_torch.ops import imu as imu_t
from orbslam3_tpu_torch.pipeline import inertial_support as is_t
from tests.test_inertial import simulate_kf_chain

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

NOISE = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


def _rot(w):
    return np.asarray(lie_j.exp_so3(jnp.asarray(w, jnp.float32)))


def _extrinsics():
    return _rot([0.03, -0.02, 0.05]).astype(np.float32), np.array([0.04, -0.01, 0.02], np.float32)


def _calibs(Rbc, tbc):
    return imu_j.ImuCalib.create(Rbc, tbc, *NOISE), imu_t.ImuCalib.create(Rbc, tbc, *NOISE, device="cpu")


def test_queue_and_preintegrate_window():
    """The same pushes give the same windows (trimmed alike), and the port's
    per-gap preintegration (real samples only) equals the reference's
    (padded to PREINT_CAP) within 1e-5 of each array's largest entry."""
    rng = np.random.default_rng(0)
    cj, ct = _calibs(*_extrinsics())
    qj, qt = is_j.ImuQueue(), is_t.ImuQueue()
    for k in range(90):
        t = 0.0013 + k * 0.005
        a = np.array([0, 0, 9.81]) + rng.normal(0, 1, 3)
        w = rng.normal(0, 0.3, 3)
        qj.push(t, a, w)
        qt.push(t, a, w)
    bg = np.array([0.002, -0.001, 0.003], np.float32)
    ba = np.array([0.01, 0.02, -0.03], np.float32)
    for t0, t1 in ((0.05, 0.1), (0.1, 0.15), (0.15, 0.2), (0.4, 0.45)):
        pj = is_j.preintegrate_window(qj, t0, t1, bg, ba, cj)
        pt = is_t.preintegrate_window(qt, t0, t1, bg, ba, ct)
        assert qj.ts == qt.ts
        for name in pj._fields:
            w = np.asarray(getattr(pj, name))
            np.testing.assert_allclose(getattr(pt, name).numpy(), w, rtol=1e-5,
                                       atol=1e-5 * max(np.abs(w).max(), 1e-30), err_msg=name)
    assert is_t.preintegrate_window(qt, 5.0, 5.05, bg, ba, ct) is None
    assert is_j.preintegrate_window(qj, 5.0, 5.05, bg, ba, cj) is None


def test_conversions_and_prediction():
    """cam_to_body / body_to_cam on host arrays within 1e-6 of the
    reference's (and batched on tensors); `predict_state` on the device
    within 1e-5 of the reference's host prediction."""
    rng = np.random.default_rng(1)
    Rbc, tbc = _extrinsics()
    Rcw = _rot(rng.normal(0, 0.5, 3)).astype(np.float32)
    tcw = rng.normal(0, 1, 3).astype(np.float32)
    Rj, pj = is_j.cam_to_body(Rcw, tcw, Rbc, tbc)
    Rt, pt = is_t.cam_to_body(Rcw, tcw, Rbc, tbc)
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    Rc, tc = is_t.body_to_cam(Rt, pt, Rbc, tbc)
    np.testing.assert_allclose(Rc, np.asarray(is_j.body_to_cam(Rj, pj, Rbc, tbc)[0]), atol=1e-6)
    np.testing.assert_allclose(tc, tcw, atol=1e-5)
    Rb, pb = is_t.cam_to_body(torch.from_numpy(np.stack([Rcw, Rcw])),
                              torch.from_numpy(np.stack([tcw, 2 * tcw])),
                              torch.from_numpy(Rbc), torch.from_numpy(tbc))
    np.testing.assert_allclose(Rb[0].numpy(), Rj, atol=1e-6)
    np.testing.assert_allclose(pb[0].numpy(), pj, atol=1e-6)

    cj, ct = _calibs(Rbc, tbc)
    acc = (np.array([0, 0, 9.81]) + rng.normal(0, 1, (11, 3))).astype(np.float32)
    gyro = rng.normal(0, 0.3, (11, 3)).astype(np.float32)
    dt = np.full(11, 0.005, np.float32)
    pre_j = imu_j.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dt), jnp.zeros(3),
                            jnp.zeros(3), cj)
    pre_t = convert.preintegrated(pre_j, "cpu")
    v = np.array([0.3, -0.2, 0.1], np.float32)
    bg = np.array([0.001, 0.002, -0.001], np.float32)
    ba = np.array([0.02, -0.01, 0.01], np.float32)
    want = is_j.predict_state(Rj, pj, v, bg, ba, pre_j)
    got = is_t.predict_state(*(torch.from_numpy(np.asarray(x, np.float32))
                               for x in (Rj, pj, v, bg, ba)), pre_t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def _small_map(rng, Kmax=8, Pmax=32, Nf=4):
    s = st_j.empty_map(Kmax=Kmax, Pmax=Pmax, Nf=Nf)
    a = {k: np.array(v) for k, v in s._asdict().items()}
    a["kf_R"] = np.stack([_rot(rng.normal(0, 0.3, 3)) for _ in range(Kmax)]).astype(np.float32)
    a["kf_t"] = rng.normal(0, 1, (Kmax, 3)).astype(np.float32)
    a["kf_vel"] = rng.normal(0, 0.5, (Kmax, 3)).astype(np.float32)
    a["mp_pos"] = rng.normal(0, 3, (Pmax, 3)).astype(np.float32)
    nrm = rng.normal(0, 1, (Pmax, 3))
    a["mp_normal"] = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    a["mp_min_dist"] = rng.uniform(0.5, 1, Pmax).astype(np.float32)
    a["mp_max_dist"] = rng.uniform(2, 5, Pmax).astype(np.float32)
    return a


def test_apply_scaled_rotation():
    """Every transformed field within 1e-5 of the reference's."""
    rng = np.random.default_rng(2)
    a = _small_map(rng)
    Rwg = _rot([0.2, -0.1, 0.3]).astype(np.float32)
    sj = is_j.apply_scaled_rotation(st_j.MapState(**{k: jnp.asarray(v) for k, v in a.items()}),
                                    jnp.asarray(Rwg), 2.7)
    stt = is_t.apply_scaled_rotation(convert.to_torch(st_j.MapState(**a), "cpu", st_t.MapState),
                                     torch.from_numpy(Rwg), 2.7)
    for name in ("kf_R", "kf_t", "kf_vel", "mp_pos", "mp_normal", "mp_min_dist", "mp_max_dist"):
        np.testing.assert_allclose(getattr(stt, name).numpy(), np.asarray(getattr(sj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _chain_stores(seed: int, Kmax: int = 16):
    """Both packages' stores holding a keyframe chain of `simulate_kf_chain`
    (bodies = cameras offset by the extrinsics), seen in a map scaled by
    1/2.5 and rotated off gravity, with its per-keyframe windows."""
    rng = np.random.default_rng(seed)
    kf_R, kf_p, _, edges, _ = simulate_kf_chain(rng, n_kf=10, samples_per_kf=45)
    Rbc, tbc = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    Rwg_true = _rot([0.15, -0.1, 0.0])
    K = len(kf_R)
    a = {k: np.array(v) for k, v in st_j.empty_map(Kmax=Kmax, Pmax=64, Nf=4)._asdict().items()}
    for k in range(K):
        Rwb = Rwg_true.T @ kf_R[k]
        pwb = Rwg_true.T @ kf_p[k] / 2.5
        a["kf_R"][k], a["kf_t"][k] = is_j.body_to_cam(Rwb, pwb, Rbc, tbc)
        a["kf_valid"][k] = True
        a["kf_prev"][k] = k - 1
    a["mp_pos"] = rng.normal(0, 2, a["mp_pos"].shape).astype(np.float32)
    ts = np.arange(K) * 45 * 0.005
    store_j = st_j.MapStore(Kmax=Kmax, Pmax=64, Nf=4)
    store_j.state = st_j.MapState(**{k: jnp.asarray(v) for k, v in a.items()})
    store_t = st_t.MapStore(Kmax=Kmax, Pmax=64, Nf=4, device="cpu")
    store_t.state = convert.to_torch(st_j.MapState(**a), "cpu", st_t.MapState)
    for s in (store_j, store_t):
        s.n_kf = K
        s.kf_ts[:K] = ts
    pre_j = {k + 1: imu_j.Preintegrated(*(x[k] for x in _stacked(edges))) for k in range(K - 1)}
    pre_t = {k: convert.preintegrated(p, "cpu") for k, p in pre_j.items()}
    return store_j, store_t, pre_j, pre_t, Rbc, tbc


def _stacked(edges):
    """The windows behind `simulate_kf_chain`'s edges, as Preintegrated fields."""
    return (edges.dR, edges.dV, edges.dP, edges.JRg, edges.JVg, edges.JVa, edges.JPg, edges.JPa,
            _cov_of(edges), edges.dT, edges.bg0, edges.ba0)


def _cov_of(edges):
    """A 15x15 covariance whose inverses give the edges' informations."""
    C9 = np.linalg.inv(np.asarray(edges.info, np.float64))
    Crw = np.linalg.inv(np.asarray(edges.info_rw, np.float64))
    C = np.zeros((C9.shape[0], 15, 15))
    C[:, :9, :9], C[:, 9:, 9:] = C9, Crw
    return jnp.asarray(C.astype(np.float32))


@pytest.mark.parametrize("gate", ["ok", "too few keyframes", "too short"])
def test_try_initialize_and_refine_scale(gate):
    """The initialization on the same stores: the same verdict; then the
    scale within 1e-3 relative, the applied Rwg within 1e-3, keyframe poses
    within 1e-3, velocities within 1e-3 m/s and biases within 1e-4 of the
    reference's, the velocity and bias rows past n_kf untouched. The scale
    refinement on the result agrees likewise."""
    store_j, store_t, pre_j, pre_t, Rbc, tbc = _chain_stores(3)
    kw = {}
    if gate == "too few keyframes":
        kw = dict(min_kfs=11)
    elif gate == "too short":
        kw = dict(min_time=10.0)
    cj, ct = _calibs(Rbc, tbc)
    ij, it = is_j.ImuInitializer(cj), is_t.ImuInitializer(ct)
    ok_j = ij.try_initialize(store_j, pre_j, Rbc, tbc, **kw)
    ok_t = it.try_initialize(store_t, pre_t, Rbc, tbc, **kw)
    assert ok_t == ok_j == (gate == "ok") == it.initialized

    def compare(tag):
        (Rj, sj), (Rt, st) = ij.applied_transform, it.applied_transform
        assert abs(st / sj - 1) < 1e-3, (tag, st, sj)
        np.testing.assert_allclose(Rt, Rj, atol=1e-3)
        a, b = store_j.state, store_t.state
        for name, tol in (("kf_R", 1e-3), ("kf_t", 1e-3), ("kf_vel", 1e-3), ("kf_bias_g", 1e-4),
                          ("kf_bias_a", 1e-4), ("mp_pos", 1e-3)):
            np.testing.assert_allclose(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                       atol=tol, err_msg=f"{tag} {name}")
        assert not b.kf_vel[store_t.n_kf:].any()

    if gate != "ok":
        return
    compare("init")
    assert abs(it.applied_transform[1] - 2.5) / 2.5 < 0.05
    ij.applied_transform = it.applied_transform = None
    assert ij.refine_scale(store_j, pre_j, Rbc, tbc) == it.refine_scale(store_t, pre_t, Rbc, tbc)
    assert it.initialized
    compare("refine")
    assert abs(it.applied_transform[1] - 1.0) < 0.02


@pytest.mark.parametrize("drift", [1.0, 1.03])
def test_later_scale_refinements(drift):
    """The second and third `refine_scale` calls on a map whose first
    refinement ran, each from the same map in both packages (the port's
    store copied into the JAX one before the call), after a scale drift of
    the map (keyframe translations and points times `drift`): the applied
    scale (about 1 / drift) and gravity rotation, and the moved keyframe
    poses, velocities and points within 1e-4 of the reference's."""
    store_j, store_t, pre_j, pre_t, Rbc, tbc = _chain_stores(3)
    cj, ct = _calibs(Rbc, tbc)
    ij, it = is_j.ImuInitializer(cj), is_t.ImuInitializer(ct)
    assert ij.try_initialize(store_j, pre_j, Rbc, tbc) and it.try_initialize(store_t, pre_t,
                                                                             Rbc, tbc)
    assert ij.refine_scale(store_j, pre_j, Rbc, tbc) and it.refine_scale(store_t, pre_t, Rbc, tbc)
    for call in (2, 3):
        s = store_t.state
        store_t.state = s._replace(kf_t=s.kf_t * drift, mp_pos=s.mp_pos * drift)
        store_j.state = st_j.MapState(**{k: jnp.asarray(v.numpy())
                                         for k, v in store_t.state._asdict().items()})
        ij.applied_transform = it.applied_transform = None
        assert ij.refine_scale(store_j, pre_j, Rbc, tbc) and it.refine_scale(store_t, pre_t,
                                                                             Rbc, tbc)
        (Rj, sj), (Rt, s_t) = ij.applied_transform, it.applied_transform
        assert abs(s_t - sj) < 1e-4 and abs(s_t * drift - 1) < 0.01, (call, s_t, sj)
        np.testing.assert_allclose(Rt, Rj, atol=1e-4)
        for name in ("kf_R", "kf_t", "kf_vel", "kf_bias_g", "kf_bias_a", "mp_pos"):
            np.testing.assert_allclose(getattr(store_t.state, name).numpy(),
                                       np.asarray(getattr(store_j.state, name)), atol=1e-4,
                                       err_msg=f"call {call} {name}")
        drift = 1.0 + (drift - 1.0) / 2
