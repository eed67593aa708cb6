"""Port parity: IMU preintegration (`orbslam3_tpu_torch.ops.imu`) against
the JAX package on the CPU, on the same seeded samples. Tolerance: float32,
1e-5 relative to each array's largest entry (rtol and atol both 1e-5 of
that scale: the covariance spans ten decades, and its smallest entries are
sums whose rounding the two compilers order differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import imu as imu_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import imu as imu_t
from orbslam3_tpu_torch.ops import lie as lie_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

NOISE = dict(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, freq=200.0)


def close(got, want, tol=1e-5):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def calibs(seed=0):
    rng = np.random.default_rng(seed)
    Rbc = np.asarray(lie_t.exp_so3(torch.tensor(rng.normal(0, 0.1, 3), dtype=torch.float32)))
    tbc = rng.normal(0, 0.05, 3)
    return (imu_j.ImuCalib.create(Rbc, tbc, **NOISE),
            imu_t.ImuCalib.create(Rbc, tbc, **NOISE, device="cpu"))


def samples(seed, n=11):
    rng = np.random.default_rng(seed)
    acc = (np.array([0.0, 0.0, 9.81]) + rng.normal(0, 0.8, (n, 3))).astype(np.float32)
    gyro = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    dt = np.full(n, 0.005, np.float32)
    dt[0], dt[-1] = 0.0031, 0.0019  # the borders of a frame gap
    bg = rng.normal(0, 0.003, 3).astype(np.float32)
    ba = rng.normal(0, 0.03, 3).astype(np.float32)
    return acc, gyro, dt, bg, ba


def both(seed, cj, ct, pad=0):
    acc, gyro, dt, bg, ba = samples(seed)
    n = len(dt)
    pj = imu_j.integrate(jnp.asarray(np.pad(acc, ((0, pad), (0, 0)))),
                         jnp.asarray(np.pad(gyro, ((0, pad), (0, 0)))),
                         jnp.asarray(np.pad(dt, (0, pad))), jnp.asarray(bg), jnp.asarray(ba), cj)
    pt = imu_t.integrate(*(torch.from_numpy(x) for x in (acc, gyro, dt, bg, ba)), ct)
    assert pt.dR.shape == (3, 3) and n == 11
    return pj, pt


def test_calib_create():
    cj, ct = calibs()
    for name in cj._fields:
        close(getattr(ct, name), getattr(cj, name), 1e-7)


@pytest.mark.parametrize("seed,pad", [(0, 0), (1, 0), (2, 53)])
def test_integrate(seed, pad):
    """The port loops over the real samples; the JAX package's window may be
    padded with dt = 0 rows (PREINT_CAP 64): the same result."""
    cj, ct = calibs(seed)
    pj, pt = both(seed, cj, ct, pad=pad)
    for name in pj._fields:
        close(getattr(pt, name), getattr(pj, name))


def test_padding_is_exact_noop_in_the_port():
    cj, ct = calibs()
    acc, gyro, dt, bg, ba = samples(3)
    t = [torch.from_numpy(x) for x in (acc, gyro, dt, bg, ba)]
    p0 = imu_t.integrate(*t, ct)
    pad = [torch.cat([t[0], torch.zeros(5, 3)]), torch.cat([t[1], torch.zeros(5, 3)]),
           torch.cat([t[2], torch.zeros(5)])]
    p1 = imu_t.integrate(*pad, t[3], t[4], ct)
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def test_deltas_merge_information():
    cj, ct = calibs(4)
    p1j, p1t = both(5, cj, ct)
    p2j, p2t = both(6, cj, ct)
    rng = np.random.default_rng(7)
    bg = rng.normal(0, 0.004, 3).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    bgt, bat = torch.from_numpy(bg), torch.from_numpy(ba)
    close(imu_t.delta_rotation(p1t, bgt), imu_j.delta_rotation(p1j, jnp.asarray(bg)))
    close(imu_t.delta_velocity(p1t, bgt, bat), imu_j.delta_velocity(p1j, bg, ba))
    close(imu_t.delta_position(p1t, bgt, bat), imu_j.delta_position(p1j, bg, ba))
    mj, mt = imu_j.merge(p1j, p2j, cj), imu_t.merge(p1t, p2t, ct)
    for name in mj._fields:
        close(getattr(mt, name), getattr(mj, name))
    close(imu_t.information_matrix(mt), imu_j.information_matrix(mj), 1e-4)


def test_convert_preintegrated():
    cj, _ = calibs()
    pj, _ = both(8, cj, calibs()[1])
    pt = convert.preintegrated(pj, "cpu")
    assert isinstance(pt, imu_t.Preintegrated)
    for name in pj._fields:
        np.testing.assert_array_equal(getattr(pt, name).numpy(), np.asarray(getattr(pj, name)))
    ct = convert.imu_calib(cj, "cpu")
    np.testing.assert_array_equal(ct.cov.numpy(), np.asarray(cj.cov))


@pytest.mark.parametrize("case", ["inside", "late_start", "early_end", "empty"])
def test_midpoint_samples_exact(case):
    rng = np.random.default_rng(9)
    ts = np.arange(0.0, 0.2, 0.005) + 0.0013
    acc = rng.normal(0, 1, (len(ts), 3))
    gyro = rng.normal(0, 1, (len(ts), 3))
    t0, t1 = {"inside": (0.05, 0.1), "late_start": (-0.01, 0.04),
              "early_end": (0.15, 0.25), "empty": (0.5, 0.6)}[case]
    got = imu_t.midpoint_samples(acc, gyro, ts, t0, t1)
    want = imu_j.midpoint_samples(acc, gyro, ts, t0, t1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
