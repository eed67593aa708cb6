"""Port parity: Hamming matching (`orbslam3_tpu_torch.ops.matching`) and the
plain version of kernel B1 against the JAX package on the CPU. Distances
are small integers computed exactly on both sides, so everything compared
here is compared exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.ops import matching as mj
from orbslam3_tpu.ops import pallas_match as pm
from orbslam3_tpu_torch.ops import cuda_match
from orbslam3_tpu_torch.ops import matching as mt

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _desc(rng, n, pool=None):
    """Random descriptors; with `pool`, rows are noisy copies of pool rows so
    that close matches (and ties) exist."""
    if pool is None:
        return rng.integers(0, 256, (n, 32), dtype=np.uint8)
    return _noisy(rng, pool[rng.integers(0, len(pool), n)])


def _noisy(rng, rows):
    """Copies of `rows` with 5% of their bits flipped."""
    flips = (rng.random((len(rows), 32, 8)) < 0.05).astype(np.uint8)
    return rows ^ np.packbits(flips, axis=-1, bitorder="little")[..., 0]


def _window(rng, n, m):
    return dict(
        uvq=rng.uniform(0, 640, (n, 2)).astype(np.float32),
        uvk=rng.uniform(0, 640, (m, 2)).astype(np.float32),
        rad=rng.uniform(30, 120, (n,)).astype(np.float32),
        octk=rng.integers(0, 8, (m,)).astype(np.int32),
        lo=rng.integers(0, 4, (n,)).astype(np.int32),
    )


@pytest.mark.parametrize("n,m,windowed", [(64, 256, False), (100, 777, False),
                                          (300, 1500, False), (100, 777, True)])
def test_plain_top2_equals_xla_best_two(n, m, windowed):
    """Every row, including rows whose window holds no valid key (d1 = d2 =
    1e9, j1 = 0 on both sides)."""
    rng = np.random.default_rng(n + m)
    db = _desc(rng, m)
    da = _desc(rng, n, pool=db)
    vb = rng.random(m) > 0.2
    D = mj._mask_matrix(mj.hamming_matrix(jnp.asarray(da), jnp.asarray(db)), None,
                        jnp.asarray(vb))
    win = None
    if windowed:
        w = _window(rng, n, m)
        w["rad"] = rng.uniform(2, 25, n).astype(np.float32)  # small: some windows empty
        hi = w["lo"] + 2
        D = jnp.where(mj.window_mask(*(jnp.asarray(w[k]) for k in ("uvq", "uvk", "rad", "octk",
                                                                    "lo")), jnp.asarray(hi)),
                      D, mj.INF)
        win = cuda_match.MatchWindow(*(_t(w[k]) for k in ("uvq", "uvk", "rad", "octk", "lo")),
                                     _t(hi))
    ref = [np.asarray(x) for x in mj.best_two(D)]
    got = [x.numpy() for x in cuda_match.hamming_top2(_t(da), _t(db), _t(vb), win)]
    if windowed:
        assert 0 < (ref[0] >= 1e9).sum() < n  # both kinds of rows occur
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("windowed", [False, True])
def test_plain_top2_equals_pallas_interpret_on_valid_rows(windowed):
    """The Pallas kernel adds its 1e9 penalty to the distance instead of
    replacing it, so rows whose best key is invalid differ in d1; rows with
    a valid best are equal in d1, d2 and j1."""
    rng = np.random.default_rng(7)
    n, m = 90, 600
    db = _desc(rng, m)
    da = _desc(rng, n, pool=db)
    vb = rng.random(m) > 0.1
    w = _window(rng, n, m)
    win_j = win_t = None
    if windowed:
        win_j = pm.MatchWindow(*(jnp.asarray(w[k]) for k in ("uvq", "uvk", "rad", "octk", "lo")),
                               jnp.asarray(w["lo"] + 2))
        win_t = cuda_match.MatchWindow(*(_t(w[k]) for k in ("uvq", "uvk", "rad", "octk", "lo")),
                                       _t(w["lo"] + 2))
    ref = [np.asarray(x) for x in pm.hamming_top2(jnp.asarray(da), jnp.asarray(db),
                                                  valid_b=jnp.asarray(vb), window=win_j,
                                                  interpret=True)]
    got = [x.numpy() for x in cuda_match.hamming_top2(_t(da), _t(db), _t(vb), win_t)]
    rows = got[0] < 1e9
    assert rows.sum() > n // 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[rows], r[rows])
    # second-best also agrees wherever it is a real distance
    both = rows & (got[1] < 1e9)
    np.testing.assert_array_equal(got[1][both], ref[1][both])


@pytest.mark.parametrize("ratio,max_dist", [(0.9, 100.0), (0.8, 100.0), (0.85, 80.0)])
def test_search_by_projection_equal(ratio, max_dist):
    rng = np.random.default_rng(int(ratio * 100))
    n, m = 400, 300
    dk = _desc(rng, m)
    # Queries are noisy copies of keys, predicted near them, so windows
    # hold their true match among random neighbours.
    src = rng.integers(0, m, n)
    dq = _noisy(rng, dk[src])
    dq[: n // 2] = _desc(rng, n // 2, pool=dk)  # half are decoys
    vq, vk = rng.random(n) > 0.1, rng.random(m) > 0.1
    w = _window(rng, n, m)
    w["uvk"] = rng.uniform(0, 160, (m, 2)).astype(np.float32)
    w["uvq"] = (w["uvk"][src] + rng.normal(0, 5, (n, 2))).astype(np.float32)
    w["rad"] = rng.uniform(5, 40, (n,)).astype(np.float32)
    w["lo"] = np.clip(w["octk"][src] - rng.integers(0, 2, n), 0, None).astype(np.int32)
    hi = w["lo"] + 2
    ref = mj.search_by_projection(
        jnp.asarray(dq), jnp.asarray(w["uvq"]), jnp.asarray(vq), jnp.asarray(dk),
        jnp.asarray(w["uvk"]), jnp.asarray(vk), jnp.asarray(w["rad"]),
        octave_kp=jnp.asarray(w["octk"]), octave_lo=jnp.asarray(w["lo"]),
        octave_hi=jnp.asarray(hi), max_dist=max_dist, ratio=ratio,
    )
    got = mt.search_by_projection(
        _t(dq), _t(w["uvq"]), _t(vq), _t(dk), _t(w["uvk"]), _t(vk), _t(w["rad"]),
        octave_kp=_t(w["octk"]), octave_lo=_t(w["lo"]), octave_hi=_t(hi),
        max_dist=max_dist, ratio=ratio,
    )
    assert np.asarray(ref.valid).sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    ok = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.dist.numpy()[ok], np.asarray(ref.dist)[ok])
    # assign_unique on top of it (column conflicts are common here)
    ref_u = mj.assign_unique(ref, m)
    got_u = mt.assign_unique(got, m)
    np.testing.assert_array_equal(got_u.valid.numpy(), np.asarray(ref_u.valid))
    np.testing.assert_array_equal(got_u.idx.numpy(), np.asarray(ref_u.idx))


@pytest.mark.parametrize("ratio", [0.7, 0.9])
def test_cross_checked_match_nn_equal(ratio):
    """The port's unmasked cross-check runs the top-2 twice with operands
    swapped (kernel B1's route); the reference takes the dense column
    argmin. They agree on idx and valid."""
    rng = np.random.default_rng(int(ratio * 10))
    n, m = 300, 320
    db = _desc(rng, m)
    da = _desc(rng, n, pool=db)
    va, vb = rng.random(n) > 0.15, rng.random(m) > 0.15
    ref = mj.match_nn(jnp.asarray(da), jnp.asarray(db), jnp.asarray(va), jnp.asarray(vb),
                      max_dist=mj.TH_LOW, ratio=ratio, cross_check=True)
    got = mt.match_nn(_t(da), _t(db), _t(va), _t(vb), max_dist=mt.TH_LOW, ratio=ratio,
                      cross_check=True)
    assert np.asarray(ref.valid).sum() > 20
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))
    ref_u, got_u = mj.assign_unique(ref, m), mt.assign_unique(got, m)
    np.testing.assert_array_equal(got_u.idx.numpy(), np.asarray(ref_u.idx))


def test_masked_match_nn_equal():
    """`match_nn` with an arbitrary (N,M) mask stays dense tensor code."""
    rng = np.random.default_rng(3)
    n, m = 200, 240
    db = _desc(rng, m)
    da = _desc(rng, n, pool=db)
    mask = rng.random((n, m)) > 0.3
    ref = mj.match_nn(jnp.asarray(da), jnp.asarray(db), extra_mask=jnp.asarray(mask))
    got = mt.match_nn(_t(da), _t(db), extra_mask=_t(mask))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(ref.idx))


def test_hamming_matrix_exact():
    rng = np.random.default_rng(4)
    da, db = _desc(rng, 50), _desc(rng, 70)
    np.testing.assert_array_equal(
        mt.hamming_matrix(_t(da), _t(db)).numpy(),
        np.asarray(mj.hamming_matrix_xor(jnp.asarray(da), jnp.asarray(db))),
    )
