"""Port parity: the map store's derived structures and mutations
(`atlas/store.py`) against the JAX package on the CPU, on a seeded small
map: Kmax 16, Pmax 512, Nf 64, rows that list a point twice, invalid
features and keyframes.

Tolerances: integers and bools exact, floats within 1e-5. Two documented
differences: `add_points` writes only its valid rows, so the dump slot
(`Pmax - 1`, which padded rows aim at) is left out of that comparison; and
`replace_points` repairs C6, so a batch that replaces point 0 is checked on
its own (`test_replace_points_c6_point_zero`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.atlas import store as st_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import store as st_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

K, P, NF = 16, 512, 64
SCALE = (1.2 ** np.arange(8)).astype(np.float32)


def _map(seed=0, n_kf=12, n_mp=400):
    """numpy MapState: n_kf keyframes observing n_mp points (consistent
    geometry, noisy descriptors), with duplicates, holes and one invalid
    keyframe."""
    rng = np.random.default_rng(seed)
    s = st_j.MapState(*(np.array(x) for x in st_j.empty_map(K, P, NF)))
    a = {k: np.array(v, copy=True) for k, v in s._asdict().items()}
    a["mp_pos"][:n_mp] = rng.uniform(-2, 2, (n_mp, 3)) + [0, 0, 6]
    a["mp_valid"][:n_mp] = rng.random(n_mp) > 0.05
    a["mp_desc"][:n_mp] = rng.integers(0, 256, (n_mp, 32), dtype=np.uint8)
    a["mp_found"][:n_mp] = rng.integers(0, 20, n_mp)
    a["mp_visible"][:n_mp] = a["mp_found"][:n_mp] + rng.integers(0, 20, n_mp)
    for k in range(n_kf):
        a["kf_valid"][k] = k != 5
        a["kf_t"][k] = [0.2 * k, 0.05 * np.sin(k), 0.0]
        ids = rng.choice(n_mp, NF, replace=False).astype(np.int32)
        ids[rng.random(NF) < 0.2] = -1
        ids[3] = ids[7]  # a row that lists one point twice
        a["kf_mp"][k] = ids
        a["kf_feat_valid"][k] = rng.random(NF) > 0.1
        a["kf_octave"][k] = rng.integers(0, 8, NF)
        a["kf_uv"][k] = rng.uniform(0, 600, (NF, 2))
        flips = (rng.random((NF, 32, 8)) < 0.05).astype(np.uint8)
        noise = np.packbits(flips, axis=-1, bitorder="little")[..., 0]
        a["kf_desc"][k] = a["mp_desc"][np.clip(ids, 0, None)] ^ noise
    return st_j.MapState(**a)


def _j(s):
    return st_j.MapState(*(jnp.asarray(x) for x in s))


def _t(s):
    return convert.to_torch(s, "cpu", st_t.MapState)


def _assert_state_equal(got, ref, skip_rows=None):
    for name, g, r in zip(st_t.MapState._fields, got, ref):
        g, r = g.numpy(), np.asarray(r)
        if skip_rows is not None and name.startswith("mp_"):
            keep = np.ones(len(r), bool)
            keep[skip_rows] = False
            g, r = g[keep], r[keep]
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_derived_structures(seed):
    s = _map(seed)
    np.testing.assert_array_equal(st_t.obs_indicator(_t(s)).numpy(),
                                  np.asarray(st_j.obs_indicator(_j(s)), np.float32))
    W = st_t.covisibility(_t(s)).numpy()
    np.testing.assert_array_equal(W, np.asarray(st_j.covisibility(_j(s))))
    assert W.max() > 0 and (np.diag(W) == 0).all()
    np.testing.assert_array_equal(st_t.point_observers(_t(s)).numpy(),
                                  np.asarray(st_j.point_observers(_j(s))))
    for g, r in zip(st_t.observer_table(_t(s)), st_j.observer_table(_j(s))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_observer_table_caps_at_maxobs():
    """A point seen by more than MAXOBS keyframes keeps its first MAXOBS."""
    s = _map(2)
    a = {k: np.array(v, copy=True) for k, v in s._asdict().items()}
    a["kf_valid"][:] = True
    a["kf_mp"][:, 0] = 7
    a["kf_feat_valid"][:, 0] = True
    s = st_j.MapState(**a)
    got = st_t.observer_table(_t(s))
    ref = st_j.observer_table(_j(s))
    assert (got[0].numpy()[7] >= 0).sum() == st_t.MAXOBS
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_add_keyframe_and_erase_keyframe():
    s = _map(3)
    rng = np.random.default_rng(3)
    row = dict(R=np.eye(3, dtype=np.float32), t=np.asarray([0.1, 0.2, 0.3], np.float32),
               uv=rng.uniform(0, 600, (NF, 2)).astype(np.float32),
               ur=np.full(NF, -1.0, np.float32), octave=rng.integers(0, 8, NF).astype(np.int32),
               angle=rng.uniform(0, 6, NF).astype(np.float32),
               desc=rng.integers(0, 256, (NF, 32), dtype=np.uint8),
               feat_valid=rng.random(NF) > 0.2,
               mp_assoc=rng.integers(-1, 400, NF).astype(np.int32))
    ref = st_j.add_keyframe(_j(s), jnp.asarray(13), *(jnp.asarray(v) for v in row.values()),
                            prev_kf=11)
    got = st_t.add_keyframe(_t(s), 13, *(torch.from_numpy(v) for v in row.values()), prev_kf=11)
    _assert_state_equal(got, ref)
    _assert_state_equal(st_t.erase_keyframe(got, 4), st_j.erase_keyframe(ref, jnp.asarray(4)))


def test_add_points_with_padding_to_the_dump_slot():
    """Triangulation's fixed-size insert: 40 real rows, then padding that
    aims at the dump slot with `valid` False."""
    s = _map(4)
    rng = np.random.default_rng(4)
    n, cap = 40, 64
    slots = np.concatenate([np.arange(420, 420 + n), np.full(cap - n, P - 1)]).astype(np.int32)
    rows = [slots, rng.uniform(-1, 1, (cap, 3)).astype(np.float32),
            rng.integers(0, 256, (cap, 32), dtype=np.uint8),
            rng.normal(size=(cap, 3)).astype(np.float32), rng.uniform(0, 1, cap).astype(np.float32),
            rng.uniform(1, 5, cap).astype(np.float32), np.full(cap, 9, np.int32),
            np.arange(cap) < n]
    ref = st_j.add_points(_j(s), *(jnp.asarray(v) for v in rows))
    got = st_t.add_points(_t(s), *(torch.from_numpy(v) for v in rows))
    _assert_state_equal(got, ref, skip_rows=[P - 1])
    assert got.mp_valid[420 : 420 + n].all() and not got.mp_valid[P - 1]


def test_erase_points():
    s = _map(5)
    ids = np.asarray([3, 17, 17, 250, 0, 0, 0, 0], np.int32)
    mask = np.asarray([1, 1, 1, 1, 0, 0, 0, 0], bool)
    ref = st_j.erase_points(_j(s), jnp.asarray(ids), jnp.asarray(mask))
    got = st_t.erase_points(_t(s), torch.from_numpy(ids), torch.from_numpy(mask))
    _assert_state_equal(got, ref)
    assert not got.mp_valid[17] and not (got.kf_mp == 17).any() and got.mp_valid[0] == s.mp_valid[0]


def _replace_batch(src, dst, cap=32):
    pad = cap - len(src)
    return (np.concatenate([src, np.full(pad, -1)]).astype(np.int32),
            np.concatenate([dst, np.full(pad, -1)]).astype(np.int32),
            np.arange(cap) < len(src))


@pytest.mark.parametrize("seed", [6, 7])
def test_replace_points(seed):
    """A batch without point 0 (padded with -1, as `resolve_and_replace`
    pads it): rewiring, row dedupe, stats transfer and invalidation equal."""
    s = _map(seed)
    batch = _replace_batch([12, 40, 41, 300], [13, 44, 44, 12 + 1])
    ref = st_j.replace_points(_j(s), *(jnp.asarray(v) for v in batch))
    got = st_t.replace_points(_t(s), *(torch.from_numpy(v) for v in batch))
    _assert_state_equal(got, ref)
    assert not got.mp_valid[40] and not (got.kf_mp == 40).any()


def test_replace_points_c6_point_zero():
    """Fault C6: a live replacement of point 0 in a padded batch. The port
    rewires point 0's observations to its destination and invalidates it;
    the JAX package drops that replacement (the padded rows clip to point 0
    and write its old lookup entry and validity back after it), and agrees
    with the port everywhere else."""
    s = _map(8)
    a = {k: np.array(v, copy=True) for k, v in s._asdict().items()}
    a["kf_mp"][2, 5] = 0
    a["kf_mp"][6, 9] = 0
    a["mp_valid"][0] = True
    s = st_j.MapState(**a)
    batch = _replace_batch([0, 40], [90, 44])
    ref = st_j.replace_points(_j(s), *(jnp.asarray(v) for v in batch))
    got = st_t.replace_points(_t(s), *(torch.from_numpy(v) for v in batch))
    touched = np.asarray(s.kf_mp) == 0
    assert not bool(got.mp_valid[0]) and not (got.kf_mp == 0).any()
    assert int(got.kf_mp[2, 5]) in (90, -1) and int(got.kf_mp[6, 9]) in (90, -1)
    assert bool(np.asarray(ref.mp_valid)[0])
    np.testing.assert_array_equal(np.asarray(ref.kf_mp)[touched], 0)
    # Point 40's replacement and everything off point 0 agree.
    np.testing.assert_array_equal(got.kf_mp.numpy()[~touched], np.asarray(ref.kf_mp)[~touched])
    keep = np.arange(P) != 0
    np.testing.assert_array_equal(got.mp_valid.numpy()[keep], np.asarray(ref.mp_valid)[keep])
    np.testing.assert_array_equal(got.mp_found.numpy()[keep & (np.arange(P) != 90)],
                                  np.asarray(ref.mp_found)[keep & (np.arange(P) != 90)])


def test_refresh_points_and_map_store():
    """`refresh_points` (observer table + distinctive descriptor, normal,
    scale band) through both MapStores, chunked at cap 8 with dump-slot
    padding, and the stores' allocators and mirrors."""
    s = _map(9)
    store_j = st_j.MapStore(Kmax=K, Pmax=P, Nf=NF)
    store_t = st_t.MapStore(Kmax=K, Pmax=P, Nf=NF, device="cpu")
    store_j.state, store_t.state = _j(s), _t(s)
    cand = np.concatenate([np.arange(0, 400, 7), [P - 1, 3, 3]])
    st_j.refresh_points(store_j, cand, jnp.asarray(SCALE), cap=8)
    st_t.refresh_points(store_t, cand, torch.from_numpy(SCALE), cap=8)
    _assert_state_equal(store_t.state, store_j.state)
    assert not np.array_equal(store_t.state.mp_desc.numpy(), s.mp_desc)  # it did refresh

    for fn in ("covisibility_np", "point_observers_np", "kf_mp_np"):
        np.testing.assert_array_equal(getattr(store_t, fn)(), getattr(store_j, fn)())
    for store in (store_j, store_t):
        store.n_kf, store.n_mp = 12, 400
        store.free_kf_slots.append(5)
        store.free_mp_slots.extend([17, 3])
    assert [store_t.alloc_kf(), store_t.alloc_kf()] == [store_j.alloc_kf(), store_j.alloc_kf()]
    np.testing.assert_array_equal(store_t.alloc_mps(5), store_j.alloc_mps(5))
    assert store_t.dump_slot == store_j.dump_slot == P - 1
    with pytest.raises(RuntimeError):
        store_t.alloc_mps(P)
    # The mirrors follow `bump`.
    W0 = store_t.covisibility_np()
    store_t.state = st_t.erase_keyframe(store_t.state, 0)
    assert store_t.covisibility_np() is W0
    store_t.bump()
    assert store_t.covisibility_np()[0].sum() == 0
