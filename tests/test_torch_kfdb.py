"""Port parity: the keyframe database (`orbslam3_tpu_torch/atlas/kfdb.py`)
against the JAX package on the CPU, on the 9,975-word tree.

`detect_candidates` is held on databases built so that ties decide the
result (fault C2): rows that repeat other rows (equal group scores, where
`lax.top_k` keeps the lowest index) and covisibility rows whose 10th
weight is tied. Tolerances: candidate ids exact, scores within 1e-6.
`KeyFrameDB.add`, `query` and `query_frame` are compared the same way."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.atlas import kfdb as kfdb_j
from orbslam3_tpu.io import vocab_io as vio_j
from orbslam3_tpu.ops import bow as bow_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.atlas import kfdb as kfdb_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth.bin")
K, NF = 24, 300


@pytest.fixture(scope="module")
def vocs():
    voc_j = vio_j.load_binary_vocabulary(VOC)
    return voc_j, convert.vocabulary(voc_j, "cpu")


def _db(voc_j, rng):
    """(word ids (K, NF), BoW rows (K, W), valid (K,), covis (K, K)): rows
    drawn around 4 places, rows 8-11 copies of rows 0-3, covisibility
    weights from a few values (ties at every rank)."""
    places = rng.integers(0, voc_j.n_words, (4, NF))
    words = places[np.arange(K) % 4].copy()
    noise = rng.random(words.shape) < 0.5
    words[noise] = rng.integers(0, voc_j.n_words, noise.sum())
    words[8:12] = words[0:4]
    words[rng.random(words.shape) < 0.05] = -1
    words = words.astype(np.int32)
    vecs = np.stack([np.asarray(bow_j.bow_vector(voc_j, jnp.asarray(w))) for w in words])
    valid = np.ones(K, bool)
    valid[[5, 17]] = False
    cov = rng.choice([0, 15, 20, 20, 30], (K, K))
    cov = np.triu(cov, 1)
    cov = (cov + cov.T).astype(np.int32)
    return words, vecs, valid, cov


def _cases(words):
    q_words = words[0].copy()
    q_words[:60] = words[8][:60]
    ex = np.zeros(K, bool)
    ex[[0, 1]] = True
    return [("self", words[0], np.eye(K, dtype=bool)[0]), ("mixed", q_words, ex),
            ("nothing_excluded", words[3], np.zeros(K, bool))]


@pytest.mark.parametrize("n_best", [3, 5])
def test_detect_candidates_with_ties(vocs, n_best):
    voc_j, voc_t = vocs
    words, vecs, valid, cov = _db(voc_j, np.random.default_rng(0))
    assert (np.sort(cov, 1)[:, -10] == np.sort(cov, 1)[:, -11]).any()  # tied 10th weight
    for name, q_words, ex in _cases(words):
        q_vec = np.asarray(bow_j.bow_vector(voc_j, jnp.asarray(q_words)))
        ids_j, sc_j = kfdb_j.detect_candidates(
            jnp.asarray(q_vec), jnp.asarray(q_words), jnp.asarray(vecs), jnp.asarray(valid),
            jnp.asarray(ex), jnp.asarray(cov), n_best=n_best)
        ids_t, sc_t = kfdb_t.detect_candidates(
            torch.from_numpy(np.array(q_vec)), torch.from_numpy(q_words), torch.from_numpy(vecs),
            torch.from_numpy(valid), torch.from_numpy(ex), torch.from_numpy(cov), n_best=n_best)
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j), err_msg=name)
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-6, err_msg=name)
        assert (ids_t.numpy() >= 0).sum() >= 1, name


def test_equal_group_scores_keep_the_lowest_row(vocs):
    """Rows 8-11 repeat rows 0-3 with the same covisibility: their group
    scores tie exactly, and both packages keep the lower row first."""
    voc_j, voc_t = vocs
    words, vecs, valid, _ = _db(voc_j, np.random.default_rng(1))
    cov = np.zeros((K, K), np.int32)
    q_words = words[2]
    q_vec = np.asarray(bow_j.bow_vector(voc_j, jnp.asarray(q_words)))
    ex = np.zeros(K, bool)
    args_j = [jnp.asarray(x) for x in (q_vec, q_words, vecs, valid, ex, cov)]
    ids_j, sc_j = kfdb_j.detect_candidates(*args_j, n_best=3)
    ids_t, sc_t = kfdb_t.detect_candidates(
        *(torch.from_numpy(np.array(x)) for x in (q_vec, q_words, vecs, valid, ex, cov)), n_best=3)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-6)
    assert list(ids_t.numpy()[:2]) == [2, 10]  # the tie, lowest row first


def test_keyframe_db_add_query_query_frame(vocs):
    voc_j, voc_t = vocs
    rng = np.random.default_rng(2)
    protos = rng.integers(0, 256, (4, NF, 32), dtype=np.uint8)
    db_j, db_t = kfdb_j.KeyFrameDB(voc_j, Kmax=K), kfdb_t.KeyFrameDB(voc_t, Kmax=K)
    descs = []
    for k in range(16):
        d = protos[k % 4].copy()
        flip = rng.random(d.shape) < 0.02
        d[flip] ^= np.uint8(1 << 3)
        v = rng.random(NF) > 0.05
        descs.append((d, v))
        w_j, vec_j = db_j.add(k, jnp.asarray(d), jnp.asarray(v))
        w_t, vec_t = db_t.add(k, torch.from_numpy(d), torch.from_numpy(v))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
        np.testing.assert_allclose(vec_t.numpy(), np.asarray(vec_j), rtol=0, atol=1e-6)
    db_j.erase(3)
    db_t.erase(3)
    cov = rng.choice([0, 10, 20, 40], (K, K))
    cov = np.triu(cov, 1)
    cov = (cov + cov.T).astype(np.int32)
    for kf in (0, 5, 13):
        ids_j, sc_j = db_j.query(kf, jnp.asarray(cov))
        ids_t, sc_t = db_t.query(kf, torch.from_numpy(cov))
        np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-6)
    d, v = descs[6]
    ids_j, sc_j = db_j.query_frame(jnp.asarray(d), jnp.asarray(v), jnp.asarray(cov))
    ids_t, sc_t = db_t.query_frame(torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(cov))
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=0, atol=1e-6)
    assert ids_t.numpy()[0] in (2, 6, 10, 14)  # a keyframe of the same place
