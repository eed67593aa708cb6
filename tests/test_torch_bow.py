"""Port parity: bag of words (`orbslam3_tpu_torch/ops/bow.py`) against the
JAX package on the CPU, on the 9,975-word tree of `assets/ORBvoc_synth.bin`.

Tolerances: `transform`'s word ids exact (random descriptors, invalid rows,
and descriptors equidistant from two sibling nodes, where the first child
must win); `bow_vector` and `score_l1` within 1e-6; `shared_words` exact
except in the C6 case (ROADMAP): an invalid descriptor (word -1) after a
valid word 0 makes the reference's scatter write False over word 0, and
the port, which sets the valid words only, counts it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_tpu.io import vocab_io as vio_j
from orbslam3_tpu.ops import bow as bow_j
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.ops import bow as bow_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

VOC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets",
                   "ORBvoc_synth.bin")


@pytest.fixture(scope="module")
def vocs():
    voc_j = vio_j.load_binary_vocabulary(VOC)
    return voc_j, convert.vocabulary(voc_j, "cpu")


def _popcount(x):
    return np.unpackbits(x, axis=-1).sum(-1)


def _midpoints(voc, rng, n):
    """Descriptors halfway (in Hamming distance) between two sibling nodes,
    their differing bits split evenly."""
    ch = np.asarray(voc.node_children)
    desc = np.asarray(voc.node_desc)
    parents = np.flatnonzero((ch >= 0).sum(1) >= 2)
    out = []
    for p in rng.choice(parents, n):
        a, b = rng.choice(ch[p][ch[p] >= 0], 2, replace=False)
        bits_a, bits_b = np.unpackbits(desc[a]), np.unpackbits(desc[b])
        diff = np.flatnonzero(bits_a != bits_b)
        take = rng.choice(diff, len(diff) // 2, replace=False)
        bits = bits_a.copy()
        bits[take] = bits_b[take]
        if len(diff) % 2:
            continue
        out.append(np.packbits(bits))
    return np.stack(out)


def _ties_at_argmin(voc, d):
    """How many descents meet a tie between their two nearest children."""
    ch, desc = np.asarray(voc.node_children), np.asarray(voc.node_desc)
    n_ties = 0
    for x in d:
        cur = 0
        for _ in range(voc.depth):
            kids = ch[cur][ch[cur] >= 0]
            if not len(kids):
                break
            dist = _popcount(desc[kids] ^ x)
            n_ties += int((dist == dist.min()).sum() > 1)
            cur = kids[np.argmin(dist)]
    return n_ties


def test_transform_exact(vocs):
    voc_j, voc_t = vocs
    rng = np.random.default_rng(0)
    d = np.concatenate([rng.integers(0, 256, (300, 32), dtype=np.uint8),
                        _midpoints(voc_j, rng, 400)])
    valid = rng.random(len(d)) > 0.1
    assert _ties_at_argmin(voc_j, d) > 20  # ties decided by the first child
    w_j = np.asarray(bow_j.transform(voc_j, jnp.asarray(d), jnp.asarray(valid)))
    w_t = bow_t.transform(voc_t, torch.from_numpy(d), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(w_t, w_j)
    assert (w_t[~valid] == -1).all() and (w_t[valid] >= 0).all()


def test_bow_vector_and_score(vocs):
    voc_j, voc_t = vocs
    rng = np.random.default_rng(1)
    words = rng.integers(-1, voc_j.n_words, (6, 500)).astype(np.int32)
    words[:, :40] = words[:, 40:80]  # repeated words: tf > 1
    v_j = np.stack([np.asarray(bow_j.bow_vector(voc_j, jnp.asarray(w))) for w in words])
    v_t = torch.stack([bow_t.bow_vector(voc_t, torch.from_numpy(w)) for w in words])
    np.testing.assert_allclose(v_t.numpy(), v_j, rtol=0, atol=1e-6)
    s_j = np.asarray(bow_j.score_l1(jnp.asarray(v_j[0]), jnp.asarray(v_j)))
    s_t = bow_t.score_l1(v_t[0], v_t).numpy()
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)
    assert abs(s_t[0] - 1.0) < 1e-6 and (s_t[1:] < 1.0).all()
    empty = bow_t.bow_vector(voc_t, torch.full((10,), -1, dtype=torch.int32))
    assert float(empty.abs().sum()) == 0.0


def test_shared_words_and_c6():
    rng = np.random.default_rng(2)
    mask = rng.random((8, 50)) > 0.7
    mask[:4, 0] = True  # word 0 present in rows 0-3
    q = rng.integers(1, 50, 30).astype(np.int32)
    q[:3] = -1  # invalid descriptors ...
    cases = {"no_word_0": q, "word_0_last": np.r_[q, 0].astype(np.int32),
             "c6_invalid_after_word_0": np.r_[0, q].astype(np.int32)}
    truth = {k: (mask & np.isin(np.arange(50), v[v >= 0])[None]).sum(1) for k, v in cases.items()}
    for k, v in cases.items():
        got_t = bow_t.shared_words(torch.from_numpy(v), torch.from_numpy(mask)).numpy()
        got_j = np.asarray(bow_j.shared_words(jnp.asarray(v), jnp.asarray(mask)))
        np.testing.assert_array_equal(got_t, truth[k], err_msg=k)
        if k.startswith("c6"):
            # The reference drops word 0 where an invalid row clips onto it
            # after the valid one: every row holding word 0 loses one (C6).
            assert mask[:, 0].sum() >= 4
            np.testing.assert_array_equal(got_j, truth[k] - mask[:, 0])
        else:
            np.testing.assert_array_equal(got_j, truth[k], err_msg=k)
