"""Port parity: the vocabulary files (`orbslam3_tpu_torch/io/vocab_io.py`,
a numpy copy of the reference's) against the JAX package's: the binary
reader on both vocabularies of `assets/`, every array exact; the stock
`ORBvoc.txt` text format, written here from `assets/ORBvoc_synth.bin`,
read by both `load_text_vocabulary`s into equal arrays; the binary writer
byte for byte, read back by the JAX reader unchanged. `convert.vocabulary`
carries a JAX `Vocabulary` over unchanged, and the npz cache reads the same
tree. Also `ate.ate_scale` against `eval/ate.py`'s within 1e-9."""

import os

import numpy as np
import pytest
import torch

from orbslam3_tpu.eval import ate as ate_j
from orbslam3_tpu.io import vocab_io as vio_j
from orbslam3_tpu.ops import bow as bow_j
from orbslam3_tpu_torch import ate as ate_t
from orbslam3_tpu_torch import convert
from orbslam3_tpu_torch.io import vocab_io as vio_t
from orbslam3_tpu_torch.ops import bow as bow_t

torch.set_num_threads(1)  # the tier-1 run has 6 xdist workers

ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
FIELDS = ("node_desc", "node_children", "node_word", "word_weight")


def _same(voc_t, voc_j):
    assert (voc_t.depth, voc_t.k, voc_t.n_words) == (voc_j.depth, voc_j.k, voc_j.n_words)
    for k in FIELDS:
        a, b = getattr(voc_t, k).numpy(), np.asarray(getattr(voc_j, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", ["ORBvoc_synth.bin", "ORBvoc_synth_100k.bin"])
def test_binary_reader_equals_reference(name):
    path = os.path.join(ASSETS, name)
    voc_t = vio_t.load_binary_vocabulary(path, "cpu")
    _same(voc_t, vio_j.load_binary_vocabulary(path))
    assert voc_t.n_words == {"ORBvoc_synth.bin": 9975, "ORBvoc_synth_100k.bin": 97272}[name]


def test_convert_vocabulary_round_trip():
    voc_j = vio_j.load_binary_vocabulary(os.path.join(ASSETS, "ORBvoc_synth.bin"))
    _same(convert.vocabulary(voc_j, "cpu"), voc_j)


def test_npz_cache_reads_the_same_tree(tmp_path):
    voc_j = vio_j.load_binary_vocabulary(os.path.join(ASSETS, "ORBvoc_synth.bin"))
    path = str(tmp_path / "voc.npz")
    bow_j.save_npz(path, voc_j)
    _same(bow_t.load_npz(path, "cpu"), voc_j)


def _write_text_vocabulary(path, k, L, parent, desc, weight, is_leaf):
    """The stock text format of `TemplatedVocabulary::saveToTextFile`: `k L
    scoring weighting`, then `parent is_leaf d0 .. d31 weight` a node."""
    with open(path, "w") as f:
        f.write(f"{k} {L} 0 0\n")
        for p, leaf, d, w in zip(parent, is_leaf, desc, weight):
            f.write(f"{p} {int(leaf)} " + " ".join(str(int(x)) for x in d) + f" {w:.9g}\n")


def test_text_vocabulary_equals_reference(tmp_path):
    path = os.path.join(ASSETS, "ORBvoc_synth.bin")
    txt = str(tmp_path / "ORBvoc.txt")
    _write_text_vocabulary(txt, *vio_t.read_binary(path))
    voc_t = vio_t.load_text_vocabulary(txt, "cpu")
    _same(voc_t, vio_j.load_text_vocabulary(txt))
    _same(voc_t, vio_j.load_binary_vocabulary(path))  # the text holds the binary's tree


def test_binary_writer_equals_reference(tmp_path):
    path = os.path.join(ASSETS, "ORBvoc_synth.bin")
    voc_j = vio_j.load_binary_vocabulary(path)
    ours, theirs = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    vio_t.save_binary_vocabulary(ours, vio_t.load_binary_vocabulary(path, "cpu"))
    vio_j.save_binary_vocabulary(theirs, voc_j)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    _same(vio_t.load_binary_vocabulary(ours, "cpu"), vio_j.load_binary_vocabulary(ours))
    _same(vio_t.load_binary_vocabulary(path, "cpu"), vio_j.load_binary_vocabulary(ours))


@pytest.mark.parametrize("n", [2, 3, 40])
def test_ate_scale_equals_reference(n):
    rng = np.random.default_rng(n)
    gt_ts = np.arange(n) * 0.05
    gt_pos = rng.normal(0, 1, (n, 3))
    est_ts = gt_ts + rng.uniform(-0.005, 0.005, n)
    est_pos = 0.37 * gt_pos @ np.linalg.qr(rng.normal(0, 1, (3, 3)))[0].T + rng.normal(0, 0.01,
                                                                                         (n, 3))
    got = ate_t.ate_scale(est_ts, est_pos, gt_ts, gt_pos)
    ref = ate_j.ate_scale(est_ts, est_pos, gt_ts, gt_pos)
    if n < 3:
        assert np.isnan(got) and np.isnan(ref)
    else:
        assert abs(got - ref) <= 1e-9 and abs(got - 1 / 0.37) < 0.05
