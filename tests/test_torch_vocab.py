"""Port parity: the vocabulary reader (`orbslam3_tpu_torch/io/vocab_io.py`,
a numpy copy of the reference's binary reader) against the JAX package's
`load_binary_vocabulary` on both vocabularies of `assets/`, every array
exact; `convert.vocabulary` carries a JAX `Vocabulary` over unchanged, and
the npz cache reads the same tree."""

import os

import numpy as np
import pytest
import torch

from orbslam3_tpu.io import vocab_io as vio_j
from orbslam3_tpu.ops import bow as bow_j
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
