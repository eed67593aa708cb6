"""Vocabulary files — `orbslam3_tpu/io/vocab_io.py` copied in numpy (the
original imports `jax.numpy`, which the port may not): the DBoW2 binary
reader (`_read_binary_numpy`, `_assemble_vocabulary`) and writer (the numpy
branch of `save_binary_vocabulary`), and the reader of the stock
`ORBvoc.txt` text format (`load_text_vocabulary`). The binary layout is the
reference fork's (`TemplatedVocabulary.h:1442,1514`): a 24-byte header
(node count, record size, k, L, scoring, weighting), then one 41-byte record
per node after the root (i32 parent, 32-byte descriptor, f32 weight, u8
leaf flag). The reference parses and writes through its native library when
one is built; both give the same arrays and bytes (`tests/test_torch_vocab.py`).
"""

from __future__ import annotations

import numpy as np

from orbslam3_tpu_torch.ops.bow import Vocabulary, from_arrays

_HEADER_BYTES = 24
_RECORD = 41  # i32 parent + 32 B descriptor + f32 weight + u8 leaf


def read_binary(path: str):
    """(k, L, parent (n,), desc (n, 32), weight (n,), is_leaf (n,)) of the
    nodes after the root, in file order."""
    raw = np.fromfile(path, dtype=np.uint8)
    header = raw[:_HEADER_BYTES]
    nb_nodes = header[:4].view(np.uint32)[0]
    k, L = header[8:12].view(np.int32)[0], header[12:16].view(np.int32)[0]
    n = int(nb_nodes) - 1
    body = raw[_HEADER_BYTES : _HEADER_BYTES + n * _RECORD].reshape(n, _RECORD)
    parent = body[:, 0:4].copy().view(np.int32)[:, 0]
    desc = body[:, 4:36].copy()
    weight = body[:, 36:40].copy().view(np.float32)[:, 0]
    is_leaf = body[:, 40] != 0
    return int(k), int(L), parent, desc, weight, is_leaf


def assemble(k, L, parent, desc, weight, is_leaf) -> dict:
    """The flattened tree of a parent array, as numpy arrays: node ids in
    file order from 1 (0 = the root), children in file order per parent
    (a stable sort by parent; rank within a group = position - the group's
    first position), word ids in file order of the leaves."""
    n = len(parent)
    n_nodes = n + 1
    children = np.full((n_nodes, k), -1, np.int32)
    order = np.argsort(parent, kind="stable").astype(np.int64)
    ps = parent[order]
    first = np.zeros(n, np.int64)
    if n:
        new_grp = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
        first[new_grp] = new_grp
        first = np.maximum.accumulate(first)
    rank = np.arange(n, dtype=np.int64) - first
    ok = rank < k
    children[ps[ok], rank[ok]] = (order[ok] + 1).astype(np.int32)
    node_desc = np.zeros((n_nodes, 32), np.uint8)
    node_desc[1:] = desc
    node_word = np.full(n_nodes, -1, np.int32)
    word_ids = np.flatnonzero(is_leaf)
    node_word[word_ids + 1] = np.arange(len(word_ids), dtype=np.int32)
    return dict(node_desc=node_desc, node_children=children, node_word=node_word,
                word_weight=weight[word_ids].astype(np.float32), depth=int(L), k=int(k))


def load_binary_vocabulary(path: str, device) -> Vocabulary:
    """A DBoW2 binary vocabulary as the port's `Vocabulary` on `device`."""
    return from_arrays(**assemble(*read_binary(path)), device=device)


def load_text_vocabulary(path: str, device) -> Vocabulary:
    """A DBoW2 text vocabulary (the stock `ORBvoc.txt` format,
    `TemplatedVocabulary::loadFromTextFile`) as the port's `Vocabulary` on
    `device`: a header `k L scoring weighting`, then a node a line, `parent
    is_leaf d0..d31 weight`."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        data = np.asarray(f.read().split(), np.float64)
    rec = 2 + 32 + 1
    n = len(data) // rec
    data = data[: n * rec].reshape(n, rec)
    parent = data[:, 0].astype(np.int32)
    is_leaf = data[:, 1] != 0
    desc = data[:, 2:34].astype(np.uint8)
    weight = data[:, 34].astype(np.float32)
    return from_arrays(**assemble(k, L, parent, desc, weight, is_leaf), device=device)


def save_binary_vocabulary(path: str, voc: Vocabulary) -> None:
    """Write `voc` in the fork's binary format: each node's parent from the
    children table, node order kept, scoring and weighting 0."""
    children = voc.node_children.cpu().numpy()
    node_desc = voc.node_desc.cpu().numpy()
    node_word = voc.node_word.cpu().numpy()
    word_weight = voc.word_weight.cpu().numpy()
    n_nodes = len(node_desc)
    parent = np.zeros(n_nodes, np.int32)
    rows = np.repeat(np.arange(n_nodes, dtype=np.int32), children.shape[1])
    flat = children.reshape(-1)
    parent[flat[flat >= 0]] = rows[flat >= 0]
    is_leaf = node_word >= 0
    weight = np.zeros(n_nodes, np.float32)
    weight[is_leaf] = word_weight[node_word[is_leaf]]
    n = n_nodes - 1
    rec = np.zeros((n, _RECORD), np.uint8)
    rec[:, 0:4] = parent[1:].astype(np.int32).view(np.uint8).reshape(n, 4)
    rec[:, 4:36] = node_desc[1:].astype(np.uint8)
    rec[:, 36:40] = weight[1:].astype(np.float32).view(np.uint8).reshape(n, 4)
    rec[:, 40] = is_leaf[1:]
    with open(path, "wb") as f:
        f.write(np.asarray([n_nodes, _RECORD], np.uint32).tobytes())
        f.write(np.asarray([voc.k, voc.depth, 0, 0], np.int32).tobytes())
        f.write(rec.tobytes())
