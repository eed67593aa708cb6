"""Bag of binary words on torch tensors — the query side of
`orbslam3_tpu/ops/bow.py`: the flattened vocabulary tree, the batched
descent of descriptors to words (`transform`), the dense L1-normalised
tf-idf vector (`bow_vector`), DBoW2's L1 score (`score_l1`) and the
shared-word counts (`shared_words`). Training (`build_vocabulary`, binary
k-medians over descriptors) is a host-only numpy copy of the reference's,
the same tree array for array from the same descriptors and seed, for the
runner's `--train-vocab`; `save_npz` / `load_npz` write and read the npz
cache, `io/vocab_io.py` the binary files.

This is tensor code in the reference too (no Pallas kernel): each level of
`transform` is a gather of the ≤ k children, an (N, k, 32) XOR and a
popcount. PyTorch has no popcount, so the bytes go through a 256-entry
table. Ties in the per-level argmin go to the first child, as `jnp.argmin`
and `torch.argmin` both do.

Fault C6 (ROADMAP): the reference's `shared_words` writes
``q_mask.at[clip(w, 0)].set(ok)``, so an invalid descriptor (word -1)
clips to word 0 and may write False over a valid word 0. The port sets the
valid words only (a scatter-add of the valid flags, no host read).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbslam3_tpu_torch.device import require_cuda


class Vocabulary(NamedTuple):
    """Flattened vocabulary tree (tensors on one device).

    node_desc: (n_nodes, 32) uint8 cluster centres
    node_children: (n_nodes, k) int32 child node ids, -1 = none (a leaf's
        row is all -1)
    node_word: (n_nodes,) int32 word id of a leaf, -1 otherwise
    word_weight: (n_words,) float32 idf weights
    depth: levels of descent; k: branching factor
    """

    node_desc: torch.Tensor
    node_children: torch.Tensor
    node_word: torch.Tensor
    word_weight: torch.Tensor
    depth: int
    k: int

    @property
    def n_words(self) -> int:
        return self.word_weight.shape[0]


def from_arrays(node_desc, node_children, node_word, word_weight, depth, k, device) -> Vocabulary:
    """A `Vocabulary` on `device` from numpy arrays (or array-likes)."""
    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    return Vocabulary(node_desc=t(node_desc, np.uint8), node_children=t(node_children, np.int32),
                      node_word=t(node_word, np.int32), word_weight=t(word_weight, np.float32),
                      depth=int(depth), k=int(k))


def to_device(voc: Vocabulary, device) -> Vocabulary:
    """`voc` with its tables on `device` (itself when they are there)."""
    dev = torch.device(device)
    if voc.word_weight.device == dev:
        return voc
    return voc._replace(**{k: getattr(voc, k).to(dev) for k in
                           ("node_desc", "node_children", "node_word", "word_weight")})


def load_npz(path: str, device) -> Vocabulary:
    """A vocabulary cached by the reference's `bow.save_npz`."""
    d = np.load(path)
    return from_arrays(d["node_desc"], d["node_children"], d["node_word"], d["word_weight"],
                       int(d["depth"]), int(d["k"]), device)


_POPCOUNT = {}  # device -> (256,) int32 bits set per byte value


def save_npz(path: str, voc: Vocabulary):
    """Cache a vocabulary as the reference's npz (`ops/bow.py::save_npz`)."""
    np.savez_compressed(
        path, node_desc=voc.node_desc.cpu().numpy(), node_children=voc.node_children.cpu().numpy(),
        node_word=voc.node_word.cpu().numpy(), word_weight=voc.word_weight.cpu().numpy(),
        depth=voc.depth, k=voc.k,
    )


# -- training (host numpy, offline) -------------------------------------------
_POP = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,32) x (M,32) -> (N,M) distances."""
    return _POP[a[:, None, :] ^ b[None, :, :]].sum(-1)


def _majority_center(desc: np.ndarray) -> np.ndarray:
    """Bitwise majority vote (FORB::meanValue)."""
    bits = np.unpackbits(desc, axis=1)  # (N,256)
    return np.packbits((bits.sum(0) * 2 >= len(desc)).astype(np.uint8))


def _kmedians(desc: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Binary k-medians with kmeans++-style seeding: (centres, assignment)."""
    n = len(desc)
    if n <= k:
        return desc.copy(), np.arange(n)
    centers = [desc[rng.integers(n)]]
    d_min = None
    for _ in range(k - 1):
        d = _hamming_np(desc, np.stack(centers[-1:]))[:, 0].astype(np.float64)
        d_min = d if d_min is None else np.minimum(d_min, d)
        probs = d_min**2
        s = probs.sum()
        if s <= 0:
            centers.append(desc[rng.integers(n)])
        else:
            centers.append(desc[rng.choice(n, p=probs / s)])
    centers = np.stack(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        assign = _hamming_np(desc, centers).argmin(1)
        for c in range(len(centers)):
            members = desc[assign == c]
            if len(members):
                centers[c] = _majority_center(members)
    return centers, assign


def build_vocabulary(descriptors: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0,
                     device=None) -> Vocabulary:
    """Train a k^depth-word tree (`TemplatedVocabulary::create`) from (N, 32)
    uint8 descriptors, with uniform word weights as the reference, on
    `device` (None: the first CUDA card, raising where there is none)."""
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(32, np.uint8)]  # root (desc unused)
    node_children = [[]]
    node_word = [-1]

    def recurse(node_id, desc, level):
        if level == depth or len(desc) <= 1:
            node_word[node_id] = 0  # a leaf; word ids come after
            return
        centers, assign = _kmedians(desc, k, rng)
        for c in range(len(centers)):
            child_id = len(node_desc)
            node_desc.append(centers[c])
            node_children.append([])
            node_word.append(-1)
            node_children[node_id].append(child_id)
            recurse(child_id, desc[assign == c], level + 1)

    recurse(0, np.asarray(descriptors, np.uint8), 0)
    n_nodes = len(node_desc)
    word_ids = np.full(n_nodes, -1, np.int32)
    wc = 0
    for i in range(n_nodes):
        if node_word[i] == 0 or (i > 0 and not node_children[i]):
            word_ids[i] = wc
            wc += 1
    children = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(node_children):
        children[i, : len(ch)] = ch
    if device is None:
        device = require_cuda()
    return from_arrays(np.stack(node_desc), children, word_ids, np.ones(wc, np.float32), depth,
                       k, device)


def _popcount_table(device: torch.device) -> torch.Tensor:
    """The byte popcount table on `device`, uploaded once per device (a
    per-call upload would be a host sync on the card)."""
    if device not in _POPCOUNT:
        bits = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)
        _POPCOUNT[device] = bits.to(device)
    return _POPCOUNT[device]


def _hamming_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, 32) vs (N, k, 32) uint8 -> (N, k) int32 popcount distances."""
    x = torch.bitwise_xor(a[:, None, :], b).to(torch.int64)
    return _popcount_table(a.device)[x].sum(-1, dtype=torch.int32)


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descend every descriptor to its leaf: (N,) int32 word ids, -1 for an
    invalid descriptor."""
    N = desc.shape[0]
    cur = torch.zeros(N, dtype=torch.int64, device=desc.device)  # the root
    for _ in range(voc.depth):
        ch = voc.node_children[cur]  # (N, k)
        has_child = ch >= 0
        ch_safe = torch.clamp(ch, min=0).to(torch.int64)
        d = _hamming_rows(desc, voc.node_desc[ch_safe])
        d = torch.where(has_child, d, 10_000)
        nxt = torch.gather(ch_safe, 1, torch.argmin(d, dim=1, keepdim=True))[:, 0]
        cur = torch.where(has_child.any(dim=1), nxt, cur)  # a leaf stays put
    return torch.where(valid, voc.node_word[cur], -1)


def bow_vector(voc: Vocabulary, words: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalised tf-idf vector (n_words,)."""
    ok = words >= 0
    tf = torch.zeros(voc.n_words, dtype=torch.float32, device=words.device).index_add_(
        0, torch.clamp(words, min=0).to(torch.int64), ok.to(torch.float32))
    v = tf * voc.word_weight
    n = torch.sum(torch.abs(v))
    return v / torch.where(n > 0, n, torch.ones_like(n))


def score_l1(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2's L1 similarity 1 - |a - b|_1 / 2 of L1-normalised vectors.
    q (W,), db (K, W) -> (K,)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(db - q[None, :]), dim=-1)


def shared_words(q_words: torch.Tensor, db_word_mask: torch.Tensor) -> torch.Tensor:
    """Count of the query's words present in each DB entry (K,) int64;
    db_word_mask (K, W) bool. Only valid words are set (C6)."""
    ok = q_words >= 0
    hits = torch.zeros(db_word_mask.shape[1], dtype=torch.int32, device=q_words.device)
    hits.index_add_(0, torch.clamp(q_words, min=0).to(torch.int64), ok.to(torch.int32))
    return torch.sum(db_word_mask & (hits > 0)[None, :], dim=-1)
