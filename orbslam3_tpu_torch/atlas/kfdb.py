"""Keyframe database on torch tensors — the port of
`orbslam3_tpu/atlas/kfdb.py` (`KeyFrameDatabase.cc`): every keyframe's BoW
vector is one row of a dense (Kmax, n_words) float32 matrix on the device,
and a query is

1. shared-word counts against every row (`KeyFrameDatabase.cc:640-668`),
2. the 0.8 x max-common filter (`:668`),
3. L1 scores against every row (`:677`),
4. covisibility-group accumulation (`:695-720`): one masked matmul,
5. the best n groups (`:742`), deduplicated by their best member.

Ties (fault C2): `lax.top_k` takes the lowest index among equal values, so
the port's top-n is a stable descending sort (`_top_k_lowest_index`), not
`torch.topk`, whose order among ties is unspecified. The reference's
`fori_loop` dedup is a Python loop of tensor ops with no host read.

`query_frame_sharded` scores the same query over a `torch.distributed`
group, each rank its block of the BoW matrix (`parallel/kfdb_sharded.py`).
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.ops import bow as bow_ops
from orbslam3_tpu_torch.pipeline.tracking import _top_k_lowest_index


def detect_candidates(q_vec, q_words, db_vecs, db_valid, exclude, covis, n_best: int = 3):
    """`DetectNBestCandidates` (`KeyFrameDatabase.cc:614`): q_vec (W,) the
    query's BoW vector, q_words (Nf,) its word ids (-1 invalid), db_vecs (K,
    W), db_valid (K,), exclude (K,) bool (connected keyframes and self),
    covis (K, K) int32 covisibility weights. Returns (cand_ids (n_best,)
    int32, -1 where no candidate passed; cand_scores (n_best,) float32)."""
    K = db_vecs.shape[0]
    dev = db_vecs.device
    shared = bow_ops.shared_words(q_words, db_vecs > 0)  # (K,)
    eligible = db_valid & ~exclude & (shared > 0)
    max_common = torch.max(torch.where(eligible, shared, 0))
    min_common = (0.8 * max_common).to(shared.dtype)
    eligible = eligible & (shared >= torch.clamp(min_common, min=1))

    scores = torch.where(eligible, bow_ops.score_l1(q_vec, db_vecs), 0.0)

    # Group score of k: the scores of its 10 best covisible neighbours and
    # itself; its candidate: the group's best-scoring member.
    top_w = torch.sort(covis, dim=1, descending=True)[0][:, 9:10]  # 10th weight
    neigh = (covis >= torch.clamp(top_w, min=1)) & (covis > 0)
    neigh = neigh | torch.eye(K, dtype=torch.bool, device=dev)
    acc = (neigh.to(torch.float32) @ scores[:, None])[:, 0]
    acc = torch.where(eligible, acc, 0.0)
    best_member = torch.argmax(torch.where(neigh, scores[None, :], -1.0), dim=1)

    top_acc, top_rows = _top_k_lowest_index(acc, n_best * 3)
    cands = best_member[top_rows].to(torch.int32)
    cand_scores = scores[cands.to(torch.int64)]
    ok = top_acc > 0
    out_ids = torch.full((n_best,), -1, dtype=torch.int32, device=dev)
    out_sc = torch.zeros(n_best, dtype=torch.float32, device=dev)
    n = torch.zeros((), dtype=torch.int64, device=dev)
    slot = torch.arange(n_best, device=dev)
    for i in range(top_rows.shape[0]):  # keep the first occurrence of each
        take = ok[i] & ~torch.any(out_ids == cands[i]) & (n < n_best)
        at = take & (slot == n)
        out_ids = torch.where(at, cands[i], out_ids)
        out_sc = torch.where(at, cand_scores[i], out_sc)
        n = n + take.to(torch.int64)
    return out_ids, out_sc


class KeyFrameDB:
    """Owner of the dense BoW matrix of one map, on the vocabulary's device."""

    def __init__(self, voc: bow_ops.Vocabulary, Kmax: int = 256):
        self.voc = voc
        dev = voc.word_weight.device
        self.vecs = torch.zeros((Kmax, voc.n_words), dtype=torch.float32, device=dev)
        self.valid = torch.zeros(Kmax, dtype=torch.bool, device=dev)
        self.words = torch.full((Kmax, 1), -1, dtype=torch.int32, device=dev)  # sized at add
        self._Nf = None

    def add(self, kf_id: int, desc: torch.Tensor, feat_valid: torch.Tensor):
        """`KeyFrameDatabase::add` (`KeyFrameDatabase.cc:41`). Returns
        (words, vec)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        if self._Nf is None:
            self._Nf = desc.shape[0]
            self.words = torch.full((self.vecs.shape[0], self._Nf), -1, dtype=torch.int32,
                                    device=self.vecs.device)
        self.vecs[kf_id] = vec
        self.words[kf_id] = words
        self.valid[kf_id] = True
        return words, vec

    def erase(self, kf_id: int):
        self.valid[kf_id] = False

    def query(self, kf_id: int, covis: torch.Tensor, n_best: int = 3, min_covis: int = 15):
        """Loop candidates of keyframe `kf_id`, its covisible neighbourhood
        (weight >= `min_covis`) and itself excluded (`LoopClosing.cc:513`)."""
        exclude = covis[kf_id] >= min_covis
        exclude[kf_id] = True
        return detect_candidates(self.vecs[kf_id], self.words[kf_id], self.vecs, self.valid,
                                 exclude, covis, n_best)

    def query_frame(self, desc: torch.Tensor, feat_valid: torch.Tensor, covis: torch.Tensor,
                    n_best: int = 5):
        """Relocalization candidates of a frame
        (`DetectRelocalizationCandidates`, `KeyFrameDatabase.cc:785`)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        exclude = torch.zeros(self.vecs.shape[0], dtype=torch.bool, device=self.vecs.device)
        return detect_candidates(vec, words, self.vecs, self.valid, exclude, covis, n_best)

    def query_frame_sharded(self, desc: torch.Tensor, feat_valid: torch.Tensor, dist,
                            n_best: int = 5):
        """`query_frame` scored over a `DistributedContext`'s group
        (`parallel/context.py::kfdb_query`): the (K, n_words) matrix cut in
        blocks along K, each rank's top-k all-gathered. Used by the Atlas's
        merge query of a distributed system; no covisibility grouping (each
        candidate is Sim3-verified downstream)."""
        words = bow_ops.transform(self.voc, desc, feat_valid)
        vec = bow_ops.bow_vector(self.voc, words)
        return dist.kfdb_query(vec, words, self.vecs, self.valid, n_best=n_best)
