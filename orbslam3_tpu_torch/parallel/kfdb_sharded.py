"""Sharded keyframe-database query over a `torch.distributed` group — the
port of `orbslam3_tpu/parallel/kfdb_sharded.py` (the Atlas-wide place
recognition query: each rank scores its block of the (K, n_words) BoW
matrix, the per-rank top-k are all-gathered).

Per rank: shared-word counts against its rows, one all-reduce MAX of the
local maximum for the global 0.8 x max-common filter, L1 scores, a local
top-k (ties to the lowest index, as `lax.top_k`: fault C2); then one
all-gather of every rank's candidates and the final top-k, identical on
every rank. No covisibility grouping: a merge candidate is Sim3-verified on
its own downstream.
"""

from __future__ import annotations

import torch

from orbslam3_tpu_torch.ops import bow as bow_ops
from orbslam3_tpu_torch.parallel import comm
from orbslam3_tpu_torch.pipeline.tracking import _top_k_lowest_index


def sharded_query(q_vec: torch.Tensor, q_words: torch.Tensor, db_vecs: torch.Tensor,
                  db_valid: torch.Tensor, group=None, n_best: int = 5):
    """Top-`n_best` (ids (n_best,) int32, scores (n_best,) float32) of the
    database over `group` (the world group by default): q_vec (W,) and
    q_words (Nf,) the query's BoW vector and word ids, db_vecs (K, W) and
    db_valid (K,) the whole database (every rank holds a replica and scores
    its block: K padded to a multiple of the group size). Slots without a
    candidate, and candidates scoring <= 0, hold id -1 (score -1 where no
    rank had a row to offer)."""
    g = comm.resolve(group)
    n, r = comm.world(g)
    K = db_vecs.shape[0]
    pad = (-K) % n
    if pad:
        db_vecs = torch.cat([db_vecs, torch.zeros((pad, db_vecs.shape[1]), dtype=db_vecs.dtype,
                                                  device=db_vecs.device)])
        db_valid = torch.cat([db_valid, torch.zeros(pad, dtype=torch.bool,
                                                    device=db_valid.device)])
    shard = db_vecs.shape[0] // n
    vecs, valid = db_vecs[r * shard:(r + 1) * shard], db_valid[r * shard:(r + 1) * shard]
    shared = bow_ops.shared_words(q_words, vecs > 0)
    top = torch.max(torch.where(valid, shared, 0)).reshape(1)
    if n > 1:
        top = comm.all_reduce(top, g, "max", "kfdb/max common")
    eligible = valid & (shared >= torch.clamp((0.8 * top[0]).to(shared.dtype), min=1))
    scores = torch.where(eligible, bow_ops.score_l1(q_vec, vecs), -1.0)
    top_s, top_i = _top_k_lowest_index(scores, min(n_best, shard))  # small shards offer fewer
    top_ids = top_i + r * shard
    if n > 1:
        top_s = comm.all_gather(top_s, g, "kfdb/candidates")
        top_ids = comm.all_gather(top_ids, g, "kfdb/candidates")
    best_s, sel = _top_k_lowest_index(top_s, min(n_best, top_s.shape[0]))
    ids = top_ids[sel]
    pad_n = n_best - best_s.shape[0]
    if pad_n > 0:
        best_s = torch.cat([best_s, torch.full((pad_n,), -1.0, dtype=best_s.dtype,
                                               device=best_s.device)])
        ids = torch.cat([ids, torch.zeros(pad_n, dtype=ids.dtype, device=ids.device)])
    ids = torch.where(best_s > 0, ids, -1)
    return ids.to(torch.int32), best_s
