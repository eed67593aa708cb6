"""Distributed execution context of the live pipeline — the port of
`orbslam3_tpu/parallel/context.py`: what `AsyncGBA` / `global_ba`, the loop
closer's synchronous GBA and the multi-map manager's merge queries dispatch
through when `System.enable_distributed` is on (BASELINE config 5: "map
merging + global BA across 2 hosts").

The run is SPMD: every rank is a process that replays the same frames,
holds an identical replica of the map and reaches each GBA and each merge
query together. The GBA's point axis is block-partitioned over the group
(each rank keeps its P/n points and their coupling blocks; one all-reduce of
the reduced camera system per LM iteration); the merge candidates are
scored over the stored map's BoW matrix cut in blocks. `check_replicas`
compares a digest of every rank's map and raises `ReplicaDivergence` when
they differ: the replicas stay in lockstep only while they are equal bit for
bit, and a solve over replicas that are not would sum two maps' systems.
"""

from __future__ import annotations

import hashlib

import torch

from orbslam3_tpu_torch.parallel import ba_sharded, comm, kfdb_sharded

DIGEST_FIELDS = ("kf_R", "kf_t", "mp_pos", "kf_mp")


def store_digest(state) -> int:
    """A 63-bit digest of a map's keyframe poses, point positions and
    keyframe-point associations (their bytes on the host)."""
    h = hashlib.sha256()
    for f in DIGEST_FIELDS:
        h.update(getattr(state, f).detach().cpu().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little") >> 1


class ReplicaDivergence(RuntimeError):
    """The ranks' maps differ where they must be equal (every rank raises)."""


class DistributedContext:
    """A `torch.distributed` group (the world group by default) seen by the
    pipeline. Without an initialized process group it is a world of one, and
    `n_shards > 1` gates every distributed branch, as in the reference."""

    def __init__(self, group=None):
        self.group = comm.resolve(group)
        self.n_shards, self.rank = comm.world(self.group)
        self.replica_checks = []  # (what, equal, every rank's digest)
        self.n_solves = 0  # `run_ba` calls

    # -- BA ------------------------------------------------------------
    def prep_ba(self, prob):
        """This rank's block of the point-partitioned layout of `prob` (one
        host layout, the same on every rank). Returns (block, P_orig)."""
        prob_s, _dst, _fill, Pn = ba_sharded.prep_point_sharded(prob, self.n_shards)
        return ba_sharded.local_block(prob_s, self.rank, self.n_shards), Pn

    def run_ba(self, model, params, prob_l, bf: float = 0.0, iters: int = 10,
               pcg_iters: int = 50):
        """One (chunk of an) LM solve over the group: cameras replicated,
        points this rank's block; both feed the next chunk."""
        self.n_solves += 1
        return ba_sharded.run_point_sharded(model, params, prob_l, self.group, bf=bf,
                                            iters=iters, pcg_iters=pcg_iters)

    def fetch(self, block: torch.Tensor) -> torch.Tensor:
        """The whole of a point-blocked tensor, on every rank (one
        all-gather); cameras are replicated already."""
        if self.n_shards == 1:
            return block
        return comm.all_gather(block, self.group, "context/fetch")

    # -- place recognition ----------------------------------------------
    def kfdb_query(self, q_vec, q_words, db_vecs, db_valid, n_best: int = 3):
        """The sharded keyframe-database query (`parallel/kfdb_sharded.py`)."""
        return kfdb_sharded.sharded_query(q_vec, q_words, db_vecs, db_valid, self.group,
                                          n_best=n_best)

    # -- lockstep ---------------------------------------------------------
    def check_replicas(self, store, what: str) -> None:
        """All-gather every rank's `store_digest` of `store` and record (what,
        equal, digests) in `replica_checks`; raise `ReplicaDivergence` on
        every rank when they are not all equal."""
        d = store_digest(store.state)
        mine = torch.tensor([d], dtype=torch.int64, device=store.state.kf_R.device)
        every = [int(x) for x in (comm.all_gather(mine, self.group, "context/digest")
                                  if self.n_shards > 1 else mine).cpu().numpy()]
        equal = len(set(every)) == 1
        self.replica_checks.append((what, equal, every))
        if not equal:
            raise ReplicaDivergence(f"{what}: the ranks' map digests differ: {every}")


def digests_equal(checks) -> bool:
    """Whether every recorded replica check found equal digests."""
    return bool(checks) and all(bool(eq) for _w, eq, _d in checks)
