"""Deterministic sharded batching pipeline: the port's copy of
``repro/data/pipeline.py`` (pure numpy, so the batches are the JAX
package's to the bit).

Design constraints from the 1000+ node target:
  * determinism: batch content is a pure function of (seed, step, shard),
    so a restarted/rescheduled worker reproduces exactly the batches it
    owes — checkpoint-resume needs no data-iterator state beyond the step;
  * sharding: each data-parallel group reads only its shard (shard count
    = data axes size); re-sharding on elastic rescale is just a new
    (n_shards, shard_id) pair — the global sample order is unchanged;
  * straggler mitigation: ``reassign(step, dead_shards)`` deterministically
    maps a failed shard's slice onto survivors (bounded skip-ahead), so the
    fleet never blocks on a dead host — the same policy every surviving
    worker computes locally, with no coordinator.

The index math is pure; actual payloads come from a user ``fetch`` callable
(here: synthetic token generation keyed by global sample id).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = ["ShardedBatcher", "synthetic_lm_fetch"]


@dataclasses.dataclass(frozen=True)
class ShardedBatcher:
    """Assigns global sample ids to (step, shard) deterministically."""

    global_batch: int
    n_shards: int
    seed: int = 0
    n_samples: int | None = None  # dataset size; None = infinite stream

    def __post_init__(self):
        if self.global_batch % self.n_shards:
            raise ValueError(
                f"global_batch {self.global_batch} % n_shards {self.n_shards} != 0"
            )

    @property
    def per_shard(self) -> int:
        return self.global_batch // self.n_shards

    def _global_ids(self, step: int) -> np.ndarray:
        base = np.arange(self.global_batch, dtype=np.int64) + step * self.global_batch
        if self.n_samples is not None:
            # Deterministic per-epoch shuffle via a Philox-keyed permutation.
            epoch = base // self.n_samples
            within = base % self.n_samples
            out = np.empty_like(base)
            for e in np.unique(epoch):
                rng = np.random.default_rng([self.seed, int(e)])
                perm = rng.permutation(self.n_samples)
                m = epoch == e
                out[m] = perm[within[m]]
            return out
        return base

    def shard_ids(self, step: int, shard: int) -> np.ndarray:
        """Sample ids owned by ``shard`` at ``step``."""
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} out of range")
        ids = self._global_ids(step)
        return ids[shard * self.per_shard : (shard + 1) * self.per_shard]

    def reassign(self, step: int, dead: frozenset[int] | set[int]) -> dict[int, np.ndarray]:
        """Straggler/failure policy: dead shards' slices are split round-
        robin across survivors, deterministically. Every worker computes
        the same map locally — no coordination round."""
        alive = [s for s in range(self.n_shards) if s not in dead]
        if not alive:
            raise RuntimeError("all shards dead")
        out = {s: [self.shard_ids(step, s)] for s in alive}
        for i, d in enumerate(sorted(dead)):
            orphan = self.shard_ids(step, d)
            chunks = np.array_split(orphan, len(alive))
            # rotate assignment by failed-shard index for balance
            for j, chunk in enumerate(chunks):
                out[alive[(i + j) % len(alive)]].append(chunk)
        return {s: np.concatenate(parts) for s, parts in out.items()}


def synthetic_lm_fetch(vocab: int, seq_len: int) -> Callable[[np.ndarray], dict]:
    """Payload generator: tokens are a pure function of the sample id."""

    def fetch(ids: np.ndarray) -> dict:
        toks = np.empty((len(ids), seq_len), np.int32)
        for i, sid in enumerate(ids):
            rng = np.random.default_rng([int(sid), 7])
            toks[i] = rng.integers(0, vocab, seq_len)
        return {"tokens": toks, "labels": toks.copy()}

    return fetch
