"""Bucket-aware continuous batching: one FIFO per worklist rung with
deadline dispatch. Counterpart of ``repro/serving/scheduler.py`` for one
tenant, with plain counters in place of its metrics registry.

A rung's queue is dispatchable when it holds ``max_batch`` requests or its
head has waited ``max_wait_s``; the most overdue head goes first (ties to
the smaller rung); spare slots are backfilled from lower rungs, oldest
first (a light query runs exactly at any higher rung); a request older
than ``promote_after_s`` climbs one rung, so a lone light query merges
into a heavier batch. ``rungs=None`` is the classic single-FIFO batcher.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

__all__ = ["BatchPolicy", "BucketScheduler"]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    max_batch: int = 8
    max_wait_s: float = 0.005
    promote_after_s: float = 0.02


class BucketScheduler:
    """Per-rung FIFO queues of items with an ``arrival`` attribute."""

    def __init__(
        self,
        policy: BatchPolicy,
        clock: Callable[[], float] = time.monotonic,
        *,
        rungs: tuple[int, ...] | None = None,
    ):
        self.policy = policy
        self.clock = clock
        self.rungs = tuple(rungs) if rungs else None
        self._queues: dict = {}
        self.promoted = 0
        # rung (or None) -> {"batches", "requests", "slots", "backfilled"}
        self.rung_stats: dict = {}

    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def push(self, item, rung=None) -> None:
        if rung is not None and self.rungs is not None and rung not in self.rungs:
            raise ValueError(f"rung {rung} not in ladder {self.rungs}")
        self._queues.setdefault(rung, deque()).append(item)

    def next_deadline(self) -> float | None:
        """Earliest instant a queued head's deadline expires (None idle)."""
        heads = [q[0].arrival for q in self._queues.values() if q]
        return min(heads) + self.policy.max_wait_s if heads else None

    def _promote(self, now: float) -> None:
        """Move items waiting ``promote_after_s`` since arrival (or their
        last promotion) one rung up, merged by arrival; top-down, so an
        item climbs at most one rung per pass."""
        if self.rungs is None or len(self.rungs) < 2:
            return
        for i, rung in reversed(list(enumerate(self.rungs[:-1]))):
            q = self._queues.get(rung)
            if not q:
                continue
            stale, keep = [], []
            for p in q:
                last = getattr(p, "_promote_stamp", p.arrival)
                (stale if now - last >= self.policy.promote_after_s else keep).append(p)
            if not stale:
                continue
            self._queues[rung] = deque(keep)
            up = self.rungs[i + 1]
            merged = sorted([*self._queues.get(up, ()), *stale], key=lambda p: p.arrival)
            self._queues[up] = deque(merged)
            for p in stale:
                p._promote_stamp = now
            self.promoted += len(stale)

    def _dispatchable(self, rung, now: float, force: bool) -> bool:
        q = self._queues.get(rung)
        if not q:
            return False
        if force or len(q) >= self.policy.max_batch:
            return True
        return (now - q[0].arrival) >= self.policy.max_wait_s

    def next_batch(self, *, force: bool = False):
        """-> ``(rung, items)`` for at most one batch, or None. ``force``
        dispatches the oldest head even when under-full and early."""
        now = self.clock()
        self._promote(now)
        ready = [r for r in self._queues if self._dispatchable(r, now, force)]
        if not ready:
            return None
        rung = min(
            ready, key=lambda r: (self._queues[r][0].arrival, -1 if r is None else r)
        )
        q = self._queues[rung]
        items = [q.popleft() for _ in range(min(len(q), self.policy.max_batch))]
        backfilled = 0
        if rung is not None:
            for r in sorted((r for r in self._queues if r is not None and r < rung), reverse=True):
                lq = self._queues[r]
                while lq and len(items) < self.policy.max_batch:
                    items.append(lq.popleft())
                    backfilled += 1
        st = self.rung_stats.setdefault(
            rung, {"batches": 0, "requests": 0, "slots": 0, "backfilled": 0}
        )
        st["batches"] += 1
        st["requests"] += len(items)
        st["slots"] += self.policy.max_batch
        st["backfilled"] += backfilled
        return rung, items

    def occupancy(self) -> dict:
        """Per-rung mean batch occupancy (requests / dispatched slots)."""
        return {
            r: round(s["requests"] / s["slots"], 4) if s["slots"] else 0.0
            for r, s in self.rung_stats.items()
        }
