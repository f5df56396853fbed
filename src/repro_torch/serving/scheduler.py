"""Bucket-aware continuous batching: per-rung queues + deadline dispatch.
Counterpart of ``repro/serving/scheduler.py``: the same batches, in the
same order, for the same push and clock script — with one fix: a named
group promotes along its own ladder (``push(..., rungs=)``). The JAX
scheduler promotes every group along the constructor's ladder, so a tenant
whose ladder differs from the default tenant's is promoted to a rung its
plan does not have (its batch then fails in ``retrieve_batch_at``), or is
never promoted.

The deadline batcher treats the queue as one FIFO, so a batch executes at
whatever worklist rung its most expensive member needs — one heavy query
drags seven light ones through the top rung. With the query-adaptive
ladder (``core/worklist.py::bucket_ladder``) the rung is known per query
at admission time from the cheap probe pre-pass
(``SearchPlan.adaptive_bucket``), so the scheduler keeps **one FIFO per
ladder rung** and forms batches per rung: each batch executes at
the smallest rung its members need (``SearchPlan.retrieve_batch_at``),
not the queue-wide max.

Dispatch rules (``next_batch``):

- a rung is *dispatchable* when it is full (``max_batch``) or its oldest
  member has waited ``max_wait_s`` — the existing ``BatchPolicy``
  deadline semantics, applied per rung;
- among dispatchable rungs the one with the oldest head goes first
  (most-overdue-first, so no rung's deadline is sacrificed to another's);
- spare batch slots are backfilled from *lower* rungs, oldest first — a
  light query executes exactly at any rung >= its own (worklist
  exactness), and riding along beats padding;
- **starvation guard**: a query older than ``promote_after_s`` is
  promoted one rung up, so a lone light query on an otherwise-idle rung
  merges into the next heavier batch instead of waiting alone. Promotion
  is always exact (bigger rung), never the reverse.

Each dispatched batch is tagged with its rung so the server can route it
through ``retrieve_batch_at`` (or ``retrieve_batch`` when the plan has no
ladder — ``rung=None`` degenerates to the classic single-FIFO batcher).

**Groups** (multi-index routing): ``push(item, rung, group=...)`` queues
the item under ``(group, rung)``. A group names everything that must be
homogeneous within one dispatched batch — the server uses
``(tenant, filter digest)``, since a batch executes exactly one plan
against exactly one index. Batches never mix groups: backfill and
promotion stay within a group, so a tenant-A request can never ride in a
tenant-B batch (the isolation invariant the multi-tenant chaos suite
asserts). ``group=None`` is the legacy single-index scheduler,
bit-identical to the pre-group behavior. Deadline dispatch picks the
most-overdue head across *all* groups, so no tenant can starve another.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from repro_torch.obs import MetricsRegistry

__all__ = ["BatchPolicy", "BucketScheduler"]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Deadline-batching knobs (per rung on bucket-aware plans).

    ``promote_after_s`` is the starvation guard: a queued request older
    than this is promoted one worklist rung up so it can merge into a
    heavier batch. It only matters on multi-rung (adaptive ragged) plans;
    the default is 4x the dispatch deadline so promotion is a fallback,
    not the steady state.
    """

    max_batch: int = 8
    max_wait_s: float = 0.005
    promote_after_s: float = 0.02


class BucketScheduler:
    """Per-rung FIFO queues with deadline dispatch and age promotion.

    ``rungs`` is the plan's ascending bucket ladder (None for
    non-adaptive plans — everything then queues under the single ``None``
    rung and the scheduler degenerates to the classic deadline batcher).
    Queued items only need an ``arrival`` attribute (the batcher's
    ``_Pending``); the scheduler never looks at query payloads.
    """

    def __init__(
        self,
        policy: BatchPolicy,
        clock: Callable[[], float] = time.monotonic,
        *,
        rungs: tuple[int, ...] | None = None,
        registry: MetricsRegistry | None = None,
    ):
        self.policy = policy
        self.clock = clock
        self.rungs = tuple(rungs) if rungs else None
        self._queues: dict = {}
        # Named groups' own ladders (``push(..., rungs=)``).
        self._ladders: dict = {}
        # Dispatch accounting lives in the metrics registry (the server
        # shares its own; standalone schedulers get a private one) —
        # ``stats``/``occupancy`` reconstruct the legacy dict views.
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._c_promoted = self.metrics.counter(
            "serving_promotions_total",
            "Requests promoted one worklist rung up by the starvation guard",
        )
        self._g_depth = self.metrics.gauge(
            "serving_queue_depth", "Requests queued across all rungs"
        )
        # Per-rung counters, created lazily at first dispatch; keys are
        # the ladder rung or "none" (non-adaptive queue).
        self._rung_c: dict = {}

    def _rung_counters(self, rung) -> dict:
        lab = "none" if rung is None else rung
        rc = self._rung_c.get(lab)
        if rc is None:
            rung_l = str(lab)
            rc = self._rung_c[lab] = {
                "batches": self.metrics.counter(
                    "serving_rung_batches_total",
                    "Batches dispatched at this worklist rung", rung=rung_l,
                ),
                "requests": self.metrics.counter(
                    "serving_rung_requests_total",
                    "Requests dispatched at this worklist rung", rung=rung_l,
                ),
                "slots": self.metrics.counter(
                    "serving_rung_slots_total",
                    "Batch slots (incl. padding) dispatched at this rung",
                    rung=rung_l,
                ),
                "backfilled": self.metrics.counter(
                    "serving_rung_backfilled_total",
                    "Lower-rung requests riding along in this rung's batches",
                    rung=rung_l,
                ),
                "wait": self.metrics.histogram(
                    "serving_queue_wait_seconds",
                    "Admission-to-dispatch queue wait", rung=rung_l,
                ),
            }
        return rc

    @property
    def stats(self) -> dict:
        """Legacy dict view of the registry-backed dispatch accounting
        (``{"promoted": n, "rungs": {rung: {batches, requests, slots,
        backfilled}}}``) — ``RetrievalServer.summary()`` and existing
        callers read this shape unchanged."""
        return {
            "promoted": int(self._c_promoted.value),
            "rungs": {
                lab: {
                    k: int(rc[k].value)
                    for k in ("batches", "requests", "slots", "backfilled")
                }
                for lab, rc in self._rung_c.items()
            },
        }

    # ---- queue state ----
    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def depth(self) -> int:
        return len(self)

    def push(self, item, rung=None, group=None, rungs=None) -> None:
        """Enqueue ``item`` under ``(group, rung)``.

        ``rung`` is a ladder bucket (or None on non-adaptive plans);
        ``group`` names the batch-homogeneity domain (tenant + filter on
        the multi-tenant server; None = the single legacy group). Rung
        membership is only validated against the constructor ladder for
        the legacy group — a named group routes to its own index and may
        carry its own ladder, ``rungs``, which its items are promoted
        along (default: the constructor's)."""
        if (
            group is None
            and rung is not None
            and self.rungs is not None
            and rung not in self.rungs
        ):
            raise ValueError(f"rung {rung} not in ladder {self.rungs}")
        if group is not None and rungs:
            self._ladders[group] = tuple(rungs)
        self._queues.setdefault((group, rung), deque()).append(item)
        self._g_depth.set(len(self))

    def reap(self, predicate) -> list:
        """Remove and return every queued item matching ``predicate``.

        This is the pre-dispatch shedding hook: the server reaps
        deadline-expired requests here so they never occupy a batch slot
        (shedding *after* batch formation would waste the slot on work
        nobody will read). FIFO order of the survivors is preserved.
        """
        out = []
        for key, q in self._queues.items():
            keep = deque()
            for p in q:
                (out if predicate(p) else keep).append(p)
            if len(keep) != len(q):
                self._queues[key] = keep
        if out:
            self._g_depth.set(len(self))
        return out

    def next_deadline(self) -> float | None:
        """Earliest instant any queued rung's deadline expires (head
        arrival + max_wait_s), or None when idle — the benchmark's
        open-loop simulator advances its virtual clock to this."""
        heads = [q[0].arrival for q in self._queues.values() if q]
        if not heads:
            return None
        return min(heads) + self.policy.max_wait_s

    # ---- dispatch ----
    def _promote(self, now: float) -> None:
        """Starvation guard: move items that have waited ``promote_after_s``
        since arrival (or since their last promotion — the climb is a
        ratchet, one rung per interval, not a jump to the top) one ladder
        rung up, merging by arrival so FIFO age order survives. Promotion
        never crosses groups — a starved tenant-A request climbs tenant
        A's own ladder."""
        groups = {g for (g, _) in self._queues}
        # Top-down so a just-promoted item is not re-examined in the same
        # pass.
        for group in groups:
            ladder = self.rungs if group is None else self._ladders.get(group, self.rungs)
            if ladder is None or len(ladder) < 2:
                continue
            for i, rung in reversed(list(enumerate(ladder[:-1]))):
                q = self._queues.get((group, rung))
                if not q:
                    continue
                stale, keep = [], []
                for p in q:
                    last = getattr(p, "_promote_stamp", p.arrival)
                    old = now - last >= self.policy.promote_after_s
                    (stale if old else keep).append(p)
                if not stale:
                    continue
                self._queues[(group, rung)] = deque(keep)
                up = (group, ladder[i + 1])
                merged = sorted(
                    [*self._queues.get(up, ()), *stale], key=lambda p: p.arrival
                )
                self._queues[up] = deque(merged)
                for p in stale:
                    p._promote_stamp = now
                self._c_promoted.inc(len(stale))

    def _dispatchable(self, key, now: float, force: bool) -> bool:
        q = self._queues.get(key)
        if not q:
            return False
        if force or len(q) >= self.policy.max_batch:
            return True
        return (now - q[0].arrival) >= self.policy.max_wait_s

    def next_batch(self, *, force: bool = False):
        """-> ``(rung, items)`` for at most one batch, or None.

        ``items`` is FIFO from the chosen ``(group, rung)`` queue,
        backfilled from the *same group's* lower rungs' heads when slots
        remain (exact: a lower-rung query fits any higher rung of the
        same plan; a different group is a different index/filter and
        never rides along). ``force`` dispatches the oldest-head queue
        even if under-full and before its deadline (the blocking
        ``result`` loop and ``drain`` use this). All items in the
        returned batch share one group — the server reads it off
        ``items[0]``.
        """
        now = self.clock()
        self._promote(now)
        ready = [
            k for k in self._queues
            if self._dispatchable(k, now, force)
        ]
        if not ready:
            return None
        # Most-overdue head first; ties break toward the smaller rung
        # (cheaper program). None sorts as rung -1 (non-adaptive queue).
        group, rung = min(
            ready,
            key=lambda k: (
                self._queues[k][0].arrival, -1 if k[1] is None else k[1]
            ),
        )
        q = self._queues[(group, rung)]
        take = min(len(q), self.policy.max_batch)
        items = [q.popleft() for _ in range(take)]
        backfilled = 0
        if rung is not None:
            lower = sorted(
                (
                    r for (g, r) in self._queues
                    if g == group and r is not None and r < rung
                ),
                reverse=True,
            )
            for r in lower:
                lq = self._queues[(group, r)]
                while lq and len(items) < self.policy.max_batch:
                    items.append(lq.popleft())
                    backfilled += 1
        rc = self._rung_counters(rung)
        rc["batches"].inc()
        rc["requests"].inc(len(items))
        rc["slots"].inc(self.policy.max_batch)
        rc["backfilled"].inc(backfilled)
        for p in items:
            rc["wait"].observe(max(now - p.arrival, 0.0))
        self._g_depth.set(len(self))
        return rung, items

    def occupancy(self) -> dict:
        """Per-rung mean batch occupancy (requests / dispatched slots)."""
        return {
            r: round(s["requests"] / s["slots"], 4) if s["slots"] else 0.0
            for r, s in self.stats["rungs"].items()
        }
