"""Request batcher for one served index. Counterpart of
``repro/serving/batcher.py::RetrievalServer`` for one tenant, without its
cache, admission gate, deadlines, reload and maintenance.

Queries are collected into fixed-size batches (deadline batching,
``serving/scheduler.py``); on adaptive ragged plans each request is tagged
at admission with the worklist rung it needs (``SearchPlan.
adaptive_bucket``), requests queue per rung, and each batch runs at the
rung its members need (``SearchPlan.retrieve_batch_at``). Under-full
batches are padded with fully masked queries, which add no worklist
demand. Replies equal ``plan.retrieve`` of the same query.

Lifecycle: ``submit`` -> ``poll`` returns ``PENDING`` until the request's
batch has run, then the ``(scores, doc_ids)`` pair exactly once; polling
it again raises ``ResultAlreadyTaken``, an unknown id ``KeyError``.
``result`` drives the loop until a request completes; ``drain`` empties
the queues.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.retriever import Retriever, SearchPlan
from repro_torch.core.types import WarpSearchConfig
from repro_torch.serving.scheduler import BatchPolicy, BucketScheduler

__all__ = ["BatchPolicy", "RetrievalServer", "ResultAlreadyTaken", "PENDING"]


class _PendingType:
    """Sentinel: the request is known but its batch has not run yet."""

    def __repr__(self) -> str:
        return "PENDING"

    def __bool__(self) -> bool:
        return False


PENDING = _PendingType()


class ResultAlreadyTaken(KeyError):
    """The request's result was already popped by an earlier ``poll``."""


@dataclasses.dataclass
class _Pending:
    req_id: int
    q: np.ndarray
    qmask: np.ndarray
    arrival: float


class RetrievalServer:
    """Deadline-batching server over one ``SearchPlan``.

    ``index`` is a ``Retriever`` or anything ``Retriever.from_index``
    takes (placed on ``device``; None -> "cuda").
    """

    def __init__(
        self,
        index,
        config: WarpSearchConfig = WarpSearchConfig(),
        policy: BatchPolicy = BatchPolicy(),
        clock: Callable[[], float] = time.monotonic,
        *,
        bucket_aware: bool = True,
        device=None,
    ):
        self.retriever = (
            index if isinstance(index, Retriever)
            else Retriever.from_index(index, device=device)
        )
        self.plan: SearchPlan = self.retriever.plan(config)
        self.config = self.plan.config
        self.policy = policy
        self.clock = clock
        rungs = self.config.worklist_buckets if bucket_aware and self.plan.adaptive else None
        self.scheduler = BucketScheduler(policy, clock, rungs=rungs)
        self._inflight: set[int] = set()
        self._results: dict = {}
        self._next_id = 0
        self.stats = {"batches": 0, "padded_slots": 0, "served": 0}
        # Submit-to-reply seconds of the most recent replies.
        self.latencies: collections.deque = collections.deque(maxlen=4096)

    def submit(self, q, qmask=None) -> int:
        """Admit one query q f32[Q, D]; returns its request id."""
        q = np.asarray(q, np.float32)
        qmask = np.ones(q.shape[:-1], bool) if qmask is None else np.asarray(qmask, bool)
        rung = self.plan.adaptive_bucket(q, qmask) if self.scheduler.rungs else None
        rid = self._next_id
        self._next_id += 1
        self.scheduler.push(_Pending(rid, q, qmask, self.clock()), rung)
        self._inflight.add(rid)
        return rid

    def poll(self, req_id: int):
        """Completed -> pops ``(scores, doc_ids)`` (numpy) exactly once;
        queued -> ``PENDING``; popped before -> ``ResultAlreadyTaken``;
        never submitted -> ``KeyError``."""
        if req_id in self._results:
            return self._results.pop(req_id)
        if req_id in self._inflight:
            return PENDING
        if 0 <= req_id < self._next_id:
            raise ResultAlreadyTaken(f"result for request id {req_id} was already retrieved")
        raise KeyError(f"request id {req_id} was never submitted")

    def result(self, req_id: int, timeout: float | None = None):
        """Drive the server loop until ``req_id`` completes."""
        start = self.clock()
        while True:
            out = self.poll(req_id)
            if out is not PENDING:
                return out
            if timeout is not None and self.clock() - start >= timeout:
                raise TimeoutError(f"request {req_id} not served within {timeout}s")
            if self.step() == 0:
                self.step(force=True)

    def step(self, *, force: bool = False) -> int:
        """Dispatch at most one batch; returns the requests served."""
        got = self.scheduler.next_batch(force=force)
        if got is None:
            return 0
        rung, batch = got
        b = self.policy.max_batch
        qm, d = batch[0].q.shape
        q = np.zeros((b, qm, d), np.float32)
        mask = np.zeros((b, qm), bool)
        for i, p in enumerate(batch):
            q[i] = p.q
            mask[i] = p.qmask
        if rung is None:
            res = self.plan.retrieve_batch(q, mask)
        else:
            res = self.plan.retrieve_batch_at(q, mask, bucket=rung)
        scores = res.scores.cpu().numpy()
        docs = res.doc_ids.cpu().numpy()
        now = self.clock()
        for i, p in enumerate(batch):
            self._results[p.req_id] = (scores[i], docs[i])
            self._inflight.discard(p.req_id)
            self.latencies.append(now - p.arrival)
        self.stats["batches"] += 1
        self.stats["padded_slots"] += b - len(batch)
        self.stats["served"] += len(batch)
        return len(batch)

    def drain(self) -> None:
        while len(self.scheduler):
            self.step(force=True)

    def summary(self) -> dict:
        """Dispatch counters, per-rung batch stats and occupancy, and the
        p50/p95 submit-to-reply latency of the last 4096 replies (s)."""
        out = dict(self.stats)
        out["queue_depth"] = len(self.scheduler)
        out["promoted"] = self.scheduler.promoted
        out["rungs"] = {str(r): dict(s) for r, s in self.scheduler.rung_stats.items()}
        out["rung_occupancy"] = {str(r): v for r, v in self.scheduler.occupancy().items()}
        if self.latencies:
            lat = np.asarray(self.latencies)
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p95_s"] = float(np.percentile(lat, 95))
        out["device"] = str(self.retriever.device)
        return out
