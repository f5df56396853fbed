"""Admission control and background maintenance policies for serving.
Counterpart of ``repro/serving/admission.py``.

Unbounded queueing converts overload into unbounded latency: every
admitted request waits behind the whole backlog, so *all* requests miss
the SLO instead of a few being rejected. The gate here sheds at the door
with a typed ``Overloaded`` rejection (clients can back off or retry
against a replica) and keeps the queue short enough that admitted
requests stay inside the latency budget:

- **queue-depth gate**: reject when the scheduler backlog reaches
  ``max_queue_depth``. With service rate mu (batches/s x batch size) the
  depth bound is the classic SLO inversion — a request admitted behind
  ``d`` others waits ~``d / mu + max_wait_s``, so
  ``max_queue_depth ~= (slo_s - max_wait_s) * mu`` keeps the p99 of
  admitted requests under ``slo_s``.
- **token bucket**: a sustained-rate cap (``rate_per_s``, burst
  ``burst``) that smooths arrival spikes before they even hit the queue;
  disabled when ``rate_per_s`` is None.

``CompactionPolicy`` is the background-maintenance half: delta segments
accumulated by ``store.add_documents`` slow search (every probe expands
per-segment runs) until ``store.compact()`` folds them back. The policy
triggers compaction from the server loop (``RetrievalServer.maintain``)
when the store's ``delta_stats`` cross either threshold — segment count
or delta-token fraction — with a minimum interval so a write-heavy burst
cannot wedge the server into back-to-back compactions.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

__all__ = [
    "Overloaded",
    "DeadlineExceeded",
    "AdmissionPolicy",
    "AdmissionGate",
    "CompactionPolicy",
]


class Overloaded(RuntimeError):
    """Typed load-shed rejection: the server refused the request at the
    door (queue depth or rate cap). Clients should back off and retry;
    nothing was enqueued."""


class DeadlineExceeded(RuntimeError):
    """Typed per-request deadline miss: the request sat queued past the
    ``deadline_s`` its submitter attached, so the server shed it
    *pre-dispatch* — it never occupied a batch slot, and no result was
    computed. Raised by ``poll``/``result`` exactly once for the shed id
    (then ``ResultAlreadyTaken``, like any delivered outcome)."""


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """SLO gate knobs. ``max_queue_depth`` bounds the scheduler backlog;
    ``rate_per_s``/``burst`` arm the token bucket (None = depth-only)."""

    max_queue_depth: int = 64
    rate_per_s: float | None = None
    burst: int = 16


class AdmissionGate:
    """Stateful admission check over an ``AdmissionPolicy``.

    ``check(queue_depth)`` raises ``Overloaded`` or returns None; the
    token bucket refills continuously on the injected clock (the same
    fake-clock pattern the batcher tests use, so shedding is
    deterministic under test).
    """

    def __init__(
        self,
        policy: AdmissionPolicy = AdmissionPolicy(),
        clock: Callable[[], float] = time.monotonic,
        *,
        registry=None,
    ):
        self.policy = policy
        self.clock = clock
        self._tokens = float(policy.burst)
        self._last = clock()
        self.shed = 0
        self.admitted = 0
        # Optional mirror into a repro_torch.obs MetricsRegistry; the plain ints
        # stay the source of truth for the summary() keys.
        if registry is not None:
            self._c_shed = registry.counter(
                "serving_shed_total", "Requests rejected at admission"
            )
            self._c_admitted = registry.counter(
                "serving_admitted_total", "Requests admitted past the gate"
            )
        else:
            self._c_shed = self._c_admitted = None

    def _shed(self) -> None:
        self.shed += 1
        if self._c_shed is not None:
            self._c_shed.inc()

    def _refill(self) -> None:
        now = self.clock()
        rate = self.policy.rate_per_s
        if rate:
            self._tokens = min(
                float(self.policy.burst),
                self._tokens + (now - self._last) * rate,
            )
        self._last = now

    def check(self, queue_depth: int) -> None:
        """Admit or raise ``Overloaded``; admission consumes one token
        when the rate cap is armed."""
        if queue_depth >= self.policy.max_queue_depth:
            self._shed()
            raise Overloaded(
                f"queue depth {queue_depth} at limit "
                f"{self.policy.max_queue_depth}; retry with backoff"
            )
        if self.policy.rate_per_s is not None:
            self._refill()
            if self._tokens < 1.0:
                self._shed()
                raise Overloaded(
                    f"rate limit {self.policy.rate_per_s}/s exceeded "
                    f"(burst {self.policy.burst}); retry with backoff"
                )
            self._tokens -= 1.0
        self.admitted += 1
        if self._c_admitted is not None:
            self._c_admitted.inc()


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When the server should fold delta segments back into the base.

    Triggers when ``store.segments.delta_stats`` reports
    ``n_delta_segments > max_delta_segments`` OR ``delta_token_frac >
    max_delta_frac``, at most once per ``min_interval_s`` (on the
    server's clock).

    A *failed* maintenance tick (compaction or the follow-up reload
    raised) must not be retried immediately — the fault is usually
    persistent (disk full, corrupt segment) and a tight retry loop would
    starve serving. ``retry_backoff_s`` is the first retry delay,
    doubled per consecutive failure up to ``retry_backoff_max_s``; the
    server keeps serving the old epoch throughout.
    """

    max_delta_segments: int = 4
    max_delta_frac: float = 0.25
    min_interval_s: float = 30.0
    retry_backoff_s: float = 5.0
    retry_backoff_max_s: float = 60.0

    def should_compact(self, stats: dict) -> bool:
        return (
            stats["n_delta_segments"] > self.max_delta_segments
            or stats["delta_token_frac"] > self.max_delta_frac
        )
