"""Request batcher for the retrieval engine. Counterpart of
``repro/serving/batcher.py::RetrievalServer``, with its whole surface:

- **deadline batching, bucket-aware** (``serving/scheduler.py``): on
  adaptive ragged plans each request is tagged at admission with the
  worklist rung it needs (``SearchPlan.adaptive_bucket``), requests queue
  per rung, and each batch runs at the smallest rung its members need
  (``SearchPlan.retrieve_batch_at``); under-full batches are padded with
  fully masked queries, which add no worklist demand;
- **two-level cache** (``serving/cache.py``): the rung of a known query
  and the result, both keyed on (query hash, plan fingerprint, index
  epoch); a result-cache hit completes the request at submit;
- **admission and maintenance** (``serving/admission.py``): a gate that
  sheds with a typed ``Overloaded``, and ``maintain`` running
  ``store.compact`` + ``reload`` when a ``CompactionPolicy`` fires;
- **tenants and filters**: ``add_tenant`` serves more indexes behind the
  one scheduler; ``submit(dfilter=)`` pushes a ``DocFilter`` into the
  pipeline; ``delete_documents`` tombstones doc ids, intersected with
  every later request's filter. Tenant and filter are folded into cache
  keys and batch groups, so no reply, cache entry or batch crosses them;
- **deadlines**: a request still queued at its ``deadline_s`` is shed
  before dispatch and its ``poll`` raises ``DeadlineExceeded`` once;
- **validate-then-swap reload**: load (store paths with
  ``quarantine_segments=True``), plan from the *requested* config and
  ``warmup`` before anything is mutated; then the epoch bumps, caches are
  purged and queued requests re-homed. A failed reload leaves epoch,
  caches, queue and the old index untouched;
- ``health()`` (ok / degraded / overloaded with reasons), ``summary()``,
  the ``server.reload`` fault site, and the ``submit`` / ``admission`` /
  ``rung_prepass`` / ``queue_wait`` / ``batch_dispatch`` / ``reply``
  spans (``repro_torch.obs``).

Request lifecycle: ``submit`` -> ``poll`` returns ``PENDING`` until the
request's batch has run, then the ``(scores, doc_ids)`` numpy pair exactly
once; polling it again raises ``ResultAlreadyTaken``, an unknown id
``KeyError``. ``result`` drives the loop until a request completes.

Differences from the JAX server:

- **A failing batch raises.** The JAX plan demotes itself to its
  reference executor when a kernel fails (``_activate_fallback``), so its
  server never sees the failure. The port has no fallback: an exception
  in a batch's dispatch (for example the ``engine.kernel_call`` fault
  site) propagates out of ``step``, nothing is answered from a plain
  version, each member of that batch gets the same exception from its
  ``poll`` exactly once, and ``health()`` reports it as degraded until a
  batch dispatches again.
- The server holds its indexes on ``device`` (None -> "cuda", raising
  without CUDA); store paths given to ``add_tenant`` / ``reload`` load
  there. A sharded tenant keeps its stack on that device (no mesh to
  carry across a reload: the shard count travels with the index), and its
  deletes are a ``DocFilter`` over global ids like any tenant's.
- It keeps the submit-to-reply seconds of its last 4096 replies
  (``latencies``; ``summary()`` adds their p50/p95 and the device).
- **Ranked.** Over a ranked retriever (``Retriever.from_store(path,
  group=)``: one shard per process of a ``RankGroup``) the server runs
  unchanged on rank 0, and every retriever call it makes (plan, warm-up,
  rung pre-pass, batch at a rung, store load, close) is a collective
  operation that ranks 1..S-1 run in ``follow``. Deletes stay a
  ``DocFilter`` over global ids: each rank plans the tombstone filter and
  slices it to its shard. ``reload`` of a store path reloads each rank's
  own view. Its tenants are all ranked over the same group; an index
  object (which one process cannot hand the other ranks) and compaction
  (a sharded store has no delta segments) raise.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import warnings
from typing import Callable

import numpy as np

from repro_torch import fault, obs
from repro_torch.core.docfilter import DocFilter
from repro_torch.core.retriever import Retriever
from repro_torch.core.types import WarpSearchConfig, resolve_device
from repro_torch.serving.admission import (
    AdmissionGate,
    AdmissionPolicy,
    CompactionPolicy,
    DeadlineExceeded,
)
from repro_torch.serving.cache import LRUCache, query_key
from repro_torch.serving.scheduler import BatchPolicy, BucketScheduler

__all__ = ["BatchPolicy", "RetrievalServer", "ResultAlreadyTaken", "PENDING", "follow"]

class _PendingType:
    """Sentinel: the request is known but its batch has not run yet."""

    def __repr__(self) -> str:
        return "PENDING"

    def __bool__(self) -> bool:
        return False


PENDING = _PendingType()


class ResultAlreadyTaken(KeyError):
    """The request's outcome was already delivered by an earlier ``poll``
    (results pop exactly once); distinct from the plain ``KeyError`` of a
    never-submitted id."""


@dataclasses.dataclass
class _Pending:
    req_id: int
    q: np.ndarray
    qmask: np.ndarray
    arrival: float
    qkey: str | None = None  # content hash (None with caching disabled)
    deadline: float | None = None  # absolute, on the server clock
    tenant: str | None = None  # routing handle (None = default index)
    dfilter: DocFilter | None = None  # request filter, pre-tombstone merge
    plan: object | None = None  # resolved (possibly filtered) SearchPlan
    fp: str | None = None  # that plan's fingerprint (cache-key component)
    group: tuple | None = None  # scheduler batch-homogeneity key


@dataclasses.dataclass
class _Tenant:
    """Per-index serving state behind one ``tenant=`` handle: retriever,
    plan ladder, store path, quarantined segments and the tombstone view
    (``deleted`` ids, ``tomb`` = ``DocFilter.tombstones`` over them)."""

    name: str | None = None
    retriever: Retriever | None = None
    requested_config: WarpSearchConfig | None = None
    plan: object | None = None  # base (unfiltered) SearchPlan
    config: WarpSearchConfig | None = None  # the plan's resolved config
    fingerprint: str | None = None
    store_path: str | None = None
    quarantined: tuple = ()
    deleted: frozenset = dataclasses.field(default_factory=frozenset)
    tomb: DocFilter | None = None


def _default_tenant_field(field: str):
    """Single-index attribute (``server.retriever`` & co.) as a view onto
    the default tenant's record."""

    def _get(self):
        return getattr(self._tenants[None], field)

    def _set(self, value):
        setattr(self._tenants[None], field, value)

    return property(_get, _set)


def _tombstone_view(deleted: frozenset, n_docs: int) -> DocFilter | None:
    return DocFilter.tombstones(sorted(deleted), n_docs) if deleted else None


class RetrievalServer:
    """Deadline-batching multi-tenant server over ``SearchPlan``s.

    ``index`` is a ``Retriever`` or anything ``Retriever.from_index``
    takes, placed on ``device`` (None -> "cuda", raising without CUDA).
    """

    def __init__(
        self,
        index,
        config: WarpSearchConfig = WarpSearchConfig(),
        policy: BatchPolicy = BatchPolicy(),
        clock: Callable[[], float] = time.monotonic,
        *,
        bucket_aware: bool = True,
        cache_size: int = 256,
        admission: AdmissionPolicy | AdmissionGate | None = None,
        compaction: CompactionPolicy | None = None,
        store_path: str | None = None,
        registry: obs.MetricsRegistry | None = None,
        sleep: Callable[[float], None] | None = None,
        device=None,
    ):
        # Private registry per server by default, so two servers never
        # share counts; the serve launcher passes the process registry.
        self.metrics = registry if registry is not None else obs.MetricsRegistry()
        self._tenants: dict = {None: _Tenant()}
        self._tenant_c: dict = {}
        self.retriever = (
            index if isinstance(index, Retriever)
            else Retriever.from_index(index, device=resolve_device(device))
        )
        self.device = self.retriever.device
        self._group = self.retriever.index.group if self.retriever.is_ranked else None
        if self._group is not None and compaction is not None:
            raise ValueError(
                "a ranked server serves a sharded store, which has no delta segments "
                "to compact: pass compaction=None"
            )
        # Kept unresolved: a reload re-resolves t' / k_impute / layout
        # against the NEW index.
        self._requested_config = config
        self.plan = self.retriever.plan(config)
        self.plan.warmup()
        self.config = self.plan.config
        self.policy = policy
        self.clock = clock
        # ``result`` parks on this between deadline checks; a real sleep
        # against a fake clock would never end, so it defaults on only
        # with the real clock.
        if sleep is None and clock is time.monotonic:
            sleep = time.sleep
        self._sleep = sleep
        self.bucket_aware = bucket_aware
        self.index_epoch = 0
        self._fingerprint = self.plan.fingerprint()
        if isinstance(admission, AdmissionPolicy):
            admission = AdmissionGate(admission, clock, registry=self.metrics)
        self.admission = admission
        self.compaction = compaction
        self.store_path = store_path
        self._last_compact = -float("inf")
        self._maintain_failures = 0
        self._maintain_error: str | None = None
        self._maintain_backoff_until = -float("inf")
        self._dispatch_failures = 0
        self._dispatch_error: str | None = None
        self._quarantined = tuple(getattr(self.retriever.index, "quarantined", ()) or ())
        if cache_size:
            self.result_cache: LRUCache | None = LRUCache(
                cache_size, registry=self.metrics, name="result"
            )
            self._rung_cache: LRUCache | None = LRUCache(
                cache_size, registry=self.metrics, name="rung"
            )
        else:
            self.result_cache = self._rung_cache = None
        self.scheduler = self._make_scheduler()
        self._inflight: set[int] = set()
        self._results: dict = {}
        # Typed failure outcomes, delivered by ``poll`` exactly once.
        self._errors: dict[int, Exception] = {}
        self._next_id = 0
        self.latencies: collections.deque = collections.deque(maxlen=4096)
        self._c = {
            "batches": self.metrics.counter("serving_batches_total", "Batches dispatched"),
            "padded_slots": self.metrics.counter(
                "serving_padded_slots_total",
                "Masked padding slots in under-full batches",
            ),
            "served": self.metrics.counter(
                "serving_requests_served_total", "Requests completed"
            ),
            "reloads": self.metrics.counter("serving_reloads_total", "Hot index swaps"),
            "cache_hits": self.metrics.counter(
                "serving_submit_cache_hits_total",
                "Requests completed at submit time by the result cache",
            ),
            "compactions": self.metrics.counter(
                "serving_compactions_total", "Store compactions run by maintain()",
            ),
            "deadline_shed": self.metrics.counter(
                "serving_deadline_shed_total",
                "Queued requests shed pre-dispatch at their deadline",
            ),
            "maintain_retries": self.metrics.counter(
                "serving_maintain_retries_total",
                "Failed maintain() ticks rolled back and scheduled for retry",
            ),
        }
        self._g_health = self.metrics.gauge(
            "serving_health_status", "health() status: 0=ok, 1=degraded, 2=overloaded",
        )
        self._h_dispatch = self.metrics.histogram(
            "serving_dispatch_seconds",
            "Batch dispatch latency (retrieve + result distribution)",
        )
        self._g_epoch = self.metrics.gauge("serving_index_epoch", "Current served index epoch")

    # ---- default-tenant views ----
    retriever = _default_tenant_field("retriever")
    plan = _default_tenant_field("plan")
    config = _default_tenant_field("config")
    store_path = _default_tenant_field("store_path")
    _requested_config = _default_tenant_field("requested_config")
    _fingerprint = _default_tenant_field("fingerprint")
    _quarantined = _default_tenant_field("quarantined")

    @property
    def stats(self) -> dict:
        """Counter dict (batches, padded_slots, served, reloads, cache_hits,
        compactions, deadline_shed, maintain_retries) from the registry."""
        return {k: int(c.value) for k, c in self._c.items()}

    # ---- multi-tenant routing ----
    def _state(self, tenant) -> _Tenant:
        try:
            return self._tenants[tenant]
        except KeyError:
            known = sorted(t for t in self._tenants if t is not None)
            raise KeyError(
                f"unknown tenant {tenant!r} (registered: {known or 'none'}; "
                f"None is the default index)"
            ) from None

    def _tenant_counters(self, tenant) -> dict:
        lab = "default" if tenant is None else tenant
        tc = self._tenant_c.get(lab)
        if tc is None:
            tc = self._tenant_c[lab] = {
                "submitted": self.metrics.counter(
                    "serving_tenant_submitted_total",
                    "Requests admitted for this tenant", tenant=lab,
                ),
                "served": self.metrics.counter(
                    "serving_tenant_served_total",
                    "Requests completed for this tenant", tenant=lab,
                ),
                "cache_hits": self.metrics.counter(
                    "serving_tenant_cache_hits_total",
                    "Submit-time result-cache hits for this tenant", tenant=lab,
                ),
            }
        return tc

    @staticmethod
    def _effective_filter(state: _Tenant, dfilter):
        """The request's ``dfilter`` intersected with the tenant's
        tombstone view: deleted docs stay invisible whatever the caller
        asked for."""
        if dfilter is not None and not isinstance(dfilter, DocFilter):
            raise TypeError(f"dfilter must be a DocFilter, got {type(dfilter).__name__}")
        if dfilter is None:
            return state.tomb
        if state.tomb is None:
            return dfilter
        return dfilter.intersect(state.tomb)

    def _plan_for(self, state: _Tenant, dfilter):
        """-> ``(plan, fingerprint, effective_filter)`` for one request;
        filtered plans are cached by ``Retriever.plan`` per filter digest."""
        eff = self._effective_filter(state, dfilter)
        if eff is None:
            return state.plan, state.fingerprint, None
        plan = state.retriever.plan(state.requested_config, dfilter=eff)
        return plan, plan.fingerprint(), eff

    @staticmethod
    def _group_for(tenant, eff) -> tuple | None:
        """Scheduler batch-homogeneity key: None for the default tenant
        unfiltered, else (tenant, filter digest)."""
        if tenant is None and eff is None:
            return None
        return (tenant, eff.digest if eff is not None else None)

    def _build_state(self, name, index, requested: WarpSearchConfig, *, store_path=None) -> _Tenant:
        """Load/plan/warm one tenant's index — everything that can fail
        runs here, before any server state is touched. A store path loads
        with ``quarantine_segments=True`` and brings its tombstones; an
        index object keeps ``store_path`` (the default tenant's reload
        keeps the server's store)."""
        if isinstance(index, (str, os.PathLike)):
            from repro_torch.store import load_index  # the store depends on core

            store_path = os.fspath(index)
            if self._group is not None:
                index = Retriever.from_store(store_path, device=self.device, group=self._group)
            else:
                index = load_index(store_path, device=self.device, quarantine_segments=True)
        ranked = isinstance(index, Retriever) and index.is_ranked
        if self._group is not None and not (ranked and index.index.group is self._group):
            raise ValueError(
                "a ranked server serves its own rank group only: pass a store path "
                "(each rank loads its shard) or a Retriever.from_store(path, group=) "
                "over the server's group"
            )
        if self._group is None and ranked:
            raise ValueError(
                "a ranked retriever needs a ranked server: build the RetrievalServer "
                "over a ranked retriever on rank 0"
            )
        retriever = (
            index if isinstance(index, Retriever)
            else Retriever.from_index(index, device=self.device)
        )
        plan = retriever.plan(requested)
        plan.warmup()
        deleted = frozenset()
        if store_path is not None:
            from repro_torch.store import read_tombstones

            deleted = frozenset(read_tombstones(store_path))
        return _Tenant(
            name=name,
            retriever=retriever,
            requested_config=requested,
            plan=plan,
            config=plan.config,
            fingerprint=plan.fingerprint(),
            store_path=store_path,
            quarantined=tuple(getattr(retriever.index, "quarantined", ()) or ()),
            deleted=deleted,
            tomb=_tombstone_view(deleted, retriever.n_docs),
        )

    def add_tenant(self, name: str, index, config: WarpSearchConfig | None = None) -> None:
        """Register another served index under ``name``: an index, a
        ``Retriever`` or a store path (loaded on the server's device). It
        gets its own plan ladder (``config`` defaults to the
        server's requested config), cache namespace and metrics labels,
        behind the one scheduler. A failing load/plan/warmup raises and
        registers nothing."""
        if not isinstance(name, str) or not name:
            raise TypeError(f"tenant name must be a non-empty string, got {name!r}")
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        requested = config if config is not None else self._requested_config
        self._tenants[name] = self._build_state(name, index, requested)
        self._tenant_counters(name)

    @property
    def tenants(self) -> tuple:
        """Registered tenant handles (the default index is ``None``)."""
        return tuple(sorted(self._tenants, key=lambda t: ("" if t is None else "\x01" + t)))

    def delete_documents(self, doc_ids, *, tenant=None) -> tuple:
        """Tombstone ``doc_ids`` on ``tenant``: invisible in every reply
        from now on, reclaimed at the next compaction. Store-backed tenants
        persist them (``store.delete_documents``); the epoch bump purges
        every cached result and queued requests are re-homed under the new
        filter. Returns the tenant's whole tombstone set."""
        st = self._state(tenant)
        ids = {int(i) for i in np.asarray(list(doc_ids), dtype=np.int64).ravel()}
        if st.store_path is not None:
            from repro_torch.store import delete_documents as store_delete

            st.deleted = frozenset(store_delete(st.store_path, sorted(ids)))
        else:
            st.deleted = frozenset(st.deleted | ids)
        st.tomb = _tombstone_view(st.deleted, st.retriever.n_docs)
        self.metrics.counter(
            "serving_tenant_deletes_total",
            "delete_documents calls for this tenant",
            tenant="default" if tenant is None else tenant,
        ).inc()
        self.index_epoch += 1
        self._g_epoch.set(self.index_epoch)
        self._purge_caches()
        self._rehome()
        obs.tracer().instant(
            "delete_documents",
            tenant="default" if tenant is None else tenant,
            tombstones=len(st.deleted),
        )
        return tuple(sorted(st.deleted))

    def _purge_caches(self) -> None:
        if self.result_cache is not None:
            self.result_cache.purge_epochs_below(self.index_epoch)
            self._rung_cache.purge_epochs_below(self.index_epoch)

    def _make_scheduler(self) -> BucketScheduler:
        """One FIFO per ladder rung on bucket-aware adaptive plans; a
        single queue otherwise."""
        rungs = None
        if self.bucket_aware and self.plan.adaptive:
            rungs = self.config.worklist_buckets
        return BucketScheduler(self.policy, self.clock, rungs=rungs, registry=self.metrics)

    def _cache_key(self, qkey: str, fp: str | None = None) -> tuple:
        # The epoch stays the trailing element: purge_epochs_below keys on k[-1].
        return (qkey, fp if fp is not None else self._fingerprint, self.index_epoch)

    def _ladder(self, plan) -> tuple | None:
        """The rungs a request on ``plan`` may be promoted along (its own
        tenant's ladder), or None off the bucket-aware path."""
        if self.bucket_aware and plan.adaptive:
            return plan.config.worklist_buckets
        return None

    def _rung_for(self, q, qmask, qkey: str | None, *, plan=None, fp=None):
        """Admission-time probe pre-pass (level-1 cached): the worklist
        rung this query needs on ``plan``, or None off the bucket-aware
        path."""
        if plan is None:
            plan = self.plan
        if not (self.bucket_aware and plan.adaptive):
            return None
        if self._rung_cache is not None and qkey is not None:
            key = self._cache_key(qkey, fp)
            hit = self._rung_cache.get(key)
            if hit is not None:
                return hit[0]
            rung = plan.adaptive_bucket(q, qmask)
            self._rung_cache.put(key, (rung,))
            return rung
        return plan.adaptive_bucket(q, qmask)

    # ---- client API ----
    def submit(
        self,
        q,
        qmask=None,
        *,
        deadline_s: float | None = None,
        tenant: str | None = None,
        dfilter: DocFilter | None = None,
    ) -> int:
        """Admit one query q f32[Q, D]; returns its request id.

        Raises ``Overloaded`` (nothing enqueued, no id burned) when the
        admission gate sheds. A result-cache hit completes the request at
        once. ``deadline_s`` (seconds from now, server clock) sheds the
        request if it is still queued then. ``tenant`` routes to an
        ``add_tenant`` index; ``dfilter`` restricts retrieval to its
        surviving doc ids (intersected with the tenant's tombstones)."""
        q = np.asarray(q, np.float32)
        qmask = np.ones(q.shape[:-1], bool) if qmask is None else np.asarray(qmask, bool)
        with obs.span("submit", queue_depth=len(self.scheduler)) as sp:
            if self.admission is not None:
                with obs.span("admission"):
                    self.admission.check(len(self.scheduler))
            # Resolve routing before burning an id.
            state = self._state(tenant)
            plan, fp, eff = self._plan_for(state, dfilter)
            qkey = (
                query_key(q, qmask, dfilter=eff, tenant=tenant)
                if self.result_cache is not None else None
            )
            rid = self._next_id
            self._next_id += 1
            sp.set(rid=rid, tenant="default" if tenant is None else tenant)
            tc = self._tenant_counters(tenant)
            tc["submitted"].inc()
            if qkey is not None:
                hit = self.result_cache.get(self._cache_key(qkey, fp))
                if hit is not None:
                    self._results[rid] = hit
                    self._c["cache_hits"].inc()
                    self._c["served"].inc()
                    tc["cache_hits"].inc()
                    tc["served"].inc()
                    sp.set(cache_hit=True)
                    return rid
            with obs.span("rung_prepass") as rp:
                rung = self._rung_for(q, qmask, qkey, plan=plan, fp=fp)
                rp.set(rung=rung)
            now = self.clock()
            deadline = None if deadline_s is None else now + deadline_s
            group = self._group_for(tenant, eff)
            self.scheduler.push(
                _Pending(
                    rid, q, qmask, now, qkey, deadline,
                    tenant=tenant, dfilter=dfilter, plan=plan, fp=fp, group=group,
                ),
                rung,
                group=group,
                rungs=self._ladder(plan),
            )
            self._inflight.add(rid)
            return rid

    def poll(self, req_id: int):
        """Completed -> pops ``(scores, doc_ids)`` exactly once; shed or
        failed -> pops and raises its error exactly once; queued ->
        ``PENDING``; delivered before -> ``ResultAlreadyTaken``; never
        submitted -> ``KeyError``."""
        if req_id in self._results:
            return self._results.pop(req_id)
        if req_id in self._errors:
            raise self._errors.pop(req_id)
        if req_id in self._inflight:
            return PENDING
        if 0 <= req_id < self._next_id:
            raise ResultAlreadyTaken(
                f"result for request id {req_id} was already retrieved "
                f"(results pop exactly once)"
            )
        raise KeyError(f"request id {req_id} was never submitted")

    def result(self, req_id: int, timeout: float | None = None):
        """Drive the server loop until ``req_id`` completes. On the real
        clock it sleeps until the next batch deadline instead of spinning;
        with an injected clock (no sleep) it forces a padded dispatch.
        ``TimeoutError`` after ``timeout`` (the request stays queued)."""
        start = self.clock()
        while True:
            out = self.poll(req_id)
            if out is not PENDING:
                return out
            if timeout is not None and self.clock() - start >= timeout:
                raise TimeoutError(
                    f"request {req_id} not served within {timeout}s "
                    f"(still queued; poll() can retrieve it later)"
                )
            if self.step() > 0:
                continue
            nd = self.next_deadline()
            now = self.clock()
            if self._sleep is not None and nd is not None and nd > now:
                wait = min(nd - now, self.policy.max_wait_s)
                if timeout is not None:
                    wait = min(wait, max(start + timeout - now, 0.0))
                if wait > 0.0:
                    self._sleep(wait)
                    continue
            self.step(force=True)

    # ---- lifecycle ----
    def _rehome(self) -> None:
        """Re-admit every queued request against the current tenant states
        (rung, cache key and group are stale after a reload or a delete)."""
        pending = []
        old_sched = self.scheduler
        while len(old_sched):
            got = old_sched.next_batch(force=True)
            if got is None:
                break
            pending.extend(got[1])
        self.scheduler = self._make_scheduler()
        for p in sorted(pending, key=lambda p: p.arrival):
            self._readmit(p)

    def _readmit(self, p: _Pending) -> None:
        state = self._tenants.get(p.tenant)
        err = None
        if state is None:
            err = KeyError(
                f"tenant {p.tenant!r} was removed while request {p.req_id} was queued"
            )
        else:
            try:
                p.plan, p.fp, eff = self._plan_for(state, p.dfilter)
            except (TypeError, ValueError) as e:
                err = e
        if err is not None:
            self._errors[p.req_id] = err
            self._inflight.discard(p.req_id)
            return
        p.qkey = (
            query_key(p.q, p.qmask, dfilter=eff, tenant=p.tenant)
            if self.result_cache is not None else None
        )
        p.group = self._group_for(p.tenant, eff)
        rung = self._rung_for(p.q, p.qmask, p.qkey, plan=p.plan, fp=p.fp)
        self.scheduler.push(p, rung, group=p.group, rungs=self._ladder(p.plan))

    def reload(
        self,
        index,
        *,
        config: WarpSearchConfig | None = None,
        tenant: str | None = None,
    ) -> None:
        """Hot-swap ``tenant``'s index (default: the server's) without
        downtime. ``index`` is an index, a ``Retriever`` or a store path
        (loaded on the server's device, with corrupt delta segments
        quarantined). Validate-then-swap: the load, the plan (from
        the originally *requested* config, so t' and the ladder re-resolve
        against the new geometry) and its ``warmup`` run before anything
        is mutated, so a failed reload raises and leaves epoch, caches,
        queue and the old index as they were. Then the epoch bumps, caches
        are purged and queued requests are re-homed onto the new ladders.
        The new index is placed before the old one is dropped: for a
        moment the tenant's index is held twice."""
        t0 = time.perf_counter()
        if fault.FAULTS.plan is not None:
            fault.FAULTS.plan.check("server.reload", index=str(index)[:120])
        old = self._state(tenant)
        requested = config if config is not None else old.requested_config
        state = self._build_state(
            tenant, index, requested, store_path=old.store_path if tenant is None else None
        )
        # ---- commit point: nothing below raises but the last close ----
        self._tenants[tenant] = state
        self.index_epoch += 1
        self._purge_caches()
        self._rehome()
        self._c["reloads"].inc()
        self._g_epoch.set(self.index_epoch)
        self.metrics.histogram(
            "serving_reload_seconds", "Hot index swap duration"
        ).observe(time.perf_counter() - t0)
        obs.tracer().instant("reload", epoch=self.index_epoch)
        if old.retriever.is_ranked and all(
            t.retriever is not old.retriever for t in self._tenants.values()
        ):
            old.retriever.close()  # every rank drops the old shard

    def maintain(self) -> bool:
        """One maintenance tick: ``compact`` + ``reload`` of the default
        tenant's store when the compaction policy fires (at most once per
        ``min_interval_s``). Returns True when a compaction ran. A failed
        tick rolls the on-disk swap back (``recover_interrupted_compact``),
        keeps serving the old epoch and waits out an exponential backoff
        before the next attempt."""
        if self.compaction is None or self.store_path is None:
            return False
        now = self.clock()
        if now < self._maintain_backoff_until:
            return False
        if now - self._last_compact < self.compaction.min_interval_s:
            return False
        from repro_torch.store import compact, delta_stats
        from repro_torch.store.format import recover_interrupted_compact

        try:
            if not self.compaction.should_compact(delta_stats(self.store_path)):
                return False
            with obs.span("compaction", store=self.store_path):
                compact(self.store_path)
                self._last_compact = self.clock()
                self.reload(self.store_path)
        except Exception as e:
            try:
                recover_interrupted_compact(self.store_path)
            except Exception:
                pass  # recovery is best-effort; the old store is untouched
            self._maintain_failures += 1
            self._maintain_error = repr(e)
            backoff = min(
                self.compaction.retry_backoff_s * 2 ** (self._maintain_failures - 1),
                self.compaction.retry_backoff_max_s,
            )
            self._maintain_backoff_until = now + backoff
            self._c["maintain_retries"].inc()
            warnings.warn(
                f"maintain() failed ({e!r}); still serving epoch "
                f"{self.index_epoch}, retrying in {backoff:g}s",
                RuntimeWarning,
                stacklevel=2,
            )
            return False
        self._maintain_failures = 0
        self._maintain_error = None
        self._maintain_backoff_until = -float("inf")
        self._c["compactions"].inc()
        return True

    # ---- server loop ----
    def next_deadline(self) -> float | None:
        """Earliest queued-batch deadline (None when idle)."""
        return self.scheduler.next_deadline()

    def _reap_expired(self) -> int:
        """Shed queued requests past their deadline, before dispatch; each
        gets a ``DeadlineExceeded`` from its next ``poll``."""
        now = self.clock()
        expired = self.scheduler.reap(lambda p: p.deadline is not None and now >= p.deadline)
        for p in expired:
            self._errors[p.req_id] = DeadlineExceeded(
                f"request {p.req_id} queued past its deadline "
                f"(waited {max(now - p.arrival, 0.0):.4f}s); shed before dispatch"
            )
            self._inflight.discard(p.req_id)
        if expired:
            self._c["deadline_shed"].inc(len(expired))
        return len(expired)

    def step(self, *, force: bool = False) -> int:
        """Dispatch at most one batch; returns the requests served. An
        exception in the batch's dispatch propagates (see the module
        docstring); every member's ``poll`` then raises it once."""
        self._reap_expired()
        got = self.scheduler.next_batch(force=force)
        if got is None:
            return 0
        rung, batch = got
        tr = obs.STATE.tracer
        if tr is not None:
            # Queue-wait rows measured on the server clock (the clock of
            # ``arrival``) and anchored to end now on the tracer's clock.
            now_srv, now_tr = self.clock(), tr.clock()
            for p in batch:
                wait = max(now_srv - p.arrival, 0.0)
                tr.add_event(
                    "queue_wait", now_tr - wait, wait, tid=p.req_id,
                    rung="none" if rung is None else rung,
                )
        t0 = time.perf_counter()
        plan = batch[0].plan if batch[0].plan is not None else self.plan
        tenant = batch[0].tenant
        with obs.span(
            "batch_dispatch",
            rung="none" if rung is None else rung,
            tenant="default" if tenant is None else tenant,
            batch_size=len(batch), rids=[p.req_id for p in batch],
        ):
            b = self.policy.max_batch
            qm, d = batch[0].q.shape
            q = np.zeros((b, qm, d), np.float32)
            mask = np.zeros((b, qm), bool)
            for i, p in enumerate(batch):
                q[i] = p.q
                mask[i] = p.qmask
            try:
                if rung is None:
                    res = plan.retrieve_batch(q, mask)
                else:
                    res = plan.retrieve_batch_at(q, mask, bucket=rung)
                scores = res.scores.cpu().numpy()
                docs = res.doc_ids.cpu().numpy()
            except Exception as e:
                for p in batch:
                    self._errors[p.req_id] = e
                    self._inflight.discard(p.req_id)
                self._dispatch_failures += 1
                self._dispatch_error = repr(e)
                raise
            self._dispatch_failures = 0
            self._dispatch_error = None
            with obs.span("reply"):
                now = self.clock()
                tc = self._tenant_counters(tenant)
                for i, p in enumerate(batch):
                    pair = (scores[i], docs[i])
                    self._results[p.req_id] = pair
                    self._inflight.discard(p.req_id)
                    self.latencies.append(now - p.arrival)
                    tc["served"].inc()
                    if self.result_cache is not None and p.qkey is not None:
                        self.result_cache.put(self._cache_key(p.qkey, p.fp), pair)
        self._h_dispatch.observe(time.perf_counter() - t0)
        self._c["batches"].inc()
        self._c["padded_slots"].inc(b - len(batch))
        self._c["served"].inc(len(batch))
        return len(batch)

    def drain(self) -> None:
        while len(self.scheduler):
            self.step(force=True)

    def summary(self) -> dict:
        """Dispatch counters, per-rung batch stats and occupancy, cache hit
        rates, shed/admitted counts, epoch, per-tenant counts (JAX's keys),
        plus the p50/p95 submit-to-reply seconds of the last 4096 replies
        and the device."""
        out = dict(self.stats)
        out["queue_depth"] = len(self.scheduler)
        out["promoted"] = self.scheduler.stats["promoted"]
        out["rungs"] = {str(r): dict(s) for r, s in self.scheduler.stats["rungs"].items()}
        out["rung_occupancy"] = {str(r): v for r, v in self.scheduler.occupancy().items()}
        out["index_epoch"] = self.index_epoch
        if self.result_cache is not None:
            out["result_cache"] = self.result_cache.stats()
            out["rung_cache"] = self._rung_cache.stats()
        if self.admission is not None:
            out["shed"] = self.admission.shed
            out["admitted"] = self.admission.admitted
        if len(self._tenants) > 1 or self._tenants[None].deleted:
            out["tenants"] = {
                ("default" if t is None else t): {
                    "submitted": int(self._tenant_counters(t)["submitted"].value),
                    "served": int(self._tenant_counters(t)["served"].value),
                    "cache_hits": int(self._tenant_counters(t)["cache_hits"].value),
                    "tombstones": len(st.deleted),
                    "n_docs": st.retriever.n_docs,
                }
                for t, st in self._tenants.items()
            }
        if self.latencies:
            lat = np.asarray(self.latencies)
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p95_s"] = float(np.percentile(lat, 95))
        out["device"] = str(self.device)
        return out

    def health(self) -> dict:
        """``{"status": "ok" | "degraded" | "overloaded", "reasons": [...],
        ...}``: degraded = still answering with reduced capability
        (quarantined delta segments, failing maintenance, a failed batch
        dispatch since the last good one); overloaded = the admission gate
        is at its queue-depth limit. Also set on the
        ``serving_health_status`` gauge (0/1/2)."""
        reasons = []
        depth = len(self.scheduler)
        overloaded = (
            self.admission is not None and depth >= self.admission.policy.max_queue_depth
        )
        if overloaded:
            reasons.append(
                f"queue depth {depth} at admission limit "
                f"{self.admission.policy.max_queue_depth}; shedding"
            )
        for t, st in self._tenants.items():
            lab = "" if t is None else f" (tenant {t!r})"
            if st.quarantined:
                reasons.append(
                    f"quarantined delta segment(s){lab}: " + ", ".join(st.quarantined)
                )
        if self._dispatch_failures:
            reasons.append(
                f"batch dispatch failing (x{self._dispatch_failures}): {self._dispatch_error}"
            )
        if self._maintain_failures:
            reasons.append(
                f"maintenance failing (x{self._maintain_failures}): {self._maintain_error}"
            )
        status = "overloaded" if overloaded else ("degraded" if reasons else "ok")
        self._g_health.set({"ok": 0, "degraded": 1, "overloaded": 2}[status])
        return {
            "status": status,
            "reasons": reasons,
            "queue_depth": depth,
            "index_epoch": self.index_epoch,
            "quarantined_segments": list(self._quarantined),
            "executor_fallback": False,  # the port has no fallback
            "maintain_failures": self._maintain_failures,
            "dispatch_failures": self._dispatch_failures,
            "tenants": ["default" if t is None else t for t in self.tenants],
        }


def follow(group) -> dict:
    """The loop of ranks 1..S-1 of a ranked server (or of any ranked
    retriever that rank 0 drives): run each collective operation rank 0
    broadcasts (a store load, then calls of the retrievers and plans it
    made: plan, warm-up, rung pre-pass, retrieve, batch, batch at a rung,
    close) on this rank's shard, until rank 0 calls ``group.stop()``. An
    operation that failed in a collective raised the same failure on
    every rank (``group.settled``), so the loop records it and goes on, as
    rank 0 does. Any other failure left rank 0 in a collective this rank
    will not enter: it propagates, the rank's process exits nonzero, and
    ``launch.ranks.run_world`` ends the world. Returns ``{"ops":
    operations run, "failed": those that raised, "last_error": the last
    one's "Type: message" or None}``."""
    if group.rank == 0:
        raise ValueError("rank 0 leads the group; follow() runs on ranks 1..S-1")
    out = {"ops": 0, "failed": 0, "last_error": None}
    group.following = True
    try:
        while True:
            cmd = group.receive()
            if cmd[0] == "stop":
                return out
            out["ops"] += 1
            try:
                if cmd[0] == "load":
                    Retriever.from_store(cmd[1], group=group)
                else:  # ("call", number, method, args, kwargs)
                    _, oid, method, args, kwargs = cmd
                    getattr(group.lookup(oid), method)(*args, **kwargs)
            except Exception as e:
                if e is not group.settled:
                    raise
                out["failed"] += 1
                out["last_error"] = f"{type(e).__name__}: {e}"
    finally:
        group.following = False
