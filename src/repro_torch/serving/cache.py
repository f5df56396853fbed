"""Two-level serving cache: encoded-query admission cache + LRU results.
Counterpart of ``repro/serving/cache.py``: ``query_key`` gives the same
hex for the same float32 query, mask, filter digest and tenant.

Zipf-skewed traffic (the regime real query logs show) repeats a small head of queries often
enough that recomputing them is pure waste. The server keeps two levels:

- **encoded-query cache** (level 1): the admission-time probe pre-pass
  result — the adaptive worklist rung ``SearchPlan.adaptive_bucket``
  chose for this query. A hit skips the WARP_SELECT pre-pass entirely on
  resubmission of a known query.
- **result cache** (level 2): the final ``(scores, doc_ids)`` pair. A hit
  skips retrieval altogether and completes the request at submit time.

Both levels key entries on ``(query hash, plan fingerprint, index
epoch)``:

- the *query hash* (``query_key``) digests the canonical float32 bytes of
  the masked query matrix, so numerically identical queries collide
  regardless of array identity or padding garbage in masked rows;
- the *plan fingerprint* (``SearchPlan.fingerprint``) digests every
  resolved pipeline choice, so a config or geometry change can never
  serve a stale entry;
- the *index epoch* is bumped by ``RetrievalServer.reload()``, so a
  compaction (or any hot swap) invalidates everything cached against the
  old index — a cached rung from a pre-compaction ladder could silently
  truncate worklist tiles, and cached doc ids could name re-based
  documents; the epoch key makes both structurally impossible.

Eviction is plain LRU per level; ``purge_epochs_below`` drops dead-epoch
entries eagerly on reload so they don't squat in the LRU window.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

__all__ = ["query_key", "LRUCache"]


def query_key(q, qmask, *, dfilter=None, tenant=None) -> str:
    """Canonical content hash of one query.

    Masked rows are zeroed before hashing — their embedding values never
    reach the pipeline (the engine drops masked candidates and suppresses
    their worklist tiles), so two queries that differ only in masked-row
    garbage are the same query.

    ``dfilter`` (a ``DocFilter``, or any object with a ``digest`` str) and
    ``tenant`` fold the request's filter identity and routing handle into
    the hash: the same embedding under different filters (or different
    tenants) retrieves different documents, so the entries must never
    alias — a filtered request hitting an unfiltered entry would leak
    filtered-out (or cross-tenant) doc ids straight out of the cache.
    """
    q = np.ascontiguousarray(np.asarray(q, np.float32))
    m = np.ascontiguousarray(np.asarray(qmask, bool))
    canon = np.where(m[..., None], q, 0.0).astype(np.float32)
    h = hashlib.sha1()
    h.update(str(canon.shape).encode())
    h.update(canon.tobytes())
    h.update(m.tobytes())
    if dfilter is not None:
        h.update(b"|filter:")
        h.update(str(getattr(dfilter, "digest", dfilter)).encode())
    if tenant is not None:
        h.update(b"|tenant:")
        h.update(str(tenant).encode())
    return h.hexdigest()[:20]


class LRUCache:
    """Bounded least-recently-used mapping with hit/miss counters.

    Keys are ``(query_key, plan_fingerprint, epoch)`` tuples (any hashable
    works). ``get`` refreshes recency; ``put`` evicts the coldest entry
    past ``capacity``. Not thread-safe — the server loop is single-owner,
    like the batcher it serves.
    """

    def __init__(self, capacity: int = 256, *, registry=None, name: str = "cache"):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        # Optional mirror into a repro_torch.obs MetricsRegistry (the server
        # passes its own, labeled per cache level); the plain ints stay
        # the source of truth for ``stats()``.
        if registry is not None:
            self._c_hits = registry.counter(
                "serving_cache_hits_total", "Cache lookups served", cache=name
            )
            self._c_misses = registry.counter(
                "serving_cache_misses_total", "Cache lookups missed", cache=name
            )
            self._g_size = registry.gauge(
                "serving_cache_size", "Entries resident in the cache", cache=name
            )
        else:
            self._c_hits = self._c_misses = self._g_size = None

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def get(self, key):
        """Value for ``key`` or None; counts a hit/miss either way."""
        try:
            v = self._d[key]
        except KeyError:
            self.misses += 1
            if self._c_misses is not None:
                self._c_misses.inc()
            return None
        self._d.move_to_end(key)
        self.hits += 1
        if self._c_hits is not None:
            self._c_hits.inc()
        return v

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
        if self._g_size is not None:
            self._g_size.set(len(self._d))

    def purge_epochs_below(self, epoch: int) -> int:
        """Drop every entry whose key's trailing element (the index epoch)
        is below ``epoch``; returns the number dropped. Called on
        ``reload()`` so dead-epoch entries free their LRU slots at once
        instead of aging out."""
        dead = [k for k in self._d if k[-1] < epoch]
        for k in dead:
            del self._d[k]
        if self._g_size is not None:
            self._g_size.set(len(self._d))
        return len(dead)

    def clear(self) -> None:
        self._d.clear()
        if self._g_size is not None:
            self._g_size.set(0)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._d),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
        }
