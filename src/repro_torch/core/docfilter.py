"""Doc-id filtering: ``DocFilter`` and its plan-time resolution to a
``FilterView``. Counterpart of ``repro/core/docfilter.py`` (see its
docstring for the exactness argument).

A ``DocFilter`` (allowlist, denylist, bitmap, or a tombstone view over
deleted ids) is one survivor bitmap ``bool[n_docs]`` on the host. At plan
time it is resolved against an index into a ``FilterView``: the bitmap
on the index's device plus ``cluster_live`` (True where a cluster holds
at least one surviving token). The engine uses the view twice: probe runs
over dead clusters get size 0 before the worklist or the dense grid's
valid mask (pushdown), and the reduction masks filtered documents' totals
to -inf before the top-k. Imputation never depends on which candidates
survive, so filtered top-k doc ids equal post-hoc filtering of an
unfiltered retrieval at a larger k.

A document-sharded index resolves to a stacked view
(``resolve_sharded``): per-shard doc masks over shard-local ids, each
with a dead padding slot, and per-shard cluster liveness. One rank's shard
(``RankedShard``) resolves to its row of that view (``resolve_rank``).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "DocFilter",
    "FilterView",
    "cluster_survivor_counts",
    "local_shard_mask",
    "resolve_local",
    "resolve_rank",
    "resolve_segmented",
    "resolve_sharded",
]


class FilterView(NamedTuple):
    """A ``DocFilter`` resolved against one index geometry.

    doc_mask      bool[n_docs] on the index's device, True where the doc
                  survives (a segment's LOCAL ids for a segment's view).
    cluster_live  bool[C] on the index's device, True where the cluster
                  holds >= 1 surviving token.

    Stacked for a sharded index: doc_mask ``[S, local_docs + 1]``,
    cluster_live ``[S, C]``.
    """

    doc_mask: torch.Tensor
    cluster_live: torch.Tensor


def _as_id_array(ids) -> np.ndarray:
    return np.asarray(sorted(set(int(i) for i in ids)), dtype=np.int64).reshape(-1)


class DocFilter:
    """Immutable survivor bitmap over global doc ids.

      DocFilter.allow(ids, n_docs)       only ``ids`` survive
      DocFilter.deny(ids, n_docs)        everything but ``ids`` survives
      DocFilter.from_bitmap(mask)        explicit bool[n_docs]
      DocFilter.tombstones(ids, n_docs)  deny view over deleted ids

    All normalize to one bitmap, so an allowlist and the complementary
    denylist share a digest. Ids outside ``[0, n_docs)`` are dropped.
    """

    __slots__ = ("_mask", "_kind", "_digest")

    def __init__(self, mask, *, kind: str = "bitmap"):
        mask = np.ascontiguousarray(np.asarray(mask, dtype=bool).reshape(-1))
        mask.setflags(write=False)
        self._mask = mask
        self._kind = kind
        h = hashlib.sha1()
        h.update(str(mask.shape[0]).encode())
        h.update(np.packbits(mask).tobytes())
        self._digest = h.hexdigest()[:16]

    @classmethod
    def allow(cls, ids, n_docs: int) -> "DocFilter":
        mask = np.zeros(int(n_docs), dtype=bool)
        arr = _as_id_array(ids)
        mask[arr[(arr >= 0) & (arr < n_docs)]] = True
        return cls(mask, kind="allow")

    @classmethod
    def deny(cls, ids, n_docs: int) -> "DocFilter":
        mask = np.ones(int(n_docs), dtype=bool)
        arr = _as_id_array(ids)
        mask[arr[(arr >= 0) & (arr < n_docs)]] = False
        return cls(mask, kind="deny")

    @classmethod
    def from_bitmap(cls, mask) -> "DocFilter":
        return cls(mask, kind="bitmap")

    @classmethod
    def tombstones(cls, deleted_ids, n_docs: int) -> "DocFilter":
        f = cls.deny(deleted_ids, n_docs)
        f._kind = "tombstone"
        return f

    @property
    def kind(self) -> str:
        return self._kind

    @property
    def n_docs(self) -> int:
        return int(self._mask.shape[0])

    @property
    def n_survivors(self) -> int:
        return int(self._mask.sum())

    @property
    def survivor_mask(self) -> np.ndarray:
        """The read-only survivor bitmap, bool[n_docs] on the host."""
        return self._mask

    @property
    def digest(self) -> str:
        """Content hash of (n_docs, bitmap): the plan cache's key."""
        return self._digest

    @property
    def is_noop(self) -> bool:
        return bool(self._mask.all())

    def intersect(self, other: "DocFilter") -> "DocFilter":
        """AND of two filters of the same length."""
        if other.n_docs != self.n_docs:
            raise ValueError(
                f"DocFilter.intersect: length mismatch ({self.n_docs} vs {other.n_docs})"
            )
        return DocFilter(self._mask & other._mask, kind="bitmap")

    def describe(self) -> dict:
        return {
            "kind": self._kind,
            "n_docs": self.n_docs,
            "n_survivors": self.n_survivors,
            "digest": self._digest,
        }

    def __eq__(self, other) -> bool:
        return isinstance(other, DocFilter) and other._digest == self._digest

    def __hash__(self) -> int:
        return hash(self._digest)

    def __repr__(self) -> str:
        return (
            f"DocFilter(kind={self._kind!r}, n_docs={self.n_docs}, "
            f"n_survivors={self.n_survivors}, digest={self._digest!r})"
        )


def cluster_survivor_counts(mask, token_doc_ids, cluster_offsets):
    """Per-cluster count of tokens whose doc survives ``mask``, from the
    CSR-ordered token->doc map and its ``[C + 1]`` cluster boundaries;
    doc ids outside ``[0, len(mask))`` count as filtered. numpy inputs give
    i64[C] numpy (the compaction's host path); tensors give an i64[C]
    tensor on ``token_doc_ids``' device."""
    if not isinstance(token_doc_ids, torch.Tensor):
        mask = np.asarray(mask, dtype=bool).reshape(-1)
        tok = np.asarray(token_doc_ids, dtype=np.int64).reshape(-1)
        off = np.asarray(cluster_offsets, dtype=np.int64).reshape(-1)
        in_range = (tok >= 0) & (tok < mask.shape[0])
        surv = np.zeros(tok.shape[0], dtype=np.int64)
        surv[in_range] = mask[tok[in_range]]
        csum = np.concatenate([[0], np.cumsum(surv)])
        return (csum[off[1:]] - csum[off[:-1]]).astype(np.int64)
    dev = token_doc_ids.device
    mask = torch.as_tensor(mask, dtype=torch.bool).to(dev).reshape(-1)
    tok = token_doc_ids.long().reshape(-1)
    off = cluster_offsets.to(dev).long().reshape(-1)
    n = mask.shape[0]
    surv = (tok >= 0) & (tok < n)
    if n:
        surv &= mask[tok.clamp(0, n - 1)]
    csum = torch.zeros(tok.shape[0] + 1, dtype=torch.long, device=dev)
    csum[1:] = torch.cumsum(surv.long(), 0)
    return csum[off[1:]] - csum[off[:-1]]


def resolve_local(dfilter: DocFilter, index) -> FilterView:
    """Resolve against a single ``WarpIndex`` on its device."""
    dev = index.token_doc_ids.device
    mask = torch.from_numpy(dfilter.survivor_mask.copy()).to(dev)
    counts = cluster_survivor_counts(mask, index.token_doc_ids, index.cluster_offsets)
    return FilterView(doc_mask=mask, cluster_live=counts > 0)


def local_shard_mask(mask: np.ndarray, start: int, local_docs: int) -> np.ndarray:
    """A global survivor bitmap sliced to one shard's local ids:
    ``bool[local_docs + 1]`` from global id ``start`` on; the last slot is
    the shard's padding doc id and always False."""
    out = np.zeros(int(local_docs) + 1, dtype=bool)
    lo = int(start)
    hi = min(lo + int(local_docs), mask.shape[0])
    if hi > lo:
        out[: hi - lo] = mask[lo:hi]
    return out


def resolve_sharded(dfilter: DocFilter, sidx) -> FilterView:
    """Resolve against a ``ShardedWarpIndex`` on its device: stacked
    doc masks ``[S, local_docs + 1]`` and cluster liveness ``[S, C]``
    (padding tokens carry the dead padding id, so they never count)."""
    mask = dfilter.survivor_mask
    dev = sidx.token_doc_ids.device
    starts = sidx.doc_start.cpu().numpy().astype(np.int64).reshape(-1)
    masks = torch.from_numpy(
        np.stack([local_shard_mask(mask, st, sidx.local_docs) for st in starts])
    ).to(dev)
    live = torch.stack([
        cluster_survivor_counts(masks[s], sidx.token_doc_ids[s], sidx.cluster_offsets[s]) > 0
        for s in range(starts.shape[0])
    ])
    return FilterView(doc_mask=masks, cluster_live=live)


def resolve_rank(dfilter: DocFilter, shard) -> FilterView:
    """Resolve against one rank's shard (``distributed.RankedShard``) on
    its device: row ``rank`` of ``resolve_sharded``'s stacked view, the doc
    mask ``[local_docs + 1]`` from the shard's ``doc_start`` and the
    cluster liveness ``[C]`` of its own tokens."""
    local = shard.local
    mask = torch.from_numpy(
        local_shard_mask(dfilter.survivor_mask, shard.doc_start, shard.local_docs)
    ).to(local.device)
    live = cluster_survivor_counts(mask, local.token_doc_ids, local.cluster_offsets) > 0
    return FilterView(doc_mask=mask, cluster_live=live)


def resolve_segmented(dfilter: DocFilter, seg):
    """Resolve against a ``SegmentedWarpIndex`` (base + deltas) ->
    ``(global_view, per_segment_views, per_segment_live)``:

      global_view        GLOBAL doc ids; its cluster_live is the
                         any-segment liveness
      per_segment_views  each segment's LOCAL doc ids (the dense path)
      per_segment_live   np.bool_[n_segments, C] on the host (the
                         ragged path's runs and demand)
    """
    mask = dfilter.survivor_mask
    dev = seg.base.token_doc_ids.device
    seg_views, seg_live = [], []
    for sub, start in zip(seg.segments, seg.doc_starts):
        lm = np.zeros(int(sub.n_docs), dtype=bool)
        hi = min(int(start) + int(sub.n_docs), mask.shape[0])
        if hi > start:
            lm[: hi - start] = mask[start:hi]
        lm_t = torch.from_numpy(lm).to(dev)
        live = cluster_survivor_counts(lm_t, sub.token_doc_ids, sub.cluster_offsets) > 0
        seg_views.append(FilterView(doc_mask=lm_t, cluster_live=live))
        seg_live.append(live.cpu().numpy())
    per_segment_live = np.stack(seg_live) if seg_live else np.zeros((0, 0), dtype=bool)
    global_view = FilterView(
        doc_mask=torch.from_numpy(mask.copy()).to(dev),
        cluster_live=torch.from_numpy(per_segment_live.any(axis=0)).to(dev),
    )
    return global_view, tuple(seg_views), per_segment_live
