"""Document-sharded WARP: a stack of per-shard indexes searched as one.
Counterpart of ``repro/core/distributed.py``.

The corpus is cut into contiguous, token-balanced document ranges; every
document's tokens live in one shard, so the token-level max and the
document-level sum stay inside a shard and only the final top-k merges
across shards. Imputation is aligned globally: each shard's top-kk
(centroid score, cluster size) pairs are concatenated shard-major and one
``impute_mse`` over them gives the m_i every shard scores with.

Placement: the JAX package maps the shard axis onto the devices of a
mesh (``shard_map``). The port keeps the stacked ``[S, ...]`` tensors on
one device and runs the per-shard body shard by shard in one process, the
single-controller reading of ``shard_map``: the same stages in the same
order, on the card or on the CPU. Each shard runs the engine's exported
stages, so its scoring dispatch (and the ``engine.kernel_call`` fault
site inside it) fires once per shard per retrieve.

The reduction keys on int64 (``core/reduction.py``), so it needs no
overflow guard; a shard's local view still carries ``n_docs = local_docs
+ 1``, the id bound JAX's guard reads, which keeps stored shard views
byte-identical to JAX's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.docfilter import FilterView
from repro_torch.core.index import build_index
from repro_torch.core.reduction import TopKResult
from repro_torch.core.types import IndexBuildConfig, WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import WarpSelectOut, impute_mse, topk_lower_index_first

__all__ = [
    "ShardedWarpIndex",
    "build_sharded_index",
    "finish_sharded",
    "local_index",
    "resolve_sharded_config",
    "select_sharded",
    "shard_doc_bounds",
    "shard_index",
    "sharded_probe_sizes",
    "sharded_search",
    "stack_shards",
]

SHARDED_ARRAYS = (
    "centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
    "cluster_sizes", "bucket_weights", "doc_start",
)
SHARDED_STATIC = (
    "dim", "nbits", "cap", "n_docs", "n_tokens_padded", "n_tokens_total", "local_docs",
)
_DTYPES = {
    "centroids": torch.float32,
    "packed_codes": torch.uint8,
    "token_doc_ids": torch.int32,
    "cluster_offsets": torch.int32,
    "cluster_sizes": torch.int32,
    "bucket_weights": torch.float32,
    "doc_start": torch.int32,
}


@dataclasses.dataclass(frozen=True)
class ShardedWarpIndex:
    """Per-shard index arrays stacked on a leading shard axis, on one device.

    Shards are padded to one geometry: padding clusters have size 0 (their
    offset is the shard's token count), padding tokens carry doc id
    ``local_docs`` (never surfaced). ``n_tokens_padded`` is the per-shard
    CSR length, ``n_tokens_total`` the true corpus token count (what t'
    resolves from), ``local_docs`` the largest shard-local doc count.
    """

    centroids: torch.Tensor  # f32[S, C, D]
    packed_codes: torch.Tensor  # u8[S, N, PB]
    token_doc_ids: torch.Tensor  # i32[S, N] shard-local ids
    cluster_offsets: torch.Tensor  # i32[S, C + 1]
    cluster_sizes: torch.Tensor  # i32[S, C]
    bucket_weights: torch.Tensor  # f32[S, 2^b]
    doc_start: torch.Tensor  # i32[S] global id of each shard's first doc

    dim: int = 128
    nbits: int = 4
    cap: int = 0
    n_docs: int = 0
    n_tokens_padded: int = 0
    n_tokens_total: int = 0
    local_docs: int = 0

    @property
    def n_shards(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.packed_codes.device

    def resolved_n_tokens(self) -> int:
        """The true corpus token count (the padded estimate for stacks
        without one)."""
        return self.n_tokens_total or self.n_tokens_padded * self.n_shards

    @functools.cached_property
    def shards(self) -> tuple[WarpIndex, ...]:
        """Each shard as a plain ``WarpIndex`` of views into the stack
        (``local_index``), made once."""
        cutoffs = torch.zeros((1 << self.nbits) - 1, dtype=torch.float32, device=self.device)
        return tuple(
            WarpIndex(
                centroids=self.centroids[s],
                packed_codes=self.packed_codes[s],
                token_doc_ids=self.token_doc_ids[s],
                cluster_offsets=self.cluster_offsets[s],
                cluster_sizes=self.cluster_sizes[s],
                bucket_weights=self.bucket_weights[s],
                bucket_cutoffs=cutoffs,
                dim=self.dim,
                nbits=self.nbits,
                cap=self.cap,
                n_docs=self.local_docs + 1,
                n_tokens=self.n_tokens_padded,
            )
            for s in range(self.n_shards)
        )

    def nbytes(self) -> int:
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size() for f in SHARDED_ARRAYS
        )

    def to(self, device) -> "ShardedWarpIndex":
        device = torch.device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in SHARDED_ARRAYS}
        )

    @classmethod
    def from_arrays(cls, src: Any, *, device) -> "ShardedWarpIndex":
        """From any object or dict with the stacked array fields
        (numpy-convertible: memmaps, a JAX ``ShardedWarpIndex``'s arrays)
        and the static fields; values are kept exactly."""
        get = src.get if isinstance(src, dict) else lambda k: getattr(src, k)
        device = torch.device(device)
        arrays = {}
        for f in SHARDED_ARRAYS:
            a = np.asarray(get(f))
            if not a.flags.writeable:
                a = a.copy()
            arrays[f] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=_DTYPES[f]
            )
        return cls(**arrays, **{k: int(get(k)) for k in SHARDED_STATIC})


def is_sharded_like(src) -> bool:
    """Whether ``src`` (an index object or a dict of arrays) is a sharded
    stack: it carries ``doc_start``."""
    if isinstance(src, dict):
        return "doc_start" in src
    return hasattr(src, "doc_start")


def local_index(sidx: ShardedWarpIndex, s: int) -> WarpIndex:
    """Shard ``s`` as a plain ``WarpIndex`` of views into the stack, so the
    engine's stages apply: shard-local doc ids bounded by ``local_docs +
    1`` (the padding id included), the padded token count, zero cutoffs
    (the stack keeps no encoder tables)."""
    return sidx.shards[s]


# ---------------------------------------------------------------------------
# building and stacking
# ---------------------------------------------------------------------------


def shard_doc_bounds(token_doc_ids, n_docs: int, n_shards: int) -> np.ndarray:
    """i64[S + 1] contiguous doc ranges holding about equal token counts:
    the cuts are ``searchsorted`` of the token cumsum at ``linspace`` targets,
    then made strictly increasing and clamped to ``n_docs`` (JAX's rule)."""
    tdi = np.asarray(token_doc_ids).reshape(-1)
    n_tokens = tdi.shape[0]
    csum = np.concatenate([[0], np.cumsum(np.bincount(tdi, minlength=n_docs))])
    targets = np.linspace(0, n_tokens, n_shards + 1)
    cuts = np.searchsorted(csum, targets[1:-1], side="left")
    bounds = np.concatenate([[0], cuts, [n_docs]]).astype(np.int64)
    for s in range(1, n_shards + 1):
        bounds[s] = max(bounds[s], bounds[s - 1] + 1)
    bounds = np.minimum(bounds, n_docs)
    bounds[-1] = n_docs
    return bounds


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_sharded_index(
    embeddings,
    token_doc_ids,
    n_docs: int,
    n_shards: int,
    config: IndexBuildConfig = IndexBuildConfig(),
    *,
    device=None,
) -> ShardedWarpIndex:
    """Cut the corpus into ``shard_doc_bounds`` ranges, build each shard
    with ``build_index`` (seed ``config.seed + s``, its own centroids and
    codec) on ``device`` (None -> the card), pad and stack."""
    device = resolve_device(device)
    emb = np.asarray(_host(embeddings), np.float32)
    tdi = np.asarray(_host(token_doc_ids), np.int32)
    bounds = shard_doc_bounds(tdi, n_docs, n_shards)
    shards = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        sel = (tdi >= lo) & (tdi < hi)
        sub_cfg = dataclasses.replace(config, seed=config.seed + s)
        shards.append(build_index(emb[sel], tdi[sel] - lo, max(1, hi - lo), sub_cfg, device=device))
    return stack_shards(shards, bounds[:-1], n_docs, emb.shape[0])


def _pad_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    pad = rows - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad, *t.shape[1:]), fill)])


def stack_shards(shards, doc_start, n_docs: int, n_tokens_total: int) -> ShardedWarpIndex:
    """Pad per-shard ``WarpIndex``es (one device) to a common geometry and
    stack them; ``doc_start[s]`` is shard ``s``'s first global doc id."""
    c_max = max(s.n_centroids for s in shards)
    n_max = max(s.n_tokens for s in shards)
    local_docs = max(s.n_docs for s in shards)
    dev = shards[0].device
    return ShardedWarpIndex(
        centroids=torch.stack([_pad_rows(s.centroids, c_max, 0.0) for s in shards]),
        packed_codes=torch.stack([_pad_rows(s.packed_codes, n_max, 0) for s in shards]),
        token_doc_ids=torch.stack([_pad_rows(s.token_doc_ids, n_max, local_docs) for s in shards]),
        cluster_offsets=torch.stack(
            [_pad_rows(s.cluster_offsets, c_max + 1, s.n_tokens) for s in shards]
        ),
        cluster_sizes=torch.stack([_pad_rows(s.cluster_sizes, c_max, 0) for s in shards]),
        bucket_weights=torch.stack([s.bucket_weights for s in shards]),
        doc_start=torch.as_tensor(
            np.asarray(_host(doc_start))[: len(shards)], dtype=torch.int32
        ).to(dev),
        dim=shards[0].dim,
        nbits=shards[0].nbits,
        cap=max(s.cap for s in shards),
        n_docs=int(n_docs),
        n_tokens_padded=int(n_max),
        n_tokens_total=int(n_tokens_total),
        local_docs=int(local_docs),
    )


def shard_index(index: WarpIndex, n_shards: int) -> ShardedWarpIndex:
    """Cut a built index into ``shard_doc_bounds`` document ranges that
    keep its centroids and codec (shared by every shard): each shard's CSR
    holds its documents' rows in the index's order. With shared centroids
    the sharded search returns what the single index's does (same probes,
    the same merged m_i, a document's tokens in one shard)."""
    tdi = index.token_doc_ids
    dev = index.device
    bounds = shard_doc_bounds(tdi.cpu().numpy(), index.n_docs, n_shards)
    owner = torch.bucketize(tdi.long(), torch.from_numpy(bounds[1:-1]).to(dev), right=True)
    cluster_of = torch.repeat_interleave(
        torch.arange(index.n_centroids, device=dev), index.cluster_sizes.long()
    )
    shards = []
    for s in range(n_shards):
        rows = torch.nonzero(owner == s).squeeze(1)
        sizes = torch.bincount(cluster_of[rows], minlength=index.n_centroids)
        offsets = torch.zeros(index.n_centroids + 1, dtype=torch.long, device=dev)
        offsets[1:] = torch.cumsum(sizes, 0)
        shards.append(dataclasses.replace(
            index,
            packed_codes=index.packed_codes[rows],
            token_doc_ids=(tdi[rows] - int(bounds[s])).to(torch.int32),
            cluster_offsets=offsets.to(torch.int32),
            cluster_sizes=sizes.to(torch.int32),
            cap=int(sizes.max()) if sizes.numel() else 0,
            n_docs=max(1, int(bounds[s + 1] - bounds[s])),
            n_tokens=int(rows.numel()),
        ))
    return stack_shards(shards, bounds[:-1], index.n_docs, index.n_tokens)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def resolve_sharded_config(sidx: ShardedWarpIndex, config: WarpSearchConfig) -> WarpSearchConfig:
    """``engine.resolve_config`` for a stack: t' from the true token count,
    k_impute from the per-shard (padded) centroid count, the executor
    against the stack's device, and the ragged bound from the worst shard
    (every shard runs at one bound, as JAX's one program does)."""
    n_tokens = sidx.resolved_n_tokens()
    if n_tokens == 0:
        raise ValueError(
            "sharded index has n_tokens == 0 — nothing to retrieve. Build "
            "or load a non-empty index before planning a search."
        )
    on_cuda = sidx.device.type == "cuda"
    executor = config.resolved_executor(on_cuda)
    if executor == "kernel" and not on_cuda:
        raise ValueError(
            f"executor='kernel' runs the CUDA kernels, but the index is on "
            f"{sidx.device}; load it with device='cuda', or plan "
            "executor='reference' (or 'auto') on the CPU"
        )
    config = dataclasses.replace(
        config,
        t_prime=config.resolved_t_prime(n_tokens),
        k_impute=config.resolved_k_impute(sidx.n_centroids),
        executor=executor,
    )
    return engine.resolve_layout_fields(
        config, sidx.cluster_sizes.cpu().numpy(), sidx.cap,
        n_tokens=n_tokens, nbits=sidx.nbits, dim=sidx.dim, device=sidx.device,
    )


def select_sharded(sidx: ShardedWarpIndex, q, qmask, config) -> list[WarpSelectOut]:
    """Stage 1 on every shard: WARP_SELECT of [B, Q, D] queries against
    each shard's centroids and cluster sizes."""
    return [engine.select_probes(shard, q, qmask, config) for shard in sidx.shards]


def sharded_probe_sizes(sidx: ShardedWarpIndex, q, qmask, config):
    """(probe_sizes, probe_cids), each i64[S, B, Q, nprobe]: the per-shard
    WARP_SELECT probes the adaptive dispatcher reads its one bucket from."""
    sels = select_sharded(sidx, q, qmask, config)
    return (
        torch.stack([s.probe_sizes for s in sels]),
        torch.stack([s.probe_cids for s in sels]),
    )


def finish_sharded(
    sidx: ShardedWarpIndex, q, qmask, sels: list[WarpSelectOut], config, fv=None
) -> TopKResult:
    """Stages 2+3 per shard from ``select_sharded``'s output, then the
    merge. The shards' top-kk (score, size) pairs, concatenated shard-major
    (JAX's all_gather order), give one global m_i; each shard scores and
    reduces with it; local ids become global (``+ doc_start``, -1 stays);
    the top-k over the shard-major ``[S * k]`` concatenation breaks ties
    toward the earlier shard, as ``lax.top_k`` does. ``fv`` is a stacked
    ``FilterView`` (``docfilter.resolve_sharded``)."""
    mse = impute_mse(
        torch.cat([s.top_scores for s in sels], dim=-1),
        torch.cat([s.top_sizes for s in sels], dim=-1),
        config.t_prime, qmask,
    )
    scores, docs = [], []
    starts = sidx.doc_start.tolist()
    for s, (shard, sel) in enumerate(zip(sidx.shards, sels)):
        shard_fv = None if fv is None else FilterView(fv.doc_mask[s], fv.cluster_live[s])
        top = engine.score_and_reduce(
            shard, q, qmask, sel.probe_scores, sel.probe_cids, mse, config,
            probe_sizes=sel.probe_sizes, dfilter=shard_fv,
        )
        scores.append(top.scores)
        docs.append(torch.where(top.doc_ids >= 0, top.doc_ids + starts[s], -1))
    top_scores, idx = topk_lower_index_first(torch.cat(scores, dim=-1), config.k)
    return TopKResult(top_scores, torch.gather(torch.cat(docs, dim=-1), -1, idx).to(torch.int32))


def sharded_search(
    sidx: ShardedWarpIndex, q, qmask=None, config: WarpSearchConfig = WarpSearchConfig(),
    *, dfilter=None,
) -> TopKResult:
    """One-shot sharded search of one query q f32[Q, D] at the static
    worklist bound; ``dfilter`` is a ``DocFilter`` over global ids or a
    stacked ``FilterView``. Equivalent to ``Retriever.from_index(sidx)``
    with a non-adaptive plan."""
    from repro_torch.core.docfilter import DocFilter, resolve_sharded

    config = resolve_sharded_config(sidx, config)
    q = torch.as_tensor(q, dtype=torch.float32, device=sidx.device)
    if qmask is None:
        qmask = torch.ones(q.shape[:1], dtype=torch.bool, device=sidx.device)
    qmask = torch.as_tensor(qmask, dtype=torch.bool, device=sidx.device)
    fv = dfilter
    if isinstance(dfilter, DocFilter):
        if dfilter.n_docs != sidx.n_docs:
            raise ValueError(
                f"DocFilter covers {dfilter.n_docs} docs but the sharded index holds {sidx.n_docs}"
            )
        fv = resolve_sharded(dfilter, sidx)
    sels = select_sharded(sidx, q[None], qmask[None], config)
    res = finish_sharded(sidx, q[None], qmask[None], sels, config, fv)
    return TopKResult(res.scores[0], res.doc_ids[0])
