"""End-to-end WARP retrieval (paper §4.2). Counterpart of
``repro/core/engine.py``.

Pipeline: WARP_SELECT -> implicit decompression + scoring of the probed
clusters (the CUDA kernels, or their plain versions) -> two-stage
reduction -> top-k. Shapes follow the JAX engine: ``layout="dense"``
scores a ``[Q, nprobe, cap]`` grid masked by the true cluster sizes;
``layout="ragged"`` flattens the probes into a tile worklist
(``core.worklist``) so scoring and the reduction's sort scale with the
real candidates.

The stage functions carry an explicit leading batch dimension where the
JAX engine ``vmap``s: ``q`` is ``[B, Q, D]``, ``qmask`` ``[B, Q]``, the
probe arrays ``[B, Q, P]``. The batch shares each kernel launch (its query
tokens are stacked to ``B * Q`` v-tables); every batch element still gets
its own worklist and its own reduction. ``memory="scan_qtokens"`` (a
``lax.scan`` over query tokens in JAX) is a Python loop over tokens.

A resolved doc filter (``core.docfilter.FilterView``, argument
``dfilter``) is pushed down twice: probed clusters without a surviving
token count size 0 (no worklist tiles; no valid slots in the dense grid),
and the reduction masks filtered documents to -inf.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.docfilter import FilterView
from repro_torch.core.reduction import TopKResult, two_stage_reduce
from repro_torch.core.types import WarpIndex, WarpSearchConfig
from repro_torch.core.warpselect import WarpSelectOut, warp_select
from repro_torch.core.worklist import (
    bucket_ladder,
    build_tile_worklist,
    filtered_probe_sizes,
    per_slot,
    worklist_bound,
    worklist_slot_positions,
)
from repro_torch.kernels import ops

__all__ = [
    "search",
    "search_batch",
    "resolve_config",
    "resolve_layout_fields",
    "resolve_tile_fields",
    "score_probed_clusters",
    "ragged_flat_candidates",
    "score_candidates",
    "reduce_candidates",
    "score_and_reduce",
    "select_probes",
    "finish_from_probes",
    "score_from_probes",
    "reduce_from_scored",
    "gather_candidates",
    "index_geometry",
    "kernel_dma_compute_split",
]


def resolve_tile_fields(
    config: WarpSearchConfig,
    *,
    cap: int,
    layout: str,
    n_tokens: int | None = None,
    nbits: int | None = None,
    dim: int | None = None,
    device=None,
) -> WarpSearchConfig:
    """Write the concrete ``tile_c`` (with ``tile_source``) and the
    recorded ``buffering`` into the config; a no-op once resolved. With
    the full geometry (``n_tokens``, ``nbits``, ``dim``) the autotune
    table is consulted for entries measured on the kind of ``device``."""
    if config.tile_source is not None and config.tile_c is not None:
        return config
    choice = ops.resolve_tile_choice(
        cap, config.tile_c, layout=layout, n_tokens=n_tokens, nbits=nbits, dim=dim,
        buffering=config.buffering, device=device,
    )
    return dataclasses.replace(
        config, tile_c=choice.tile_c, tile_source=choice.source,
        buffering=choice.buffering,
    )


def resolve_layout_fields(
    config: WarpSearchConfig, cluster_sizes, cap: int, *, n_tokens: int | None = None,
    nbits: int | None = None, dim: int | None = None, device=None,
) -> WarpSearchConfig:
    """Concretize ``layout="auto"``, the tile, the ragged worklist bound
    and the adaptive bucket ladder. ``cluster_sizes`` is host data, ``[C]``
    or a sharded ``[S, C]`` stack (the bound then covers the worst
    shard). The geometry keywords enable the autotune lookup, as in
    ``resolve_tile_fields``; a tuned ragged tile moves "auto" as the
    heuristic's does."""
    geo = dict(n_tokens=n_tokens, nbits=nbits, dim=dim, device=device)
    if config.layout == "dense":
        config = resolve_tile_fields(config, cap=cap, layout="dense", **geo)
        return dataclasses.replace(config, worklist_tiles=None, worklist_buckets=None)
    ragged = resolve_tile_fields(config, cap=cap, layout="ragged", **geo)
    tile = ragged.tile_c
    bound = worklist_bound(cluster_sizes, config.nprobe, tile)
    layout = config.layout
    if layout == "auto":
        layout = "ragged" if bound * tile < config.nprobe * cap else "dense"
    if layout == "dense":
        config = resolve_tile_fields(config, cap=cap, layout="dense", **geo)
        return dataclasses.replace(
            config, layout="dense", worklist_tiles=None, worklist_buckets=None
        )
    return dataclasses.replace(
        ragged, layout="ragged", worklist_tiles=bound,
        worklist_buckets=bucket_ladder(bound),
    )


def index_geometry(index) -> dict:
    """The keywords of the autotune lookup for an index (a ``WarpIndex``
    or a segmented one): its token count, code width, dim and device."""
    return dict(n_tokens=index.n_tokens, nbits=index.nbits, dim=index.dim, device=index.device)


def resolve_config(index: WarpIndex, config: WarpSearchConfig) -> WarpSearchConfig:
    """Materialize data-dependent defaults: t', k_impute, the executor
    (kernels on CUDA, plain versions on CPU), layout, tile and worklist
    bounds. ``executor="kernel"`` on a CPU index raises: the kernels run
    only on the card."""
    if index.n_tokens == 0:
        raise ValueError(
            "index has n_tokens == 0 — nothing to retrieve. Build or load "
            "a non-empty index before planning a search."
        )
    on_cuda = index.device.type == "cuda"
    executor = config.resolved_executor(on_cuda)
    if executor == "kernel" and not on_cuda:
        raise ValueError(
            f"executor='kernel' runs the CUDA kernels, but the index is on "
            f"{index.device}; load it with device='cuda', or plan "
            "executor='reference' (or 'auto') on the CPU"
        )
    config = dataclasses.replace(
        config,
        t_prime=config.resolved_t_prime(index.n_tokens),
        k_impute=config.resolved_k_impute(index.n_centroids),
        executor=executor,
    )
    geo = index_geometry(index)
    if (
        config.layout == "dense"
        and config.worklist_tiles is None
        and config.worklist_buckets is None
    ):
        return resolve_tile_fields(config, cap=index.cap, layout="dense", **geo)
    return resolve_layout_fields(
        config, index.cluster_sizes.cpu().numpy(), index.cap, **geo
    )


def _vtable(index: WarpIndex, q: torch.Tensor) -> torch.Tensor:
    """v[..., q, d, c] = q_d * bucket_weight[c] — f32[..., Q, D, 2^b]."""
    return q.unsqueeze(-1) * index.bucket_weights


def _live_cluster_sizes(index: WarpIndex, dfilter: FilterView | None) -> torch.Tensor:
    """Cluster sizes with the filter's dead clusters at 0 (the pushdown)."""
    if dfilter is None:
        return index.cluster_sizes
    return torch.where(dfilter.cluster_live, index.cluster_sizes, 0)


def _csr_positions(index: WarpIndex, probe_cids: torch.Tensor, cluster_sizes=None):
    """probe_cids [..., P] -> (pos [..., P, cap] clamped into
    [0, n_tokens), valid bool[..., P, cap]); valid slots by
    ``cluster_sizes`` (default the index's)."""
    if cluster_sizes is None:
        cluster_sizes = index.cluster_sizes
    lane = torch.arange(index.cap, device=probe_cids.device)
    starts = index.cluster_offsets.long()[probe_cids]
    sizes = cluster_sizes.long()[probe_cids]
    pos = starts.unsqueeze(-1) + lane
    valid = lane < sizes.unsqueeze(-1)
    return pos.clamp(0, max(0, index.n_tokens - 1)), valid


def gather_candidates(index: WarpIndex, probe_cids: torch.Tensor):
    """CSR gather at static capacity: probe_cids [..., P] -> (packed
    u8[..., P, cap, PB], doc_ids i32[..., P, cap], valid bool[..., P, cap])."""
    pos, valid = _csr_positions(index, probe_cids)
    return index.packed_codes[pos], index.token_doc_ids[pos], valid


def _score_block(index, q, probe_scores, probe_cids, config, sizes_c):
    """Dense scoring of one block of query tokens: q [B, n, D] ->
    (cand [B, n, P, cap], doc_ids, valid); ``sizes_c`` are the cluster
    sizes that bound the valid slots."""
    b, n, _ = q.shape
    p, cap, nb = probe_cids.shape[-1], index.cap, index.n_buckets
    v = _vtable(index, q).reshape(b * n, index.dim, nb)
    pos, valid = _csr_positions(index, probe_cids, sizes_c)
    doc_ids = index.token_doc_ids[pos]
    if config.gather == "fused":
        cand = ops.fused_gather_selective_sum(
            index.packed_codes, index.cluster_offsets, sizes_c,
            probe_cids.reshape(b * n, p), probe_scores.reshape(b * n, p), v,
            nbits=index.nbits, dim=index.dim, cap=cap,
            use_kernel=config.wants_kernel,
        )
        return cand.reshape(b, n, p, cap), doc_ids, valid
    packed = index.packed_codes[pos]  # [B, n, P, cap, PB] gathered copy
    res = ops.selective_sum(
        packed.reshape(b * n, p * cap, -1), v,
        nbits=index.nbits, dim=index.dim,
        use_kernel=config.wants_kernel, impl=config.sum_impl,
    ).reshape(b, n, p, cap)
    return res + probe_scores.unsqueeze(-1), doc_ids, valid


def score_probed_clusters(index, q, probe_scores, probe_cids, config, dfilter=None):
    """Implicit decompression over the probed clusters (layout="dense"):
    -> (cand_scores f32[B, Q, P, cap], doc_ids [B, Q, P, cap],
    valid bool[B, Q, P, cap]). ``memory="scan_qtokens"`` scores one query
    token at a time, bounding the live working set by a factor of Q.
    Clusters ``dfilter`` finds dead have no valid slot."""
    sizes_c = _live_cluster_sizes(index, dfilter)
    if config.memory == "scan_qtokens":
        parts = [
            _score_block(
                index, q[:, i : i + 1], probe_scores[:, i : i + 1],
                probe_cids[:, i : i + 1], config, sizes_c,
            )
            for i in range(q.shape[1])
        ]
        return tuple(torch.cat(x, dim=1) for x in zip(*parts))
    return _score_block(index, q, probe_scores, probe_cids, config, sizes_c)


def _ragged_block(index, q, starts, sizes, pscores, config, tile, bound):
    """One worklist per batch element over a block of n query tokens:
    q [B, n, D], probe arrays [B, n, P] -> flat (scores, doc_ids, qtok,
    valid), each [B, n * bound * tile]."""
    b, n, _ = q.shape
    nb = index.n_buckets
    wl = build_tile_worklist(
        starts, sizes, pscores, tile_c=tile, tiles_per_qtoken=bound
    )  # each [B, W]
    w = wl.row0.shape[-1]
    pos, slot_valid = worklist_slot_positions(wl, tile_c=tile, n_tokens=index.n_tokens)
    qtok_slot = per_slot(wl.qtok.long(), tile)
    v = _vtable(index, q).reshape(b * n, index.dim, nb)
    # The batch's worklists run as one: element i's tokens are v rows
    # i*n .. i*n + n - 1.
    qtok_all = (wl.qtok + (torch.arange(b, device=q.device) * n).unsqueeze(-1).int())
    kw = dict(nbits=index.nbits, dim=index.dim, tile_c=tile)
    if config.gather == "fused":
        scores = ops.ragged_fused_gather_selective_sum(
            index.packed_codes, wl.row0.reshape(-1), wl.nvalid.reshape(-1),
            qtok_all.reshape(-1), wl.pscore.reshape(-1), v,
            use_kernel=config.wants_kernel, **kw,
        )
    elif config.wants_kernel:
        # Materialize: gather the worklist's rows, then score the gathered
        # copy with the worklist kernel (tile w's rows start at w * tile).
        packed = index.packed_codes[pos.reshape(-1)]
        row0 = torch.arange(b * w, device=q.device, dtype=torch.int32) * tile
        scores = ops.ragged_fused_gather_selective_sum(
            packed, row0, wl.nvalid.reshape(-1), qtok_all.reshape(-1),
            wl.pscore.reshape(-1), v, use_kernel=True, **kw,
        )
    else:
        packed = index.packed_codes[pos.reshape(-1)]
        res = ops.ragged_selective_sum(
            packed, per_slot(qtok_all.long(), tile).reshape(-1), v,
            nbits=index.nbits, dim=index.dim, impl=config.sum_impl,
        )
        pscore_slot = per_slot(wl.pscore, tile).reshape(-1)
        scores = torch.where(slot_valid.reshape(-1), res + pscore_slot, 0.0)
    return (
        scores.reshape(b, -1), index.token_doc_ids[pos], qtok_slot, slot_valid
    )


def ragged_flat_candidates(index, q, probe_scores, probe_cids, config, probe_sizes=None):
    """Flat worklist-ordered candidates (layout="ragged"): -> (scores,
    doc_ids, qtok, valid), each [B, Q * worklist_tiles * tile_c]."""
    tile = ops.resolve_tile_c(index.cap, config.tile_c, layout="ragged")
    bound = config.worklist_tiles
    if bound is None:
        raise ValueError(
            "layout='ragged' needs a resolved worklist bound "
            "(worklist_tiles); run the config through engine.resolve_config "
            "or Retriever.plan first"
        )
    starts = index.cluster_offsets.long()[probe_cids]
    sizes = (
        probe_sizes if probe_sizes is not None else index.cluster_sizes[probe_cids]
    ).long()
    if config.memory == "scan_qtokens":
        b, qm, _ = q.shape
        parts = [
            _ragged_block(
                index, q[:, i : i + 1], starts[:, i : i + 1], sizes[:, i : i + 1],
                probe_scores[:, i : i + 1], config, tile, bound,
            )
            for i in range(qm)
        ]
        s, d, _, val = (torch.cat(x, dim=1) for x in zip(*parts))
        qtok = per_slot(torch.arange(qm, device=q.device), bound * tile)
        return s, d, qtok.expand(b, -1), val
    return _ragged_block(index, q, starts, sizes, probe_scores, config, tile, bound)


def score_candidates(
    index, q, qmask, probe_scores, probe_cids, config, *, probe_sizes=None, dfilter=None
):
    """Stage 2: the flat candidate stream ``(doc_ids, qtok, scores,
    valid)``, each [B, N]. Candidates of masked query tokens are invalid;
    on the ragged layout their probe sizes are zeroed first so they build
    no worklist tiles, as are those of clusters ``dfilter`` finds dead."""
    b, qm = qmask.shape
    if config.layout == "ragged":
        if probe_sizes is None:
            probe_sizes = index.cluster_sizes[probe_cids]
        probe_sizes = torch.where(qmask.unsqueeze(-1), probe_sizes.long(), 0)
        if dfilter is not None:
            probe_sizes = filtered_probe_sizes(probe_sizes, probe_cids, dfilter.cluster_live)
        scores, doc_ids, qtok, valid = ragged_flat_candidates(
            index, q, probe_scores, probe_cids, config, probe_sizes
        )
        return doc_ids, qtok, scores, valid & torch.gather(qmask, 1, qtok)
    cand, doc_ids, valid = score_probed_clusters(
        index, q, probe_scores, probe_cids, config, dfilter
    )
    valid = valid & qmask[:, :, None, None]
    qtok = torch.arange(qm, device=q.device)[None, :, None, None].expand_as(valid)
    return (
        doc_ids.reshape(b, -1), qtok.reshape(b, -1),
        cand.reshape(b, -1), valid.reshape(b, -1),
    )


def reduce_candidates(
    index, doc_ids, qtok, scores, valid, mse, config, *, q_max, dfilter=None
):
    """Stage 3: the two-stage reduction to top-k (ragged streams pad to
    k when the worklist bound is shorter); ``dfilter``'s doc mask (this
    index's doc ids) masks filtered documents."""
    return two_stage_reduce(
        doc_ids, qtok, scores, valid, mse,
        dfilter.doc_mask if dfilter is not None else None,
        q_max=q_max, k=config.k, impl=config.reduce_impl,
        pad_to_k=config.layout == "ragged",
    )


def score_and_reduce(
    index, q, qmask, probe_scores, probe_cids, mse, config, *, probe_sizes=None,
    dfilter=None,
) -> TopKResult:
    doc_ids, qtok, scores, valid = score_candidates(
        index, q, qmask, probe_scores, probe_cids, config,
        probe_sizes=probe_sizes, dfilter=dfilter,
    )
    return reduce_candidates(
        index, doc_ids, qtok, scores, valid, mse, config, q_max=q.shape[1],
        dfilter=dfilter,
    )


def select_probes(index, q, qmask, config) -> WarpSelectOut:
    """Stage 1 (WARP_SELECT) over [B, Q, D] queries."""
    return warp_select(
        q, index.centroids, index.cluster_sizes,
        nprobe=config.nprobe, t_prime=config.t_prime,
        k_impute=config.k_impute, qmask=qmask,
    )


def score_from_probes(index, q, qmask, sel: WarpSelectOut, config, dfilter=None):
    """Stage 2 from a WARP_SELECT output: the flat candidate stream
    ``(doc_ids, qtok, scores, valid)``, each [B, N]."""
    return score_candidates(
        index, q, qmask, sel.probe_scores, sel.probe_cids, config,
        probe_sizes=sel.probe_sizes, dfilter=dfilter,
    )


def reduce_from_scored(index, scored, mse, config, dfilter=None) -> TopKResult:
    """Stage 3 from ``score_from_probes`` output; ``mse`` f32[B, Q] (its
    trailing axis is the padded query length the reduction scatters
    over)."""
    doc_ids, qtok, scores, valid = scored
    return reduce_candidates(
        index, doc_ids, qtok, scores, valid, mse, config, q_max=mse.shape[-1],
        dfilter=dfilter,
    )


def finish_from_probes(
    index, q, qmask, sel: WarpSelectOut, config, dfilter=None
) -> TopKResult:
    """Stages 2+3 from a WARP_SELECT output; ``select_probes`` ->
    ``finish_from_probes`` is the whole pipeline, and it is exactly
    ``reduce_from_scored`` of ``score_from_probes`` (the traced path runs
    the two with a fence between them)."""
    scored = score_from_probes(index, q, qmask, sel, config, dfilter)
    return reduce_from_scored(index, scored, sel.mse, config, dfilter)


def _run(index, q, qmask, config) -> TopKResult:
    sel = select_probes(index, q, qmask, config)
    return finish_from_probes(index, q, qmask, sel, config)


def search(
    index: WarpIndex, q, qmask=None, config: WarpSearchConfig = WarpSearchConfig()
) -> TopKResult:
    """Single query q f32[Q, D] at the static worklist bound (no adaptive
    rung); equivalent to ``Retriever`` with a non-adaptive plan."""
    config = resolve_config(index, config)
    q = torch.as_tensor(q, dtype=torch.float32, device=index.device)
    if qmask is None:
        qmask = torch.ones(q.shape[:1], dtype=torch.bool, device=index.device)
    qmask = torch.as_tensor(qmask, dtype=torch.bool, device=index.device)
    res = _run(index, q[None], qmask[None], config)
    return TopKResult(res.scores[0], res.doc_ids[0])


def search_batch(
    index: WarpIndex, q, qmask=None, config: WarpSearchConfig = WarpSearchConfig()
) -> TopKResult:
    """Batched queries q f32[B, Q, D] -> TopKResult with leading batch dim."""
    config = resolve_config(index, config)
    q = torch.as_tensor(q, dtype=torch.float32, device=index.device)
    if qmask is None:
        qmask = torch.ones(q.shape[:2], dtype=torch.bool, device=index.device)
    qmask = torch.as_tensor(qmask, dtype=torch.bool, device=index.device)
    return _run(index, q, qmask, config)


def kernel_dma_compute_split(
    index: WarpIndex, q, qmask, sel: WarpSelectOut, config: WarpSearchConfig, *,
    warmup: int = 1, iters: int = 2,
) -> dict:
    """The staging/scoring split of the fused scoring kernel at this
    query's probe set (the JAX package's DMA/compute split): the ops entry
    point of the config's layout timed at its carve-outs ``probe="full"``,
    ``"dma"`` (rows staged, not scored) and ``"compute"`` (rows scored,
    not staged; under a "single" schedule derived as full - dma, as in
    JAX), CUDA events after ``warmup`` runs, median of ``iters``, L2 warm
    (``autotune_sweep.event_ms``) -> ``{"kernel_full_ms", "dma_ms",
    "compute_ms", "overlap_frac", "probe_tile_c", "probe_buffering"}``.

    Returns ``{}`` where the CUDA kernel is not on this config's path:
    materialize gather, the reference executor, an index on the CPU, a
    ragged config without a worklist bound, or an empty worklist. Unlike
    the JAX package it measures at nbits 8 and on an index smaller than
    one tile, which the CUDA kernels take. Batched inputs ([B, Q, ...])
    are probed at batch element 0, with the filter-free probe sizes. Each
    call launches the kernel 3 x (warmup + iters) times, each counted
    under its probe (``_build.LAUNCHES``): armed by
    ``obs.set_kernel_probes``."""
    from repro_torch.kernels.autotune import overlap_frac
    from repro_torch.kernels.autotune_sweep import event_ms

    if config.gather != "fused" or not config.wants_kernel or index.device.type != "cuda":
        return {}
    if q.dim() == 3:
        q, qmask = q[0], qmask[0]
        sel = WarpSelectOut(*(a[0] for a in sel))
    ragged = config.layout == "ragged"
    tile = ops.resolve_tile_c(index.cap, config.tile_c, layout="ragged" if ragged else "dense")
    buffering = config.buffering if config.buffering in ("single", "double") else ops.DEFAULT_BUFFERING
    v = _vtable(index, q).contiguous()
    kw = dict(nbits=index.nbits, dim=index.dim, use_kernel=True, buffering=buffering)
    if ragged:
        if config.worklist_tiles is None:
            return {}
        starts = index.cluster_offsets[sel.probe_cids].to(torch.int32)
        sizes = torch.where(qmask.unsqueeze(-1), sel.probe_sizes, 0).to(torch.int32)
        work = build_tile_worklist(
            starts, sizes, sel.probe_scores, tile_c=tile, tiles_per_qtoken=config.worklist_tiles
        )
        if work.row0.shape[0] == 0:
            return {}

        def make(probe):
            return lambda: ops.ragged_fused_gather_selective_sum(
                index.packed_codes, *work, v, tile_c=tile, probe=probe, **kw
            )
    else:

        def make(probe):
            return lambda: ops.fused_gather_selective_sum(
                index.packed_codes, index.cluster_offsets, index.cluster_sizes,
                sel.probe_cids, sel.probe_scores, v, cap=index.cap, probe=probe, **kw
            )

    t_full, t_dma = (event_ms(make(p), warmup=warmup, iters=iters) for p in ("full", "dma"))
    if buffering == "double":
        t_comp = event_ms(make("compute"), warmup=warmup, iters=iters)
    else:
        t_comp = max(t_full - t_dma, 0.0)
    return {
        "kernel_full_ms": round(t_full, 4),
        "dma_ms": round(t_dma, 4),
        "compute_ms": round(t_comp, 4),
        "overlap_frac": round(overlap_frac(t_full, t_dma, t_comp), 4),
        "probe_tile_c": tile,
        "probe_buffering": buffering,
    }
