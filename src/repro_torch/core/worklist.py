"""Ragged tile worklists: compute proportional to real candidates.
Counterpart of ``repro/core/worklist.py`` (see its docstring for the entry
layout, the static bound and the bucket ladder).

Each probed cluster run of ``size`` rows contributes ``ceil(size /
tile_c)`` consecutive ``tile_c``-row tiles, query-token-major; entries past
the true total are padding tiles with ``nvalid == 0`` (``row0``, ``qtok``
and ``pscore`` are 0 there). The host-side bound/ladder helpers are numpy;
the worklist itself is built on the index's device. ``build_tile_worklist``
takes leading batch dimensions: each batch element gets its own worklist,
as the JAX package gets from ``vmap``. With ``seg`` it spans the segments
of a segmented index (``SegmentedTileWorklist``: each tile carries its
segment id beside its segment-local ``row0``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "TileWorklist",
    "SegmentedTileWorklist",
    "build_tile_worklist",
    "worklist_bound",
    "worklist_bound_segmented",
    "filtered_probe_sizes",
    "worklist_slot_positions",
    "bucket_ladder",
    "probe_tile_counts",
    "needed_worklist_tiles",
    "pick_bucket",
    "per_slot",
]

DEFAULT_BUCKET_RUNGS = 4


class TileWorklist(NamedTuple):
    row0: torch.Tensor  # i32[..., W] code row of the tile's slot 0
    nvalid: torch.Tensor  # i32[..., W] valid slots (0 => padding tile)
    qtok: torch.Tensor  # i32[..., W] owning query token (0 on padding)
    pscore: torch.Tensor  # f32[..., W] centroid probe score of the cluster


class SegmentedTileWorklist(NamedTuple):
    """A worklist over base + delta segments, its fields in the order the
    segmented scoring kernel takes them."""

    row0: torch.Tensor  # i32[..., W] segment-local code row of slot 0
    nvalid: torch.Tensor  # i32[..., W]
    seg: torch.Tensor  # i32[..., W] owning segment (0 on padding)
    qtok: torch.Tensor  # i32[..., W]
    pscore: torch.Tensor  # f32[..., W]


def worklist_bound(cluster_sizes, nprobe: int, tile_c: int) -> int:
    """Static per-query-token tile bound: the sum of the ``nprobe``
    largest clusters' tile counts (at least 1). ``[S, C]`` sizes of a
    sharded stack give the largest shard's bound (each shard runs its own
    worklist at the one bound)."""
    sizes = np.asarray(cluster_sizes)
    if sizes.ndim == 2:
        return max(worklist_bound(s, nprobe, tile_c) for s in sizes)
    tiles = -np.sort(-((sizes.astype(np.int64) + tile_c - 1) // tile_c))
    return max(1, int(tiles[:nprobe].sum()))


def worklist_bound_segmented(per_segment_sizes, nprobe: int, tile_c: int) -> int:
    """Static per-query-token tile bound of a segmented index from its
    ``[S, C]`` per-segment cluster sizes: one worklist spans every
    segment, so a probed cluster costs ``sum_s ceil(size_s / tile_c)``
    tiles and the bound is the top-``nprobe`` sum of those."""
    sizes = np.asarray(per_segment_sizes, np.int64)
    if sizes.ndim != 2:
        raise ValueError(
            f"per_segment_sizes must be [n_segments, n_centroids], got shape {sizes.shape}"
        )
    tiles = -np.sort(-((sizes + tile_c - 1) // tile_c).sum(axis=0))
    return max(1, int(tiles[:nprobe].sum()))


def filtered_probe_sizes(probe_sizes, probe_cids, cluster_live):
    """Zero the probe sizes of clusters with no surviving tokens (the
    doc filter's worklist pushdown): numpy in -> numpy out (the adaptive
    rung's host demand), tensors in -> tensor out. ``[..., Q, P]`` sizes
    against ``cluster_live`` bool[C]."""
    if isinstance(probe_sizes, np.ndarray):
        live = np.asarray(cluster_live, bool)[np.asarray(probe_cids)]
        return np.where(live, probe_sizes, 0)
    return torch.where(cluster_live[probe_cids], probe_sizes, 0)


def bucket_ladder(bound: int, *, max_rungs: int = DEFAULT_BUCKET_RUNGS) -> tuple[int, ...]:
    """Ascending ladder of tile bounds topped by ``bound``: powers of two
    halving from the largest one strictly below ``bound``."""
    if bound <= 1 or max_rungs <= 1:
        return (max(1, bound),)
    rungs = [bound]
    p = 1 << (bound - 1).bit_length() - 1
    while len(rungs) < max_rungs and p >= 1:
        rungs.append(p)
        p //= 2
    return tuple(sorted(rungs))


def probe_tile_counts(probe_sizes, tile_c: int) -> np.ndarray:
    """Per-probe tile counts ``ceil(size / tile_c)`` as a host array."""
    sizes = np.asarray(probe_sizes, np.int64)
    return (sizes + tile_c - 1) // tile_c


def needed_worklist_tiles(tiles, *, amortized: bool = True) -> int:
    """Per-query-token tile demand of ``tiles`` [..., Q, nprobe]:
    ``ceil(total / Q)`` when amortized (memory="full"), else the largest
    single-token count; the max over leading dims."""
    t = np.asarray(tiles, np.int64)
    per_qtok = t.sum(axis=-1)
    if amortized:
        qm = per_qtok.shape[-1]
        need = -(-per_qtok.sum(axis=-1) // max(1, qm))
    else:
        need = per_qtok
    return max(1, int(need.max()) if need.size else 1)


def pick_bucket(buckets: tuple[int, ...], needed: int) -> int:
    """Smallest ladder rung holding ``needed`` tiles (the top rung else)."""
    for b in buckets:
        if b >= needed:
            return b
    return buckets[-1]


def build_tile_worklist(
    starts: torch.Tensor,
    sizes: torch.Tensor,
    probe_scores: torch.Tensor,
    *,
    tile_c: int,
    tiles_per_qtoken: int,
    seg: torch.Tensor | None = None,
):
    """Flatten ``[..., Q, P]`` probes into worklists of static length
    ``W = Q * tiles_per_qtoken`` per leading index -> ``TileWorklist``.
    With ``seg`` ([..., Q, P] segment id of each probe run; P is then
    nprobe * n_segments) -> ``SegmentedTileWorklist``."""
    *lead, qm, p = starts.shape
    w = qm * tiles_per_qtoken
    dev = starts.device
    flat_starts = starts.reshape(-1, qm * p).long()
    flat_sizes = sizes.reshape(-1, qm * p).long()
    flat_pscores = probe_scores.reshape(-1, qm * p).float()
    n_lead = flat_starts.shape[0]

    tiles = (flat_sizes + (tile_c - 1)) // tile_c
    cum = torch.cumsum(tiles, dim=-1)
    first = cum - tiles
    total = cum[:, -1:] if qm * p else torch.zeros((n_lead, 1), dtype=torch.long, device=dev)

    wid = torch.arange(w, dtype=torch.long, device=dev).expand(n_lead, w)
    # Probe owning tile ``wid``: right=True maps wid == cum[e] to run e+1.
    e = torch.searchsorted(cum.contiguous(), wid.contiguous(), right=True)
    e = e.clamp_max(max(qm * p - 1, 0))
    j = wid - torch.gather(first, 1, e)

    used = wid < total
    row0 = torch.gather(flat_starts, 1, e) + j * tile_c
    nvalid = (torch.gather(flat_sizes, 1, e) - j * tile_c).clamp(0, tile_c)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    out = TileWorklist(
        row0=torch.where(used, row0, zero).to(torch.int32),
        nvalid=torch.where(used, nvalid, zero).to(torch.int32),
        qtok=torch.where(used, e // p, zero).to(torch.int32),
        pscore=torch.where(used, torch.gather(flat_pscores, 1, e), 0.0),
    )
    if seg is not None:
        flat_seg = seg.reshape(-1, qm * p).long()
        seg_out = torch.where(used, torch.gather(flat_seg, 1, e), zero).to(torch.int32)
        return SegmentedTileWorklist(
            *(a.reshape(*lead, w) for a in (out.row0, out.nvalid, seg_out, out.qtok, out.pscore))
        )
    return TileWorklist(*(a.reshape(*lead, w) for a in out))


def worklist_slot_positions(
    wl: TileWorklist, *, tile_c: int, n_tokens: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot CSR positions ``[..., W * tile_c]`` clamped into
    ``[0, n_tokens)`` (floor 0: an empty index never gathers row -1) and
    the slot validity mask."""
    lane = torch.arange(tile_c, dtype=torch.long, device=wl.row0.device)
    pos = wl.row0.long().unsqueeze(-1) + lane
    valid = lane < wl.nvalid.long().unsqueeze(-1)
    pos = pos.clamp(0, max(0, n_tokens - 1))
    lead = wl.row0.shape[:-1]
    return pos.reshape(*lead, -1), valid.reshape(*lead, -1)


def per_slot(x: torch.Tensor, tile_c: int) -> torch.Tensor:
    """Repeat each entry of a per-tile array ``[..., W]`` over its
    ``tile_c`` slots -> ``[..., W * tile_c]`` (a view and a copy; unlike
    ``repeat_interleave`` it never syncs with the device)."""
    return x.unsqueeze(-1).expand(*x.shape, tile_c).reshape(*x.shape[:-1], -1)
