"""The tile autotune sweep of the fused gather–score kernels, on the card.
Counterpart of ``benchmarks/bench_autotune.py``.

For one index and one query's probe set it times the kernels at their
``probe`` carve-outs (``kernels/fused_gather_score.py``):

  probe="full"     the product kernel (rows staged and scored)
  probe="dma"      rows staged through the cp.async ring, not scored
  probe="compute"  rows scored from the ring, never staged

``autotune.overlap_frac = clamp((dma + compute - full) / min(dma,
compute), 0, 1)``: 0 when staging and scoring serialize, 1 when the
shorter hides wholly behind the longer.

The ragged kernel is swept over ``DEFAULT_TILES`` at the worklist rung a
plan would run this probe set at; the dense kernel has no tile (its grid
splits each token's flattened probed rows), so it is timed once and its
entry recorded under the heuristic's tile: a tuned dense plan resolves the
tile it would have resolved anyway, from "autotune", and the entry exists
so that the table has the JAX package's form. The card has one schedule, so
every entry's ``buffering`` is "double". The winner per (geometry bucket,
layout) is the smallest full time, recorded with ``measured_on="cuda"``
into an ``autotune.AutotuneTable``, saved (default path:
``autotune.default_table_path()``) and installed in-process.

Each point is timed with CUDA events (``event_ms``), the 50 MB L2
flushed (a 256 MB write) before every run, median of ``iters`` after
``warmup`` runs. It runs on the card only:

    PYTHONPATH=src python -m repro_torch.kernels.autotune_sweep --store PATH [--out PATH]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import worklist as wl
from repro_torch.core.warpselect import warp_select
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.fused_gather_score import (
    fused_gather_score_cuda,
    ragged_fused_gather_score_cuda,
)

__all__ = [
    "DEFAULT_TILES", "event_ms", "dense_point", "ragged_point",
    "sweep_probe_set", "sweep_queries", "run", "main",
]

DEFAULT_TILES = (16, 32, 64, 128)
FLUSH_BYTES = 256 << 20


def _require_card(index) -> None:
    if not torch.cuda.is_available() or index.packed_codes.device.type != "cuda":
        raise RuntimeError(
            "the autotune sweep times the CUDA kernels and runs on the card only "
            f"(torch.cuda.is_available() is {torch.cuda.is_available()}, the index is on "
            f"{index.packed_codes.device})"
        )


# Cycles the card spins before each timed run (~0.1 ms at 1.98 GHz), and
# the most it doubles to: the host enqueues the run meanwhile, so the
# events bracket the device's work, not an idle card waiting for the
# launch's host path.
SPIN_CYCLES = 200_000
SPIN_CYCLES_MAX = 64 * SPIN_CYCLES


def event_ms(fn, *, warmup: int, iters: int, flush=None) -> float:
    """Median milliseconds of ``fn`` on the card over ``iters``
    CUDA-event-timed runs, after ``warmup`` untimed ones. Each run is
    queued behind a write of ``flush`` (which also empties the L2), if
    given, then a spin of the card. A run whose start event had fired
    before ``fn`` returned (the card went idle while the host queued it)
    is run again behind a spin twice as long, up to ``SPIN_CYCLES_MAX``;
    past that its time stands, host path included."""
    for _ in range(warmup):
        fn()
    times, spin = [], SPIN_CYCLES
    while len(times) < iters:
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        late = start.query()
        end.record()
        end.synchronize()
        if late and spin < SPIN_CYCLES_MAX:
            spin *= 2
            continue
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _probe_times(make_call, flush, *, warmup: int, iters: int) -> dict:
    """``make_call(probe)`` -> zero-argument launch; -> {"full_ms",
    "dma_ms", "compute_ms", "overlap_frac"}."""
    t = {
        f"{p}_ms": event_ms(make_call(p), warmup=warmup, iters=iters, flush=flush)
        for p in ("full", "dma", "compute")
    }
    t["overlap_frac"] = autotune.overlap_frac(t["full_ms"], t["dma_ms"], t["compute_ms"])
    return t


def dense_point(index, starts, sizes, pscores, v, *, flush, warmup: int = 2,
                iters: int = 25) -> dict:
    """The dense kernel's split at this probe set: starts/sizes i32[Q, P],
    pscores f32[Q, P], v f32[Q, D, 2^b] (``sweep_probe_set``)."""
    _require_card(index)

    def make_call(probe):
        return lambda: fused_gather_score_cuda(
            index.packed_codes, starts, sizes, pscores, v,
            nbits=index.nbits, dim=index.dim, cap=index.cap, probe=probe,
        )

    return _probe_times(make_call, flush, warmup=warmup, iters=iters)


def ragged_rung(index, sizes, tile_c: int) -> int:
    """The worklist rung a ragged plan runs this probe set at: the
    smallest rung of the index's bucket ladder at ``tile_c`` that holds
    its tiles."""
    bound = wl.worklist_bound(index.cluster_sizes.cpu().numpy(), sizes.shape[-1], tile_c)
    needed = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes.cpu().numpy(), tile_c))
    return wl.pick_bucket(wl.bucket_ladder(bound), needed)


def ragged_worklist(index, starts, sizes, pscores, tile_c: int, tiles_per_qtoken=None):
    """The flat worklist of this probe set at ``tile_c`` (by default at
    ``ragged_rung``)."""
    if tiles_per_qtoken is None:
        tiles_per_qtoken = ragged_rung(index, sizes, tile_c)
    return wl.build_tile_worklist(
        starts, sizes, pscores, tile_c=tile_c, tiles_per_qtoken=tiles_per_qtoken
    )


def ragged_point(index, starts, sizes, pscores, v, *, tile_c: int, flush,
                 tiles_per_qtoken=None, warmup: int = 2, iters: int = 25) -> dict:
    """The ragged kernel's split at one tile, on the worklist
    ``ragged_worklist`` builds from the same probe set."""
    _require_card(index)
    work = ragged_worklist(index, starts, sizes, pscores, tile_c, tiles_per_qtoken)

    def make_call(probe):
        return lambda: ragged_fused_gather_score_cuda(
            index.packed_codes, *work, v,
            nbits=index.nbits, dim=index.dim, tile_c=tile_c, probe=probe,
        )

    return _probe_times(make_call, flush, warmup=warmup, iters=iters)


def sweep_probe_set(index, q, qmask, *, nprobe: int, qtokens: int):
    """One query's probe set at sweep shape: q f32[Q', D], qmask bool[Q']
    (its first ``qtokens`` tokens) -> (starts, sizes, pscores, v) with
    Q = qtokens, P = nprobe; masked tokens probe nothing."""
    q0 = q[:qtokens].float()
    m0 = qmask[:qtokens].bool()
    sel = warp_select(
        q0, index.centroids, index.cluster_sizes, nprobe=nprobe,
        t_prime=min(index.n_tokens, 1000), k_impute=min(index.n_centroids, max(64, nprobe)),
        qmask=m0,
    )
    starts = index.cluster_offsets[sel.probe_cids].to(torch.int32).contiguous()
    sizes = torch.where(m0.unsqueeze(-1), index.cluster_sizes[sel.probe_cids], 0)
    v = (q0.unsqueeze(-1) * index.bucket_weights).contiguous()
    return starts, sizes.to(torch.int32).contiguous(), sel.probe_scores.float().contiguous(), v


def sweep_queries(index, qtokens: int = 32, seed: int = 0):
    """``qtokens`` query tokens, each a unit-norm noisy copy of a random
    centroid, all active: (q f32[qtokens, D], qmask)."""
    g = torch.Generator(device=index.device)
    g.manual_seed(seed)
    cids = torch.randint(0, index.n_centroids, (qtokens,), generator=g, device=index.device)
    q = index.centroids[cids] + 0.04 * torch.randn(
        qtokens, index.dim, generator=g, device=index.device
    )
    q = q / q.norm(dim=-1, keepdim=True)
    return q, torch.ones(qtokens, dtype=torch.bool, device=index.device)


def run(index, q, qmask, *, tiles=DEFAULT_TILES, nprobe: int = 32, qtokens: int = 32,
        warmup: int = 2, iters: int = 25, out_path: str | None = None,
        install: bool = True, log=print):
    """Sweep, record the winners, save the table (``out_path``, else
    ``autotune.default_table_path()``) and, with ``install``, make it the
    process default. Returns (table, rows): one row per point with its
    layout, tile and the four probe numbers."""
    _require_card(index)
    nprobe = min(nprobe, index.n_centroids)
    starts, sizes, pscores, v = sweep_probe_set(index, q, qmask, nprobe=nprobe, qtokens=qtokens)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=index.device)
    geo = dict(nbits=index.nbits, dim=index.dim, cap=index.cap, n_tokens=index.n_tokens)
    kw = dict(flush=flush, warmup=warmup, iters=iters)
    dense_tile = ops.resolve_tile_c(index.cap, layout="dense")
    points = [("dense", dense_tile, dense_point(index, starts, sizes, pscores, v, **kw))]
    points += [
        ("ragged", t, ragged_point(index, starts, sizes, pscores, v, tile_c=t, **kw))
        for t in tiles
    ]
    table, rows, best = autotune.AutotuneTable(), [], {}
    for layout, tile, pt in points:
        rows.append(dict(layout=layout, tile_c=tile, **pt))
        log(
            f"[autotune] {layout} tile_c {tile}: full {pt['full_ms']:.5f} ms, dma "
            f"{pt['dma_ms']:.5f} ms, compute {pt['compute_ms']:.5f} ms, overlap "
            f"{pt['overlap_frac']:.4f}"
        )
        if layout not in best or pt["full_ms"] < best[layout][1]["full_ms"]:
            best[layout] = (tile, pt)
    for layout, (tile, pt) in best.items():
        key = table.record(layout, autotune.TunedTile(
            tile_c=tile, buffering="double", dma_us=pt["dma_ms"] * 1e3,
            compute_us=pt["compute_ms"] * 1e3, total_us=pt["full_ms"] * 1e3,
            measured_on="cuda",
        ), **geo)
        log(f"[autotune] winner {key}: tile_c {tile}, full {pt['full_ms']:.5f} ms")
    path = out_path or autotune.default_table_path()
    table.save(path)
    log(f"[autotune] table of {len(table)} entries saved to {path}")
    if install:
        autotune.set_default_table(table)
    return table, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", required=True, help="a saved single index (warp_index store)")
    ap.add_argument("--out", default=None, help="table path (default: REPRO_AUTOTUNE_TABLE, "
                    "else build/autotune_cuda.json)")
    args = ap.parse_args(argv)

    from repro_torch.store import load_index

    if not torch.cuda.is_available():
        raise SystemExit("autotune_sweep: torch.cuda.is_available() is False; the sweep "
                         "runs on the card only")
    index = load_index(args.store, device="cuda", with_segments=False)
    if not hasattr(index, "packed_codes"):
        raise SystemExit(f"autotune_sweep: {args.store} is a sharded store; give one shard's "
                         "directory (shard_NNNNN/)")
    q, qmask = sweep_queries(index)
    path = args.out or autotune.default_table_path()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    run(index, q, qmask, out_path=path, install=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
