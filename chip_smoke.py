#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile]

Drives the port's main path at warp-xtr width on a synthetic index of
LoTTE Lifestyle geometry (``repro/configs/warp_family.py``,
``search_lifestyle``: 23.71M tokens, 119,461 docs, 2^17 centroids, cap
1024; D = 128, nbits = 4, 32 query tokens, nprobe 32, k 100, k_impute 64),
built on the card from ``--seed`` (the index build itself is not ported):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     one process per source, in parallel) and hold each kernel against
     its plain PyTorch version at the main path's shapes, with timings and
     the bytes bound;
  2. retrieve through ``Retriever.plan(...).retrieve`` / ``retrieve_batch``
     for (materialize, dense), (fused, dense), (fused, ragged) and
     (materialize, ragged), each at executor "kernel" and "reference",
     128 timed queries per plan; the launch counts of this phase show the
     main path went through the kernels;
  3. serve requests of varied length through ``RetrievalServer``: a
     burst of 256 (drain throughput), then 256 Poisson arrivals at half
     that rate (submit-to-reply latency); every reply is held against
     ``plan.retrieve``;
  4. match the committed fixture (``tests/data/torch_fixture``, expected
     results written by the JAX package) on the card.

Top-k doc ids must be identical. A swap is allowed only between scores
tied within what the kernels' measured error allows (``tie_tolerance``),
and every one is reported.

Any failed check raises: the script exits non-zero and prints no result.
Its last three lines are the kernels JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. It exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

ARCH = dict(dim=128, nbits=4, query_maxlen=32, nprobe=32, k=100, k_impute=64)
GEOMETRY = dict(n_tokens=23_710_000, n_docs=119_461, n_centroids=1 << 17, cap=1024)
CONFIGS = (
    ("materialize", "dense"), ("fused", "dense"), ("fused", "ragged"), ("materialize", "ragged"),
)
KERNEL_OF = {
    ("materialize", "dense"): "selective_sum",
    ("fused", "dense"): "fused_gather_score",
    ("fused", "ragged"): "ragged_fused_gather_score",
    # Scores the gathered copy of the worklist's rows with the worklist kernel.
    ("materialize", "ragged"): "ragged_fused_gather_score",
}
KERNEL_INFO = {
    "selective_sum": (
        "src/repro_torch/kernels/csrc/selective_sum.cu",
        "src/repro/kernels/decompress_score.py:72",
    ),
    "fused_gather_score": (
        "src/repro_torch/kernels/csrc/fused_gather_score.cu",
        "src/repro/kernels/fused_gather_score.py:312",
    ),
    "ragged_fused_gather_score": (
        "src/repro_torch/kernels/csrc/ragged_fused_gather_score.cu",
        "src/repro/kernels/fused_gather_score.py:537",
    ),
}
TOL = 1e-4  # kernel vs plain version, and scores across executors


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# synthetic index and queries, made on the card
# ---------------------------------------------------------------------------


def cluster_sizes(torch, g, n_clusters: int, n_tokens: int, cap: int, dev):
    """Heavy-tailed (log-normal) sizes in [1, cap] with max exactly cap
    and sum exactly n_tokens."""
    w = torch.exp(torch.randn(n_clusters, generator=g, device=dev, dtype=torch.float64))

    def sizes_at(alpha):
        return torch.clamp(torch.round(w * alpha), 1, cap).long()

    lo, hi = 0.0, 4.0 * cap / float(w.mean())
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if int(sizes_at(mid).sum()) < n_tokens:
            lo = mid
        else:
            hi = mid
    sizes = sizes_at(hi)
    excess = int(sizes.sum()) - n_tokens  # >= 0, small
    while excess > 0:
        room = torch.nonzero((sizes > 1) & (sizes < cap)).squeeze(1)
        pick = room[torch.randperm(room.numel(), generator=g, device=dev)[:excess]]
        sizes[pick] -= 1
        excess = int(sizes.sum()) - n_tokens
    if int(sizes.max()) != cap or int(sizes.sum()) != n_tokens:
        fail("synthetic cluster sizes missed their max/sum targets")
    return sizes


def make_index(torch, seed: int, dev):
    from repro_torch.core import WarpIndex

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, nbits = ARCH["dim"], ARCH["nbits"]
    n, c, cap = GEOMETRY["n_tokens"], GEOMETRY["n_centroids"], GEOMETRY["cap"]
    sizes = cluster_sizes(torch, g, c, n, cap, dev)
    offsets = torch.zeros(c + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    cent = torch.randn(c, d, generator=g, device=dev)
    cent = cent / cent.norm(dim=1, keepdim=True)
    codes = torch.randint(0, 256, (n, d * nbits // 8), generator=g, device=dev, dtype=torch.uint8)
    doc_ids = torch.randint(
        0, GEOMETRY["n_docs"], (n,), generator=g, device=dev, dtype=torch.int32
    )
    nb = 1 << nbits
    quant = torch.special.ndtri((torch.arange(nb, device=dev, dtype=torch.float64) + 0.5) / nb)
    cuts = torch.special.ndtri(torch.arange(1, nb, device=dev, dtype=torch.float64) / nb)
    return WarpIndex(
        centroids=cent,
        packed_codes=codes,
        token_doc_ids=doc_ids,
        cluster_offsets=offsets.int(),
        cluster_sizes=sizes.int(),
        bucket_weights=(0.05 * quant).float(),
        bucket_cutoffs=(0.05 * cuts).float(),
        dim=d, nbits=nbits, cap=cap, n_docs=GEOMETRY["n_docs"], n_tokens=n,
    )


def make_queries(torch, index, n: int, seed: int, *, lo=8, hi=32):
    """Noisy copies of random centroids; each query has lo..hi active
    tokens (the rest masked and zero)."""
    g = torch.Generator(device=index.device)
    g.manual_seed(seed)
    qm, d = ARCH["query_maxlen"], ARCH["dim"]
    cids = torch.randint(0, index.n_centroids, (n, qm), generator=g, device=index.device)
    q = index.centroids[cids] + 0.04 * torch.randn(n, qm, d, generator=g, device=index.device)
    q = q / q.norm(dim=-1, keepdim=True)
    active = torch.randint(lo, hi + 1, (n, 1), generator=g, device=index.device)
    qmask = torch.arange(qm, device=index.device) < active
    return q * qmask.unsqueeze(-1), qmask


# ---------------------------------------------------------------------------
# timing and comparison
# ---------------------------------------------------------------------------


def time_cuda(torch, fn, flush, iters: int = 25) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs,
    with the 50 MB L2 flushed (a 256 MB write) before each run."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def tie_tolerance(kernel_err: float, scores) -> float:
    """How far apart two doc scores may lie and still count as tied when
    two executors or batch shapes computed them: a doc's score sums one
    candidate score per query token, each off by at most the kernels'
    measured error, and is rounded once to float32 (one ulp at the
    largest score); doubled for margin."""
    top = np.abs(scores[np.isfinite(scores)]).max(initial=0.0)
    return 2.0 * (ARCH["query_maxlen"] * kernel_err + float(np.spacing(np.float32(top))))


def topk_swaps(what: str, ids_a, s_a, ids_b, s_b, kernel_err: float) -> int:
    """Positions where two top-k lists name different docs. Raises unless
    the scores agree within ``TOL`` position by position and every such
    position lies in a run of scores tied within ``tie_tolerance`` that
    also holds the other list's doc there (or, at the k-th place, whose
    score is tied with it)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a), np.asarray(s_b)
    tie = tie_tolerance(kernel_err, s_a)
    if not np.allclose(s_a, s_b, rtol=TOL, atol=TOL):
        fail(f"{what}: scores differ by more than {TOL}")
    diff = np.flatnonzero(ids_a != ids_b)
    for ids_x, s_x, ids_y, s_y in ((ids_a, s_a, ids_b, s_b), (ids_b, s_b, ids_a, s_a)):
        for i in diff:
            run = np.flatnonzero(np.abs(s_x - s_x[i]) <= tie)
            at_cut = run[-1] == len(s_x) - 1 and abs(s_y[i] - s_x[i]) <= tie
            if not (ids_y[i] in ids_x[run] or at_cut):
                fail(
                    f"{what}: doc {ids_y[i]} at place {i} (score {float(s_y[i])!r}) vs doc "
                    f"{ids_x[i]} (score {float(s_x[i])!r}) is not a swap within a tie of {tie:.3g}"
                )
    if diff.size:
        log(f"[ties] {what}: places {diff.tolist()} swapped within a tie of {tie:.3g}")
    return int(diff.size)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(torch, index, plan_ragged, flush):
    """Each kernel against its plain version at the main path's shapes."""
    from repro_torch.core import warpselect
    from repro_torch.core import worklist as wl
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decompress_score import selective_sum_cuda
    from repro_torch.kernels.fused_gather_score import (
        fused_gather_score_cuda,
        ragged_fused_gather_score_cuda,
    )

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[kernels] built {len(paths)} libraries in {time.perf_counter() - t0:.1f}s")
    for name, path in paths.items():
        with open(path.with_name(f"{name}.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[ptxas] {name}: {line.strip()}")

    dev = index.device
    q, _ = make_queries(torch, index, 1, seed=12345, lo=32, hi=32)
    q = q[0]
    cfg = plan_ragged.config
    sel = warpselect.warp_select(
        q, index.centroids, index.cluster_sizes, nprobe=cfg.nprobe,
        t_prime=cfg.t_prime, k_impute=cfg.k_impute,
    )
    starts = index.cluster_offsets[sel.probe_cids].int().contiguous()
    sizes = sel.probe_sizes.int().contiguous()
    pscore = sel.probe_scores.float().contiguous()
    v = (q.unsqueeze(-1) * index.bucket_weights).contiguous()
    qm, p = starts.shape
    d, nbits, cap, pb = index.dim, index.nbits, index.cap, index.packed_codes.shape[1]
    nb = 1 << nbits
    rows = int(sizes.sum())
    vbytes = qm * d * nb * 4
    out = []

    def record(name, got, want, k_fn, p_fn, nbytes, ops):
        err = float((got - want).abs().max())
        if not err <= TOL:
            fail(f"{name}: max abs err {err} vs its plain version > {TOL}")
        ms = time_cuda(torch, k_fn, flush)
        plain_ms = time_cuda(torch, p_fn, flush, iters=5)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        row = {
            "name": name,
            "route": "cuda",
            "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "launches": 0,
            "max_abs_err": err,
            "max_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "bytes": int(nbytes),
        }
        log(f"[kernels] {json.dumps(row)}")
        out.append(row)

    # 1. selective_sum over the gathered [Q, P * cap, PB] candidate codes.
    lane = torch.arange(cap, device=dev)
    pos = (starts.long().unsqueeze(-1) + lane).clamp(0, index.n_tokens - 1)
    gathered = index.packed_codes[pos].reshape(qm, p * cap, pb).contiguous()
    kw = dict(nbits=nbits, dim=d)
    got = selective_sum_cuda(gathered, v, **kw)
    want = ref.selective_sum(gathered, v, **kw)
    record(
        "selective_sum", got, want,
        lambda: selective_sum_cuda(gathered, v, **kw),
        lambda: ref.selective_sum(gathered, v, **kw),
        gathered.numel() + vbytes + 4 * qm * p * cap, qm * p * cap * d,
    )
    del gathered

    # 2. fused dense grid [Q, P, cap].
    kw2 = dict(nbits=nbits, dim=d, cap=cap)
    args2 = (index.packed_codes, starts, sizes, pscore, v)
    got = fused_gather_score_cuda(*args2, **kw2)
    want = ref.fused_gather_score(*args2, **kw2)
    invalid = lane >= sizes.long().unsqueeze(-1)
    if bool((got[invalid] != 0).any()):
        fail("fused_gather_score: an invalid slot is not exactly 0")
    record(
        "fused_gather_score", got, want,
        lambda: fused_gather_score_cuda(*args2, **kw2),
        lambda: ref.fused_gather_score(*args2, **kw2),
        rows * pb + qm * p * 12 + vbytes + 4 * qm * p * cap, rows * d,
    )

    # 3. ragged worklist at the rung the adaptive plan picks for this query.
    tile = cfg.tile_c
    tiles = wl.probe_tile_counts(sizes.cpu().numpy(), tile)
    bucket = wl.pick_bucket(cfg.worklist_buckets, wl.needed_worklist_tiles(tiles))
    work = wl.build_tile_worklist(starts, sizes, pscore, tile_c=tile, tiles_per_qtoken=bucket)
    args3 = tuple(a.contiguous() for a in (index.packed_codes, *work, v))
    kw3 = dict(nbits=nbits, dim=d, tile_c=tile)
    got = ragged_fused_gather_score_cuda(*args3, **kw3)
    want = ref.ragged_fused_gather_score(*args3, **kw3)
    slot_invalid = (torch.arange(tile, device=dev) >= work.nvalid.long().unsqueeze(-1)).reshape(-1)
    if bool((got[slot_invalid] != 0).any()):
        fail("ragged_fused_gather_score: an invalid slot is not exactly 0")
    w = work.row0.numel()
    record(
        "ragged_fused_gather_score", got, want,
        lambda: ragged_fused_gather_score_cuda(*args3, **kw3),
        lambda: ref.ragged_fused_gather_score(*args3, **kw3),
        int(work.nvalid.sum()) * pb + w * 16 + vbytes + 4 * w * tile, int(work.nvalid.sum()) * d,
    )
    log(
        f"[kernels] shapes: Q={qm} P={p} cap={cap} D={d} nbits={nbits} "
        f"probed_rows={rows} ragged tile_c={tile} rung={bucket} W={w}"
    )
    return out


def percentiles_ms(seconds) -> dict:
    s = np.asarray(seconds) * 1e3
    return {f"p{q}": float(np.percentile(s, q)) for q in (50, 95, 99)}


def phase_retrieve(torch, retriever, queries, qmask, batch: int, kernel_err: float):
    """Every config at both executors over all ``queries``, one retrieve
    each (after one untimed warm-up), plus one ``retrieve_batch`` of the
    first ``batch``. Returns the launch counts of the run and the
    per-plan latency percentiles (ms)."""
    from repro_torch.core import WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, reset_launches

    n = queries.shape[0]
    reset_launches()
    results, launches, lat = {}, {}, {}
    swaps = 0
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            name = "/".join(key)
            plan = retriever.plan(WarpSearchConfig(
                nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
                gather=gather, layout=layout, executor=executor,
            ))
            before = dict(LAUNCHES)
            plan.retrieve(queries[0], qmask[0])
            single, times = [], []
            for i in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = plan.retrieve(queries[i], qmask[i])
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                single.append((res.doc_ids.cpu().numpy(), res.scores.cpu().numpy()))
            bres = plan.retrieve_batch(queries[:batch], qmask[:batch])
            bids, bsc = bres.doc_ids.cpu().numpy(), bres.scores.cpu().numpy()
            for i in range(batch):
                swaps += topk_swaps(
                    f"{name} retrieve_batch[{i}] vs retrieve",
                    bids[i], bsc[i], *single[i], kernel_err,
                )
            results[key] = single
            launches[key] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            lat[key] = percentiles_ms(times)
            log(
                f"[retrieve] {name}: per-query latency over {n} queries (ms) "
                f"{json.dumps(lat[key])}, launches {launches[key]}, "
                f"describe {json.dumps(plan.describe())}"
            )
    counts = dict(LAUNCHES)  # read right after the main path's run
    exact = 0
    for gather, layout in CONFIGS:
        kname = KERNEL_OF[(gather, layout)]
        if launches[(gather, layout, "kernel")][kname] <= 0:
            fail(f"{gather}/{layout}: kernel {kname} was never launched")
        if any(launches[(gather, layout, "reference")].values()):
            fail(f"{gather}/{layout}: the reference executor launched a kernel")
        for i in range(n):
            ki, ri = results[(gather, layout, "kernel")][i], results[(gather, layout, "reference")][i]
            s = topk_swaps(f"{gather}/{layout} kernel vs reference, query {i}", *ki, *ri, kernel_err)
            swaps += s
            exact += int(s == 0)
    base = results[("materialize", "dense", "reference")]
    for key, res in results.items():
        for i in range(n):
            swaps += topk_swaps(
                f"{'/'.join(key)} vs materialize/dense/reference, query {i}",
                *res[i], *base[i], kernel_err,
            )
    log(
        f"[retrieve] kernel vs reference: identical doc ids on {exact} of "
        f"{n * len(CONFIGS)} (query, config) pairs; {swaps} places swapped "
        "within a tie over all comparisons"
    )
    return counts, lat


def phase_serve(torch, retriever, n_requests: int, seed: int, kernel_err: float):
    """``RetrievalServer`` over the (fused, ragged) plan: a burst of
    ``n_requests`` drained at once (throughput), then ``n_requests``
    Poisson arrivals at half that rate, driven open loop (latency from
    each request's scheduled arrival to the loop seeing its reply).
    Every reply is held against ``plan.retrieve``."""
    from repro_torch.core import WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import PENDING, BatchPolicy, RetrievalServer

    cfg = WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    )
    policy = BatchPolicy(max_batch=8, max_wait_s=0.002)
    server = RetrievalServer(retriever, cfg, policy)
    q, qmask = make_queries(torch, retriever.index, 2 * n_requests, seed, lo=4, hi=32)
    qh, mh = q.cpu().numpy(), qmask.cpu().numpy()
    for rung in server.config.worklist_buckets:
        server.plan.retrieve_batch_at(qh[:8], mh[:8], bucket=rung)
    reset_launches()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    rids = [server.submit(qh[i], mh[i]) for i in range(n_requests)]
    server.drain()
    burst_s = time.perf_counter() - t0
    burst = server.summary()
    replies = {i: server.poll(rid) for i, rid in enumerate(rids)}
    capacity = n_requests / burst_s
    server.latencies.clear()  # the summary's percentiles cover the paced run

    rate = 0.5 * capacity
    arrive = np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n_requests))
    waiting, lat = {}, np.zeros(n_requests)
    nxt = 0
    t0 = time.perf_counter()
    while nxt < n_requests or waiting:
        now = time.perf_counter() - t0
        while nxt < n_requests and arrive[nxt] <= now:
            j = n_requests + nxt
            waiting[server.submit(qh[j], mh[j])] = nxt
            nxt += 1
        if server.step() == 0:
            time.sleep(1e-4)
            continue
        done = time.perf_counter() - t0
        for rid, i in list(waiting.items()):
            out = server.poll(rid)
            if out is not PENDING:
                replies[n_requests + i] = out
                lat[i] = done - arrive[i]
                del waiting[rid]
    paced_s = time.perf_counter() - t0
    launched = LAUNCHES["ragged_fused_gather_score"]
    if launched <= 0:
        fail("serve: the ragged kernel was never launched")

    swaps = 0
    for i, (scores, ids) in sorted(replies.items()):
        want = server.plan.retrieve(qh[i], mh[i])
        swaps += topk_swaps(
            f"serve reply {i} vs plan.retrieve", ids, scores,
            want.doc_ids.cpu().numpy(), want.scores.cpu().numpy(), kernel_err,
        )
    paced = percentiles_ms(lat)
    log(
        f"[serve] burst: {n_requests} requests drained in {burst_s * 1e3:.3f} ms = "
        f"{capacity:.3f} requests/s ({burst['batches']} batches)"
    )
    log(
        f"[serve] paced: {n_requests} Poisson arrivals at {rate:.3f}/s over "
        f"{paced_s * 1e3:.3f} ms = {n_requests / paced_s:.3f} requests/s served; "
        f"arrival-to-reply latency (ms) {json.dumps(paced)}"
    )
    log(
        f"[serve] {2 * n_requests} replies equal plan.retrieve ({swaps} places swapped "
        f"within a tie); ragged kernel launches {launched}; summary "
        f"{json.dumps(server.summary())}"
    )


def phase_profile(torch, retriever, queries, qmask, n: int = 5):
    """Where a retrieve's time goes, per kernel config: ``torch.profiler``
    over ``n`` retrieves — wall time, device-busy share (summed device
    kernel time over wall), the top device kernels and the top host ops
    by self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import WarpSearchConfig

    for gather, layout in CONFIGS:
        plan = retriever.plan(WarpSearchConfig(
            nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
            gather=gather, layout=layout, executor="kernel",
        ))
        plan.retrieve(queries[0], qmask[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                plan.retrieve(queries[i], qmask[i])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = sorted(
            ((getattr(e, "self_device_time_total", 0), e.key) for e in events
             if str(e.device_type).endswith("CUDA")),
            reverse=True,
        )
        host = sorted(
            ((e.self_cpu_time_total, e.key) for e in events
             if str(e.device_type).endswith("CPU")),
            reverse=True,
        )
        busy = sum(t for t, _ in kernels)
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        top_k = "; ".join(f"{k[:40]} {t / n:.1f}us" for t, k in kernels[:6])
        top_h = "; ".join(f"{k[:32]} {t / n:.1f}us" for t, k in host[:6])
        log(
            f"[profile] {gather}/{layout}/kernel: {wall_us / n:.1f} us wall per retrieve, "
            f"device kernels {busy / n:.1f} us ({busy / wall_us:.1%} busy), "
            f"{launches / n:.0f} kernel launches; top kernels "
            f"per retrieve: {top_k} | top host ops (self CPU): {top_h}"
        )


def phase_fixture(torch, dev):
    from repro_torch.core import Retriever, WarpSearchConfig

    fdir = os.path.join(ROOT, "tests", "data", "torch_fixture")
    with open(os.path.join(fdir, "expected.json")) as f:
        expected = json.load(f)
    qz = np.load(os.path.join(fdir, "queries.npz"))
    r = Retriever.from_store(os.path.join(fdir, "store"), device=dev)
    n = 0
    for case in expected["cases"]:
        for executor in ("kernel", "reference"):
            cfg = WarpSearchConfig(**case["config"], executor=executor)
            res = r.plan(cfg).retrieve_batch(qz["q"], qz["qmask"])
            ids, sc = res.doc_ids.cpu().numpy(), res.scores.cpu().numpy()
            for i in range(len(ids)):
                if not np.array_equal(ids[i], np.asarray(case["doc_ids"][i])):
                    fail(f"fixture {case['name']}/{executor} query {i}: doc ids differ from JAX")
                np.testing.assert_allclose(sc[i], case["scores"][i], rtol=TOL, atol=TOL)
                n += 1
    log(f"[fixture] {n} (query, config, executor) results match the JAX expected ids")


def run(torch, dev, args) -> list:
    """All phases on ``dev``; returns the kernels rows (raises on any
    failed check)."""
    from repro_torch.core import Retriever, WarpSearchConfig

    t0 = time.perf_counter()
    index = make_index(torch, args.seed, dev)
    torch.cuda.synchronize()
    sizes = index.cluster_sizes.float()
    log(
        f"[index] built in {time.perf_counter() - t0:.1f}s: {index.n_tokens} tokens, "
        f"{index.n_docs} docs, {index.n_centroids} clusters (mean {float(sizes.mean()):.1f}, "
        f"max {int(sizes.max())}), {index.nbytes() / 1e9:.3f} GB on the card"
    )
    retriever = Retriever.from_index(index, device=dev)
    plan_ragged = retriever.plan(WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    ))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = phase_kernels(torch, index, plan_ragged, flush)
    del flush
    kernel_err = max(row["max_abs_err"] for row in kernels)
    queries, qmask = make_queries(torch, index, 128, args.seed + 1)
    counts, _ = phase_retrieve(torch, retriever, queries, qmask, 4, kernel_err)
    for row in kernels:
        row["launches"] = counts[row["name"]]
    if args.profile:
        phase_profile(torch, retriever, queries, qmask)
    phase_serve(torch, retriever, 256, args.seed + 2, kernel_err)
    phase_fixture(torch, dev)
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="after the retrieve phase, profile where a retrieve's time goes",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    kernels = run(torch, torch.device("cuda"), args)
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
