"""Serving launcher of the PyTorch port: stand up a ``RetrievalServer`` over
a synthetic corpus indexed on ``--device`` and push queries through it.
Counterpart of ``repro/launch/serve.py``, with its flags.

  PYTHONPATH=src python -m repro_torch.launch.serve --n-docs 500 --queries 32 \\
      --nprobe 16 --max-batch 8
  PYTHONPATH=src python -m repro_torch.launch.serve --traffic poisson --tenants 2 \\
      --duration-s 2 --trace-out trace.json --metrics-dump metrics.prom

It runs on ``--device`` (default ``cuda``, raising without CUDA; pass
``--device cpu`` for the CPU). ``--traffic poisson`` switches from
submit-all-then-drain to open-loop Poisson arrivals at ~70% of the
measured service rate, Zipf-skewed over a small query pool
(``--zipf-skew``), for ``--duration-s`` seconds. ``--tenants N`` serves N
indexes behind one scheduler (the extra ones from fresh synthetic
corpora). ``--trace-out`` records one span tree per request (admission,
rung pre-pass, queue wait, batch dispatch, engine stages, reply) as Chrome
trace-event JSON; ``--metrics-dump`` writes the metric registry at exit
(Prometheus text, or a JSON snapshot for a ``.json`` path).
``--n-shards`` is refused: serving a sharded index is not yet ported
(ROADMAP queue 1, item 10).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch import obs
from repro_torch.core import IndexBuildConfig, Retriever, WarpSearchConfig, index_stats
from repro_torch.core.types import resolve_device
from repro_torch.data import make_corpus, make_queries
from repro_torch.serving import AdmissionPolicy, BatchPolicy, Overloaded, RetrievalServer


def _run_poisson(server, corpus, args) -> None:
    """Open-loop wall-clock traffic: Poisson arrivals at ~70% of the
    measured service rate, Zipf-skewed popularity over a pool of 16
    queries, round-robin over the tenants."""
    pool = 16
    pq, pmask, _ = make_queries(corpus, n_queries=pool, tokens_per_query=(2, 24), seed=1)
    rng = np.random.default_rng(7)
    if args.zipf_skew > 0:
        p = np.arange(1, pool + 1, dtype=np.float64) ** -args.zipf_skew
        p /= p.sum()
    else:
        p = np.full(pool, 1.0 / pool)
    handles = list(server.tenants)

    # Warm and calibrate through the serving path, on cache misses.
    for _ in range(2):
        if server.result_cache is not None:
            server.result_cache.clear()
        for j in range(args.max_batch):
            server.submit(pq[j % pool], pmask[j % pool])
        t0 = time.perf_counter()
        server.drain()
        t_batch = time.perf_counter() - t0
    rate = 0.7 * args.max_batch / max(t_batch, 1e-4)
    for c in (server.result_cache, server._rung_cache):
        if c is not None:
            c.clear()
    print(f"poisson traffic: rate={rate:.1f} qps, skew={args.zipf_skew}, "
          f"{args.duration_s:.0f}s")

    interval = args.metrics_interval_s
    next_flush = server.clock() + interval if interval > 0 else float("inf")
    t_end = time.monotonic() + args.duration_s
    next_arrival = time.monotonic()
    submitted = shed = 0
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    while time.monotonic() < t_end:
        now = time.monotonic()
        if server.clock() >= next_flush:
            s = server.summary()
            print(
                f"[t+{args.duration_s - (t_end - now):.0f}s] "
                f"submitted={submitted} served={s['served']} shed={shed} "
                f"depth={s['queue_depth']} batches={s['batches']} "
                f"cache_hits={s['cache_hits']}"
            )
            next_flush += interval
        if now >= next_arrival:
            i = int(rng.choice(pool, p=p))
            try:
                server.submit(
                    pq[i], pmask[i], deadline_s=deadline_s,
                    tenant=handles[submitted % len(handles)],
                )
                submitted += 1
            except Overloaded:
                shed += 1
            next_arrival += float(rng.exponential(1.0 / rate))
            continue
        if server.step() == 0:  # dispatches full/expired batches only
            time.sleep(min(max(next_arrival - now, 0.0), 1e-3))
    server.drain()
    s = server.summary()
    print(
        f"submitted={submitted} served={s['served']} shed={shed} "
        f"expired={s['deadline_shed']} "
        f"batches={s['batches']} padded={s['padded_slots']} "
        f"promoted={s['promoted']} cache_hits={s['cache_hits']} "
        f"reloads={s['reloads']}"
    )
    print(f"rung occupancy: {s['rung_occupancy'] or '(single FIFO)'}")
    if s.get("result_cache"):
        print(f"result cache: {s['result_cache']}")


def _run_closed(server, corpus, args) -> None:
    """Closed-loop traffic: submit all queries (round-robin over the
    tenants), drain, and check the planted doc's recall on the default
    tenant's share."""
    q, qmask, rel = make_queries(corpus, n_queries=args.queries, seed=1)
    handles = list(server.tenants)
    t0 = time.perf_counter()
    ids = [
        server.submit(q[i], qmask[i], tenant=handles[i % len(handles)])
        for i in range(args.queries)
    ]
    server.drain()
    dt = time.perf_counter() - t0
    hits = n_default = 0
    for i, rid in enumerate(ids):
        scores, docs = server.result(rid, timeout=10.0)
        if handles[i % len(handles)] is None:
            hits += int(rel[i] in docs)
            n_default += 1
    print(
        f"served {args.queries} queries in {dt:.2f}s "
        f"({dt / args.queries * 1e3:.1f} ms/q incl. first calls) — "
        f"recall@{args.k} of planted doc: {hits}/{n_default}; "
        f"batches={server.stats['batches']} padded={server.stats['padded_slots']}"
    )
    tenants = server.summary().get("tenants")
    if tenants:
        print("per-tenant served: " + ", ".join(f"{t}={s['served']}" for t, s in tenants.items()))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--n-docs", type=int, default=500)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nbits", type=int, default=4)
    ap.add_argument("--n-shards", type=int, default=0,
                    help="refused unless 0: sharded serving is not yet ported "
                         "(ROADMAP queue 1, item 10)")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--gather", choices=["materialize", "fused"], default="materialize")
    ap.add_argument("--executor", choices=["auto", "kernel", "reference"], default="auto")
    ap.add_argument("--memory", choices=["full", "scan_qtokens"], default="full")
    ap.add_argument("--sum-impl", choices=["gather", "lut"], default="lut")
    ap.add_argument("--reduce-impl", choices=["scan", "segment"], default="segment")
    ap.add_argument("--layout", choices=["dense", "ragged"], default="dense",
                    help="ragged enables the adaptive worklist ladder the "
                         "bucket-aware scheduler batches per rung")
    ap.add_argument("--traffic", choices=["closed", "poisson"], default="closed",
                    help="closed = submit all then drain; poisson = open-loop "
                         "arrivals at a calibrated rate for --duration-s")
    ap.add_argument("--tenants", type=int, default=1,
                    help="serve this many independent indexes behind one "
                         "scheduler (traffic round-robins across them; "
                         "tenants beyond the first are built from fresh "
                         "synthetic corpora)")
    ap.add_argument("--zipf-skew", type=float, default=1.6,
                    help="query popularity skew for --traffic poisson (0 = uniform)")
    ap.add_argument("--duration-s", type=float, default=5.0,
                    help="wall-clock length of the poisson traffic run")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request queueing deadline for --traffic poisson; "
                         "expired requests are shed pre-dispatch with a typed "
                         "DeadlineExceeded (0 = none)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record per-request/per-stage spans and write a Chrome "
                         "trace-event JSON (open in https://ui.perfetto.dev)")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="dump serving/engine metrics at exit — Prometheus text "
                         "exposition, or a JSON snapshot when PATH ends in .json")
    ap.add_argument("--metrics-interval-s", type=float, default=10.0,
                    help="periodic summary flush interval for --traffic poisson, "
                         "on the server's clock (0 disables)")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.n_shards:
        ap.error("--n-shards: serving a sharded index is not yet ported to "
                 "repro_torch (ROADMAP queue 1, item 10: sharded search)")
    device = resolve_device(args.device)

    prev = (obs.STATE.tracer, obs.STATE.metrics)
    try:
        if args.trace_out:
            # The tracer shares the server's clock (time.monotonic) so the
            # queue-wait rows and the engine spans share one timeline.
            obs.set_tracer(obs.Tracer(clock=time.monotonic))
        registry = obs.enable_metrics() if args.metrics_dump else None
        _serve(args, device, registry)
    finally:
        obs.set_tracer(prev[0])
        obs.STATE.metrics = prev[1]
    return 0


def _serve(args, device, registry) -> None:
    build_cfg = IndexBuildConfig(nbits=args.nbits)
    corpus = make_corpus(args.n_docs, mean_doc_len=20, seed=0)
    t0 = time.perf_counter()
    retriever = Retriever.build(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, build_cfg, device=device
    )
    st = index_stats(retriever.index)
    print(
        f"indexed {st['n_tokens']} tokens -> {st['n_centroids']} centroids, "
        f"{st['bytes'] / 2**20:.1f} MiB on {device} in {time.perf_counter() - t0:.1f}s"
    )
    server = RetrievalServer(
        retriever,
        WarpSearchConfig(
            nprobe=args.nprobe, k=args.k, gather=args.gather, executor=args.executor,
            memory=args.memory, sum_impl=args.sum_impl, reduce_impl=args.reduce_impl,
            layout=args.layout,
        ),
        BatchPolicy(max_batch=args.max_batch, max_wait_s=args.max_wait_ms / 1e3),
        admission=AdmissionPolicy(max_queue_depth=16 * args.max_batch),
        registry=registry,
    )
    print(f"search plan: {server.plan.describe()}")
    for t in range(1, args.tenants):
        extra = make_corpus(args.n_docs, mean_doc_len=20, seed=100 + t)
        server.add_tenant(
            f"t{t}",
            Retriever.build(
                extra.emb, extra.token_doc_ids, extra.n_docs, build_cfg, device=device
            ),
        )
        print(f"tenant t{t}: {extra.n_docs} docs behind the same scheduler")
    if args.traffic == "poisson":
        _run_poisson(server, corpus, args)
    else:
        _run_closed(server, corpus, args)
    h = server.health()
    reasons = f" ({'; '.join(h['reasons'])})" if h["reasons"] else ""
    print(f"health: {h['status']}{reasons}")

    tr = obs.STATE.tracer
    if args.trace_out and tr is not None:
        tr.export(args.trace_out)
        print(f"trace: {len(tr.events())} events ({tr.dropped} dropped) -> {args.trace_out}")
    if args.metrics_dump:
        with open(args.metrics_dump, "w") as f:
            if args.metrics_dump.endswith(".json"):
                json.dump(registry.snapshot(), f, indent=1, sort_keys=True)
            else:
                f.write(registry.to_prometheus())
        print(f"metrics: {len(registry.metrics())} series -> {args.metrics_dump}")


if __name__ == "__main__":
    raise SystemExit(main())
