"""The port's serving subsystem against the JAX package's, on the same
scripted traffic under one fake clock (CPU, ``device="cpu"``; the JAX
side at executor "reference", both at reduce_impl "scan").

- A script of Zipf-skewed requests over two tenants (an in-memory index
  and a base + delta store), with an admission gate, deadlines, a doc
  filter, a midway ``delete_documents`` and ``reload``: the same
  served ids (scores within 1e-4), the same shed, overloaded and
  deadline sets, the same ``summary()`` counters and cache hit/miss
  counts across the reload.
- ``query_key`` hex, ``laddered_config`` fields for k in {1, 10, 100,
  1000}, ``plan_for_k(...).describe()`` (``k_ladder`` and fingerprint)
  and the scheduler's batches for one push/clock script are JAX's; a
  tenant pushed with its own ladder is promoted along it (JAX's is not).
- Tenant and filter isolation of cache entries and batches; a cache hit
  equals a miss bit for bit.
- ``repro_torch.launch.serve`` on the CPU writes a valid trace and
  metrics dump.
"""

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import build_index as jax_build_index
from repro.core import laddered_config as jax_laddered_config
from repro.core.docfilter import DocFilter as JaxDocFilter
from repro.data import make_corpus, make_queries
from repro.serving import AdmissionPolicy as JaxAdmission
from repro.serving import BatchPolicy as JaxBatchPolicy
from repro.serving import BucketScheduler as JaxScheduler
from repro.serving import DeadlineExceeded as JaxDeadline
from repro.serving import Overloaded as JaxOverloaded
from repro.serving import RetrievalServer as JaxServer
from repro.serving import query_key as jax_query_key
from repro.store import add_documents as jax_add
from repro.store import save_index as jax_save
from repro_torch import obs
from repro_torch.core import DocFilter, Retriever, WarpSearchConfig, laddered_config
from repro_torch.core.retriever import K_LADDER, ladder_rung
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (
    AdmissionPolicy,
    BatchPolicy,
    BucketScheduler,
    DeadlineExceeded,
    LRUCache,
    Overloaded,
    RetrievalServer,
    query_key,
)

torch.set_num_threads(1)  # xdist runs one test process per core

SEARCH = dict(nprobe=8, k=5, t_prime=400, layout="ragged", gather="fused", reduce_impl="scan")
TOL = dict(rtol=1e-4, atol=1e-4)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    obs.disable_all()
    jobs.disable_all()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    corpus = make_corpus(n_docs=200, mean_doc_len=12, seed=0)
    build = JaxBuildConfig(n_centroids=32, nbits=4, kmeans_iters=2)
    idx = jax_build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, build)
    store = str(tmp_path_factory.mktemp("subsystem") / "seg")
    jax_save(jax_build_index(corpus.emb[:1200], corpus.token_doc_ids[:1200],
                             int(corpus.token_doc_ids[1199]) + 1, build), store,
             build_config=build)
    extra = make_corpus(n_docs=30, mean_doc_len=10, seed=5)
    jax_add(store, extra.emb, extra.token_doc_ids, extra.n_docs)
    q, qmask, _ = make_queries(corpus, n_queries=8, tokens_per_query=(2, 24), seed=1)
    return dict(idx=idx, store=store, q=np.asarray(q), qmask=np.asarray(qmask))


# ---------------------------------------------------------------------------
# one scripted run on both servers
# ---------------------------------------------------------------------------


def _scripted_run(world, tmp_path, pkg):
    """Drive one server (``pkg`` "port" or "jax") through the script;
    returns (outcomes per submit, summary, the server)."""
    port = pkg == "port"
    store = os.path.join(str(tmp_path), pkg)
    shutil.copytree(world["store"], store)
    clock = FakeClock()
    if port:
        srv = RetrievalServer(
            Retriever.from_index(world["idx"], device="cpu"), WarpSearchConfig(**SEARCH),
            BatchPolicy(max_batch=3, max_wait_s=0.01, promote_after_s=0.03), clock,
            admission=AdmissionPolicy(max_queue_depth=5, rate_per_s=60.0, burst=4),
            cache_size=64,
        )
        srv.add_tenant("seg", store)
        filt, over, late = DocFilter, Overloaded, DeadlineExceeded
    else:
        srv = JaxServer(
            JaxRetriever.from_index(world["idx"]), JaxConfig(executor="reference", **SEARCH),
            JaxBatchPolicy(max_batch=3, max_wait_s=0.01, promote_after_s=0.03), clock,
            admission=JaxAdmission(max_queue_depth=5, rate_per_s=60.0, burst=4),
            cache_size=64,
        )
        srv.add_tenant("seg", store)
        filt, over, late = JaxDocFilter, JaxOverloaded, JaxDeadline
    q, qmask = world["q"], world["qmask"]
    rng = np.random.default_rng(7)
    pool = len(q)
    p = np.arange(1, pool + 1, dtype=np.float64) ** -1.6
    p /= p.sum()
    n_seg = srv._state("seg").retriever.n_docs
    allow = filt.allow(np.arange(0, n_seg, 2), n_seg)
    rids, overloaded = [], []
    for i in range(40):
        clock.t += float(rng.exponential(0.006))
        j = int(rng.choice(pool, p=p))
        tenant = "seg" if i % 3 == 2 else None
        kw = dict(tenant=tenant)
        if i % 4 == 1:
            kw["deadline_s"] = 0.004
        if tenant == "seg" and i % 2:
            kw["dfilter"] = allow
        try:
            rids.append((i, srv.submit(q[j], qmask[j], **kw)))
        except over:
            overloaded.append(i)
        if i % 3 == 0:
            srv.step()
        if i == 20:
            srv.delete_documents([1, 2, 3, 150, 201, 205], tenant="seg")
        if i == 30:
            srv.reload(Retriever.from_index(world["idx"], device="cpu") if port
                       else JaxRetriever.from_index(world["idx"]))
    clock.t += 1.0
    srv.drain()
    outcomes = {}
    for i, rid in rids:
        try:
            scores, ids = srv.poll(rid)
            outcomes[i] = ("ok", np.asarray(ids), np.asarray(scores))
        except late:
            outcomes[i] = ("deadline",)
    return outcomes, overloaded, srv.summary(), srv


def test_scripted_traffic_matches_jax(world, tmp_path):
    got, got_over, got_sum, srv = _scripted_run(world, tmp_path, "port")
    want, want_over, want_sum, _ = _scripted_run(world, tmp_path, "jax")
    assert got_over == want_over and got_over  # the gate shed some
    assert sorted(got) == sorted(want)
    late = [i for i, o in got.items() if o[0] == "deadline"]
    assert late == [i for i, o in want.items() if o[0] == "deadline"] and late
    for i, o in got.items():
        if o[0] == "ok":
            np.testing.assert_array_equal(o[1], want[i][1], err_msg=f"request {i}")
            np.testing.assert_allclose(o[2], want[i][2], **TOL)
            if i > 20 and i % 3 == 2:  # seg requests after the delete
                assert not np.isin(o[1], [1, 2, 3, 150, 201, 205]).any()
    for key in want_sum:
        assert got_sum[key] == want_sum[key], key
    assert got_sum["cache_hits"] > 0 and got_sum["reloads"] == 1 and got_sum["index_epoch"] == 2
    assert set(got_sum) - set(want_sum) == {"latency_p50_s", "latency_p95_s", "device"}
    assert srv.health()["status"] == "ok"


# ---------------------------------------------------------------------------
# pure functions and the scheduler
# ---------------------------------------------------------------------------


def test_query_key_hex_identical_to_jax():
    rng = np.random.default_rng(3)
    for trial in range(12):
        q = rng.standard_normal((16, 8)).astype(np.float32)
        m = rng.random(16) < 0.6
        n = 50
        ids = rng.choice(n, 20, replace=False)
        for f, jf in ((None, None), (DocFilter.allow(ids, n), JaxDocFilter.allow(ids, n)),
                      (DocFilter.tombstones(ids[:3], n), JaxDocFilter.tombstones(ids[:3], n))):
            for tenant in (None, "a", "b"):
                got = query_key(q, m, dfilter=f, tenant=tenant)
                assert got == jax_query_key(q, m, dfilter=jf, tenant=tenant)
    # Masked-row garbage does not change the key; tenant and filter do.
    q2 = q.copy()
    q2[~m] = 7.0
    assert query_key(q2, m) == query_key(q, m) != query_key(q, m, tenant="a")


@pytest.mark.parametrize("k", [1, 10, 100, 1000])
def test_laddered_config_matches_jax(k):
    assert ladder_rung(k)[0] == {1: "small", 10: "small", 100: "medium", 1000: "large"}[k]
    assert [r[:2] for r in K_LADDER] == [(10, "small"), (100, "medium"), (None, "large")]
    cases = [
        ({}, {}),
        ({"n_tokens": 10_000, "n_centroids": 40}, {}),
        ({"n_tokens": 10_000, "n_centroids": 1 << 17}, {"nprobe": 4, "k_impute": 9}),
        ({"n_tokens": 3}, {"t_prime_max": 2}),
    ]
    for geo, pinned in cases:
        got = laddered_config(k, WarpSearchConfig(**pinned), **geo)
        want = jax_laddered_config(k, JaxConfig(**pinned), **geo)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (geo, pinned)


@pytest.mark.parametrize("k", [1, 10, 100, 1000])
def test_plan_for_k_describe_matches_jax(world, k):
    got = Retriever.from_index(world["idx"], device="cpu").plan_for_k(
        k, WarpSearchConfig(layout="ragged", reduce_impl="scan")
    ).describe()
    want = JaxRetriever.from_index(world["idx"]).plan_for_k(
        k, JaxConfig(layout="ragged", reduce_impl="scan", executor="reference")
    ).describe()
    assert got["k_ladder"] == want["k_ladder"] == ladder_rung(k)[0]
    assert got == want  # the fingerprint too: cache keys agree across packages


class _Item:
    def __init__(self, name, arrival):
        self.name, self.arrival = name, arrival


def test_scheduler_batches_match_jax():
    out = []
    for sched_cls, policy_cls in ((BucketScheduler, BatchPolicy), (JaxScheduler, JaxBatchPolicy)):
        clock = FakeClock()
        sched = sched_cls(policy_cls(max_batch=3, max_wait_s=0.01, promote_after_s=0.03),
                          clock, rungs=(2, 4, 8, 16))
        rng = np.random.default_rng(11)
        log = []
        for i in range(60):
            clock.t += float(rng.exponential(0.004))
            group = [None, ("a", None), ("b", "d1")][int(rng.integers(3))]
            sched.push(_Item(i, clock.t), int(rng.choice([2, 4, 8, 16])), group=group)
            if i % 7 == 3:
                log.append(("reap", sorted(p.name for p in sched.reap(lambda p: p.name % 11 == 0))))
            got = sched.next_batch(force=(i % 13 == 12))
            if got is not None:
                log.append((got[0], [p.name for p in got[1]]))
        while len(sched):
            rung, items = sched.next_batch(force=True)
            log.append((rung, [p.name for p in items]))
        out.append((log, sched.stats, sched.occupancy(), sched.metrics.to_prometheus()))
    assert out[0] == out[1]
    assert out[0][1]["promoted"] > 0


def test_tenant_is_promoted_along_its_own_ladder():
    """A named group climbs the ladder it was pushed with; JAX's scheduler
    climbs the constructor's (the default tenant's) ladder only, so a rung
    of another ladder is never promoted there (ROADMAP queue 3)."""
    got = []
    for sched_cls, policy_cls, kw in ((BucketScheduler, BatchPolicy, {"rungs": (5, 10)}),
                                      (JaxScheduler, JaxBatchPolicy, {})):
        clock = FakeClock()
        sched = sched_cls(policy_cls(max_batch=3, max_wait_s=10.0, promote_after_s=0.03),
                          clock, rungs=(2, 4, 8, 16))
        sched.push(_Item("a", 0.0), 5, group=("t", None), **kw)
        sched.push(_Item("b", 0.0), 2)
        clock.t = 0.05
        got.append([(rung, [p.name for p in items]) for rung, items in
                    (sched.next_batch(force=True), sched.next_batch(force=True))])
    assert sorted(got[0]) == [(4, ["b"]), (10, ["a"])]
    assert sorted(got[1]) == [(4, ["b"]), (5, ["a"])]


def test_lru_cache_purges_dead_epochs():
    reg = obs.MetricsRegistry()
    c = LRUCache(2, registry=reg, name="result")
    c.put(("a", "f", 0), 1)
    c.put(("b", "f", 1), 2)
    assert c.get(("a", "f", 0)) == 1 and c.get(("z", "f", 1)) is None
    c.put(("c", "f", 1), 3)  # evicts the coldest: b
    assert ("b", "f", 1) not in c and len(c) == 2
    assert c.purge_epochs_below(1) == 1 and len(c) == 1
    assert c.stats() == {"size": 1, "capacity": 2, "hits": 1, "misses": 1, "hit_rate": 0.5}
    assert 'serving_cache_size{cache="result"} 1' in reg.to_prometheus()
    with pytest.raises(ValueError):
        LRUCache(0)


# ---------------------------------------------------------------------------
# isolation and the cache
# ---------------------------------------------------------------------------


def test_tenant_and_filter_isolation(world, tmp_path):
    q, qmask = world["q"], world["qmask"]
    store = os.path.join(str(tmp_path), "seg")
    shutil.copytree(world["store"], store)
    srv = RetrievalServer(
        Retriever.from_index(world["idx"], device="cpu"), WarpSearchConfig(**SEARCH),
        BatchPolicy(max_batch=4, max_wait_s=10.0), FakeClock(), cache_size=64,
    )
    srv.add_tenant("seg", store)
    n_seg = srv._state("seg").retriever.n_docs
    allow = DocFilter.allow(np.arange(0, n_seg, 3), n_seg)
    batches = []
    inner = srv.scheduler.next_batch

    def spy(**kw):
        got = inner(**kw)
        if got is not None:
            batches.append({p.group for p in got[1]})
        return got

    srv.scheduler.next_batch = spy
    routes = [(None, None), ("seg", None), ("seg", allow)] * 3
    rids = [srv.submit(q[i % 3], qmask[i % 3], tenant=t, dfilter=f) for i, (t, f) in enumerate(routes)]
    srv.drain()
    assert batches and all(len(g) == 1 for g in batches)  # no batch crosses a group
    replies = [srv.poll(r) for r in rids]
    keys = {k[0] for k in srv.result_cache._d}
    assert len(keys) == 3  # query 0/1/2 under three routes: 9 requests, distinct keys
    for (t, f), (_, ids), i in zip(routes, replies, range(len(rids))):
        state = srv._state(t)
        want = state.retriever.plan(state.requested_config, dfilter=f).retrieve(q[i % 3], qmask[i % 3])
        np.testing.assert_array_equal(ids, want.doc_ids.numpy())
        if f is not None:
            assert allow.survivor_mask[ids[ids >= 0]].all()
    # The default tenant's cached entry never answers the seg tenant.
    hits0 = srv.stats["cache_hits"]
    srv.submit(q[0], qmask[0], tenant="seg", dfilter=DocFilter.allow([1, 2], n_seg))
    assert srv.stats["cache_hits"] == hits0 and len(srv.scheduler) == 1


def test_cache_hit_equals_miss_bit_for_bit(world):
    q, qmask = world["q"], world["qmask"]
    r = Retriever.from_index(world["idx"], device="cpu")
    warm = RetrievalServer(r, WarpSearchConfig(**SEARCH), BatchPolicy(max_batch=4), FakeClock(), cache_size=64)
    cold = RetrievalServer(r, WarpSearchConfig(**SEARCH), BatchPolicy(max_batch=4), FakeClock(), cache_size=0)
    for i in range(4):
        warm.result(warm.submit(q[i], qmask[i]))
        hs, hd = warm.poll(warm.submit(q[i], qmask[i]))  # completed at submit
        ms, md = cold.result(cold.submit(q[i], qmask[i]))
        assert np.array_equal(hd, md) and np.array_equal(hs, ms)
    assert warm.result_cache.stats()["hits"] == 4
    warm.reload(r)
    warm.submit(q[0], qmask[0])
    assert warm.result_cache.stats()["hits"] == 4  # epoch bumped: a miss


def test_sharded_index_is_refused():
    class Sharded:
        n_shards = 2

    with pytest.raises(NotImplementedError, match="item 10"):
        RetrievalServer(Sharded(), device="cpu")
    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--n-shards", "2"])


# ---------------------------------------------------------------------------
# the serve launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dump", ["metrics.prom", "metrics.json"])
def test_serve_launcher_writes_trace_and_metrics(tmp_path, capsys, dump):
    trace, metrics = tmp_path / "trace.json", tmp_path / dump
    rc = serve_cli.main([
        "--device", "cpu", "--n-docs", "120", "--traffic", "poisson", "--duration-s", "1",
        "--tenants", "2", "--layout", "ragged", "--gather", "fused", "--deadline-ms", "50",
        "--trace-out", str(trace), "--metrics-dump", str(metrics), "--metrics-interval-s", "0.5",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "health: ok" in out and "served=" in out
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"submit", "queue_wait", "batch_dispatch", "retrieve", "warp_select",
            "gather_score", "reduce", "reply"} <= names
    assert all(e["ph"] in ("X", "i") and e["ts"] >= 0 for e in events)
    if dump.endswith(".json"):
        snap = json.loads(metrics.read_text())
        assert snap["serving_requests_served_total"]["series"][0]["value"] > 0
        assert {"serving_tenant_served_total", "warp_retrieve_seconds"} <= set(snap)
    else:
        sample = re.compile(r'^[a-z_]+(\{[a-z_]+="[^"]*"(,[a-z_]+="[^"]*")*\})? [-+0-9.e]+$')
        lines = metrics.read_text().splitlines()
        assert lines and all(ln.startswith("# ") or sample.match(ln) for ln in lines), lines
        assert any(ln.startswith('serving_tenant_served_total{tenant="t1"}') for ln in lines)
    # The launcher leaves the process at the disabled default.
    assert obs.STATE.tracer is None and obs.STATE.metrics is None
