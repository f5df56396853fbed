"""The port's observability (``repro_torch.obs``) against the JAX package's
``repro.obs`` on the same scripted inputs.

- Metrics: the Prometheus text and the JSON snapshot are identical for
  one scripted sequence of counter / gauge / histogram operations;
  ``percentiles``, ``time_fn`` and ``Histogram.quantile`` agree.
- Tracing: ``span_tree`` and the Chrome export are equal under a fake
  clock; the ring buffer keeps the newest spans and counts ``dropped``.
- The traced retrieve is bit-identical to the untraced one (dense,
  adaptive ragged, forced rung, filtered, segmented), its doc ids equal
  JAX's traced retrieve, and its spans have JAX's names, order and
  attributes; metrics-only mode counts retrieves without stage spans.
- The server's request lifecycle shows as spans on one injected clock.
"""

import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import build_index as jax_build_index
from repro.core.docfilter import DocFilter as JaxDocFilter
from repro.data import make_corpus, make_queries
from repro_torch import obs
from repro_torch.core import DocFilter, Retriever, WarpSearchConfig
from repro_torch.serving import BatchPolicy, RetrievalServer

torch.set_num_threads(1)  # xdist runs one test process per core

SEARCH = dict(nprobe=8, k=5, t_prime=400, reduce_impl="scan")
CONFIGS = {
    "dense": dict(layout="dense", gather="fused"),
    "ragged": dict(layout="ragged", gather="fused"),
    "ragged_materialize": dict(layout="ragged", gather="materialize"),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt=1.0):
        self.t += dt
        return self.t


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable_all()
    jobs.disable_all()
    yield
    obs.disable_all()
    jobs.disable_all()


@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus(n_docs=250, mean_doc_len=12, seed=0)
    idx = jax_build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs,
        JaxBuildConfig(n_centroids=64, nbits=4, kmeans_iters=3),
    )
    q, qmask, _ = make_queries(corpus, n_queries=6, tokens_per_query=(2, 24), seed=1)
    return dict(
        idx=idx, q=np.asarray(q), qmask=np.asarray(qmask),
        jr=JaxRetriever.from_index(idx), port=Retriever.from_index(idx, device="cpu"),
    )


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _script(pkg):
    """One sequence of registry operations, run against either package."""
    reg = pkg.MetricsRegistry()
    reg.counter("req_total", "Requests", kind="s").inc(3)
    reg.counter("req_total", kind="b").inc(0.5)
    reg.counter("esc_total", "Escapes", path='a"b\\c\nd').inc()
    g = reg.gauge("depth", "Queue depth")
    g.set(2)
    g.inc(3)
    g.dec(0.25)
    h = reg.histogram("lat_seconds", "Latency", buckets=(0.1, 1.0), stage="x")
    for v in (0.05, 0.5, 5.0, 0.1, 1e-7, 2.5e-4):
        h.observe(v)
    d = reg.histogram("serving_dispatch_seconds", "Batch dispatch latency")
    for v in np.random.default_rng(0).exponential(0.01, 50):
        d.observe(float(v))
    reg.gauge("frac").set(1 / 3)
    return reg


def test_prometheus_text_and_snapshot_identical_to_jax():
    got, want = _script(obs), _script(jobs)
    assert got.to_prometheus() == want.to_prometheus()
    assert json.dumps(got.snapshot(), sort_keys=True) == json.dumps(want.snapshot(), sort_keys=True)
    for name in ("lat_seconds", "serving_dispatch_seconds"):
        (hg,), (hw,) = got.series(name), want.series(name)
        for q in (0.0, 0.25, 0.5, 0.9, 0.99, 1.0):
            assert hg.quantile(q) == hw.quantile(q)
    assert obs.MetricsRegistry().to_prometheus() == jobs.MetricsRegistry().to_prometheus() == ""


def test_percentiles_and_time_fn_match_jax():
    xs = np.random.default_rng(1).lognormal(size=101)
    assert obs.percentiles(xs) == jobs.percentiles(xs)
    assert obs.percentiles([]) == (0.0, 0.0, 0.0)
    for pkg in (obs, jobs):
        clock = FakeClock()
        synced = []

        def fn():
            clock.tick(0.25)
            return "out"

        assert pkg.time_fn(fn, warmup=1, iters=3, clock=clock, sync=synced.append) == 0.25
        assert synced == ["out"] * 4


def test_registry_kind_clash_raises():
    reg = obs.MetricsRegistry()
    reg.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total").inc(-1)


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------


def _trace(pkg):
    clock = FakeClock()
    tr = pkg.Tracer(clock=clock, pid=7)
    with tr.span("root", kind="r"):
        clock.tick()
        with tr.span("a"):
            clock.tick(0.5)
            tr.instant("mark", n=1)
        with tr.span("b") as sp:
            sp.set(extra=1)
            clock.tick(2.0)
    tr.add_event("wait", 0.25, 0.5, tid=42, rung=8)
    return tr


def _shape(nodes):
    return [
        (n["span"].name, n["span"].ts, n["span"].dur, n["span"].args, _shape(n["children"]))
        for n in nodes
    ]


def test_span_tree_and_chrome_export_equal_under_fake_clock():
    got, want = _trace(obs), _trace(jobs)
    tid = next(s.tid for s in got.events() if s.name == "root")
    assert _shape(obs.span_tree(got.events(), tid=tid)) == _shape(
        jobs.span_tree(want.events(), tid=tid)
    )
    assert _shape(obs.span_tree(got.events(), tid=tid)) == [
        ("root", 0.0, 3.5, {"kind": "r"}, [
            ("a", 1.0, 0.5, {}, []), ("b", 1.5, 2.0, {"extra": 1}, []),
        ]),
    ]
    assert got.to_chrome() == want.to_chrome()


@pytest.mark.parametrize("capacity", [1, 4])
def test_ring_capacity_and_dropped(capacity):
    for pkg in (obs, jobs):
        tr = pkg.Tracer(clock=FakeClock(), capacity=capacity)
        for i in range(10):
            tr.instant(f"e{i}")
        assert [s.name for s in tr.events()] == [f"e{i}" for i in range(10 - capacity, 10)]
        assert tr.dropped == 10 - capacity
        tr.clear()
        assert tr.events() == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        obs.Tracer(capacity=0)


def test_disabled_state_is_the_shared_null_span():
    assert obs.span("x") is obs.span("y", a=1) is obs.NULL_SPAN
    assert obs.tracer() is obs.NULL_TRACER and obs.tracer().events() == []
    assert obs.STATE.metrics is None and obs.STATE.tracer is None
    assert not hasattr(obs, "set_kernel_probes")  # not ported (no carve-outs)


# ---------------------------------------------------------------------------
# the traced retrieve
# ---------------------------------------------------------------------------


def _equal(a, b):
    assert torch.equal(a.doc_ids, b.doc_ids) and torch.equal(a.scores, b.scores)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_traced_retrieve_bit_identical_and_equal_to_jax(setup, name):
    q, qmask = setup["q"], setup["qmask"]
    plan = setup["port"].plan(WarpSearchConfig(**SEARCH, **CONFIGS[name]))
    base = [plan.retrieve(q[i], qmask[i]) for i in range(4)]
    base_b = plan.retrieve_batch(q[:4], qmask[:4])
    obs.set_tracer(obs.Tracer())
    traced = [plan.retrieve(q[i], qmask[i]) for i in range(4)]
    traced_b = plan.retrieve_batch(q[:4], qmask[:4])
    for a, b in zip(base, traced):
        _equal(a, b)
    _equal(base_b, traced_b)

    jplan = setup["jr"].plan(JaxConfig(executor="reference", **SEARCH, **CONFIGS[name]))
    jobs.set_tracer(jobs.Tracer())
    for i in range(4):
        want = jplan.retrieve(q[i], qmask[i])
        np.testing.assert_array_equal(traced[i].doc_ids.numpy(), np.asarray(want.doc_ids))
        np.testing.assert_allclose(
            traced[i].scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4
        )


def _stage_spans(pkg, tracer):
    tree = pkg.span_tree(tracer.events())
    assert [n["span"].name for n in tree] == ["retrieve"]
    return tree[0]


@pytest.mark.parametrize("name", ["dense", "ragged"])
def test_span_names_order_and_attributes_match_jax(setup, name):
    q, qmask = setup["q"], setup["qmask"]
    plan = setup["port"].plan(WarpSearchConfig(**SEARCH, **CONFIGS[name]))
    jplan = setup["jr"].plan(JaxConfig(executor="reference", **SEARCH, **CONFIGS[name]))
    jplan.retrieve(q[0], qmask[0])  # compile untraced first
    got = obs.set_tracer(obs.Tracer())
    plan.retrieve(q[0], qmask[0])
    want = jobs.set_tracer(jobs.Tracer())
    jplan.retrieve(q[0], qmask[0])
    g, w = _stage_spans(obs, got), _stage_spans(jobs, want)
    assert g["span"].args == w["span"].args
    kids = [c["span"].name for c in g["children"]]
    assert kids == [c["span"].name for c in w["children"]]
    assert kids == (
        ["warp_select", "bucket_pick", "gather_score", "reduce"] if name == "ragged"
        else ["warp_select", "gather_score", "reduce"]
    )
    for gc, wc in zip(g["children"], w["children"]):
        assert gc["span"].args == wc["span"].args, gc["span"].name
        assert gc["span"].ts >= g["span"].ts and gc["span"].end <= g["span"].end + 1e-9


def test_traced_forced_rung_and_filtered_plan(setup):
    q, qmask = setup["q"], setup["qmask"]
    r = setup["port"]
    plan = r.plan(WarpSearchConfig(**SEARCH, **CONFIGS["ragged"]))
    rung = plan.config.worklist_buckets[-1]
    allow = DocFilter.allow(np.arange(0, r.n_docs, 3), r.n_docs)
    fplan = r.plan(WarpSearchConfig(**SEARCH, **CONFIGS["ragged"]), dfilter=allow)
    base = plan.retrieve_batch_at(q[:3], qmask[:3], bucket=rung)
    fbase = fplan.retrieve_batch(q[:3], qmask[:3])
    tr = obs.set_tracer(obs.Tracer())
    _equal(base, plan.retrieve_batch_at(q[:3], qmask[:3], bucket=rung))
    names = [s.name for s in tr.events()]
    assert "bucket_pick" not in names  # the rung came from the caller
    assert {"warp_select", "gather_score", "reduce"} <= set(names)
    traced = fplan.retrieve_batch(q[:3], qmask[:3])
    _equal(fbase, traced)
    assert np.isin(traced.doc_ids.numpy(), np.arange(0, r.n_docs, 3)).all()
    jplan = setup["jr"].plan(
        JaxConfig(executor="reference", **SEARCH, **CONFIGS["ragged"]),
        dfilter=JaxDocFilter.allow(np.arange(0, r.n_docs, 3), r.n_docs),
    )
    np.testing.assert_array_equal(
        traced.doc_ids.numpy(), np.asarray(jplan.retrieve_batch(q[:3], qmask[:3]).doc_ids)
    )


def test_metrics_only_counts_retrieves(setup):
    q, qmask = setup["q"], setup["qmask"]
    plan = setup["port"].plan(WarpSearchConfig(**SEARCH, **CONFIGS["ragged"]))
    jplan = setup["jr"].plan(JaxConfig(executor="reference", **SEARCH, **CONFIGS["ragged"]))
    got = obs.enable_metrics(obs.MetricsRegistry())
    want = jobs.enable_metrics(jobs.MetricsRegistry())
    for p in (plan, jplan):
        for i in range(3):
            p.retrieve(q[i], qmask[i])
        p.retrieve_batch(q[:2], qmask[:2])
        p.retrieve_batch_at(q[:2], qmask[:2], bucket=p.config.worklist_buckets[-1])
    assert got.counter("warp_retrieves_total", kind="single").value == 3
    assert got.counter("warp_retrieves_total", kind="batch").value == 1
    h = got.histogram("warp_retrieve_seconds", kind="single")
    assert h.count == 3 and h.sum > 0
    assert got.series("warp_stage_seconds") == []  # no fences, no stage spans

    def series(reg):
        return sorted(
            (m.name, m.labels, getattr(m, "count", None), getattr(m, "value", None)
             if m.kind == "counter" else None)
            for m in reg.metrics()
        )

    assert series(got) == series(want)
    obs.set_tracer(obs.Tracer())
    plan.retrieve(q[0], qmask[0])
    stages = {dict(m.labels)["stage"] for m in got.series("warp_stage_seconds")}
    assert stages == {"warp_select", "gather_score", "reduce"}  # JAX's: no bucket_pick histogram


def test_segmented_plan_traces_as_one_engine_span(setup, tmp_path):
    from repro.data import make_corpus as jax_corpus
    from repro.store import add_documents as jax_add
    from repro.store import save_index as jax_save
    from repro_torch.store import load_index

    path = str(tmp_path / "s")
    jax_save(setup["idx"], path)
    extra = jax_corpus(n_docs=30, mean_doc_len=10, seed=5)
    jax_add(path, extra.emb, extra.token_doc_ids, extra.n_docs)
    r = Retriever.from_index(load_index(path, device="cpu"), device="cpu")
    assert r.is_segmented
    plan = r.plan(WarpSearchConfig(**SEARCH, **CONFIGS["ragged"]))
    q, qmask = setup["q"], setup["qmask"]
    base = plan.retrieve(q[0], qmask[0])
    tr = obs.set_tracer(obs.Tracer())
    _equal(base, plan.retrieve(q[0], qmask[0]))
    (root,) = obs.span_tree(tr.events())
    assert root["span"].name == "retrieve" and root["span"].args["staged"] is False
    assert [c["span"].name for c in root["children"]] == ["engine"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_server_lifecycle_spans_on_one_clock(setup):
    q, qmask = setup["q"], setup["qmask"]
    clock = FakeClock()
    server = RetrievalServer(
        setup["port"], WarpSearchConfig(**SEARCH, **CONFIGS["ragged"]),
        BatchPolicy(max_batch=2, max_wait_s=10.0), clock,
    )
    tr = obs.set_tracer(obs.Tracer(clock=clock))
    r0 = server.submit(q[0], qmask[0])
    clock.tick(0.5)
    r1 = server.submit(q[1], qmask[1])
    clock.tick(0.25)
    assert server.step(force=True) == 2
    names = [s.name for s in tr.events()]
    for name in ("submit", "rung_prepass", "queue_wait", "batch_dispatch", "retrieve",
                 "warp_select", "gather_score", "reduce", "reply"):
        assert name in names, (name, names)
    waits = {s.tid: s for s in tr.events() if s.name == "queue_wait"}
    assert set(waits) == {r0, r1}
    assert waits[r0].dur == pytest.approx(0.75) and waits[r1].dur == pytest.approx(0.25)
    assert waits[r0].end == pytest.approx(0.75)
    disp = next(s for s in tr.events() if s.name == "batch_dispatch")
    assert disp.args["batch_size"] == 2 and sorted(disp.args["rids"]) == [r0, r1]
    for rid in (r0, r1):
        want = server.plan.retrieve(q[rid], qmask[rid])
        np.testing.assert_array_equal(server.poll(rid)[1], want.doc_ids.numpy())


def test_server_stats_and_private_registry(setup):
    q, qmask = setup["q"], setup["qmask"]
    cfg = WarpSearchConfig(**SEARCH, **CONFIGS["ragged"])
    server = RetrievalServer(setup["port"], cfg, BatchPolicy(max_batch=4, max_wait_s=10.0), FakeClock())
    for i in range(3):
        server.submit(q[i], qmask[i])
    server.drain()
    st = server.stats
    assert st["served"] == 3 and st["batches"] >= 1
    assert set(st) == {"batches", "padded_slots", "served", "reloads", "cache_hits",
                       "compactions", "deadline_shed", "maintain_retries"}
    text = server.metrics.to_prometheus()
    assert "serving_requests_served_total 3" in text
    assert "serving_queue_wait_seconds_count" in text
    other = RetrievalServer(setup["port"], cfg, BatchPolicy(max_batch=4, max_wait_s=10.0), FakeClock())
    assert other.stats["served"] == 0
