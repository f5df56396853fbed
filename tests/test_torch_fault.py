"""The port's fault injection (``repro_torch.fault``) against the JAX
package's ``repro.fault``, on a store the JAX package built (base + two
delta segments).

- Plans: scripted and seeded plans fire at the same hits in both
  packages, on synthetic site streams and on the store loader's own
  consults (``store.array_read`` / ``manifest_parse`` / ``segment_load``).
- The store: a corrupt or faulted delta is quarantined with doc ids kept;
  each of the five ``store.compact_step`` kill points recovers to a store
  whose files equal JAX's after the same kill; a stale lock is taken over
  and counted.
- The server: failed reloads leave it intact; ``maintain`` backs off;
  deadlines shed once; ``engine.kernel_call`` raises out of ``retrieve``
  and out of ``step`` — each member's ``poll`` raises once and nothing is
  answered by a plain path (the port has no executor fallback).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from repro import fault as jfault
from repro import obs as jobs
from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import build_index as jax_build_index
from repro.data import make_corpus, make_queries
from repro.store import add_documents as jax_add
from repro.store import compact as jax_compact
from repro.store import delete_documents as jax_delete
from repro.store import load_index as jax_load_index
from repro.store import recover_interrupted_compact as jax_recover
from repro.store import save_index as jax_save
from repro_torch import fault, obs
from repro_torch.core import Retriever, WarpSearchConfig
from repro_torch.fault import FaultPlan, FaultRule, InjectedFault
from repro_torch.serving import (
    BatchPolicy,
    CompactionPolicy,
    DeadlineExceeded,
    ResultAlreadyTaken,
    RetrievalServer,
)
from repro_torch.store import (
    StoreCorruption,
    compact,
    load_index,
    verify_store,
)
from repro_torch.store.format import compact_lock_path, recover_interrupted_compact

torch.set_num_threads(1)  # xdist runs one test process per core

BUILD = JaxBuildConfig(n_centroids=16, nbits=4, kmeans_iters=2)
CFG = WarpSearchConfig(nprobe=8, k=5, layout="ragged", gather="fused", reduce_impl="scan")
STEPS = ["load", "arrays", "finalized", "old_aside", "promoted"]
DELETED = (3, 57, 111, 140)  # base and delta docs


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _no_leaked_state():
    yield
    assert fault.FAULTS.plan is None and jfault.FAULTS.plan is None, "a test leaked a FaultPlan"
    obs.disable_all()
    jobs.disable_all()


@pytest.fixture(scope="module")
def base_store(tmp_path_factory):
    """A JAX-written store: base (100 docs) + two delta segments (30 each)."""
    corpus = make_corpus(n_docs=100, mean_doc_len=10, seed=11)
    path = str(tmp_path_factory.mktemp("faultstore") / "idx")
    idx = jax_build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, BUILD)
    jax_save(idx, path, build_config=BUILD)
    for seed in (12, 13):
        c = make_corpus(n_docs=30, mean_doc_len=10, seed=seed)
        jax_add(path, c.emb, c.token_doc_ids, c.n_docs)
    q, qmask, _ = make_queries(corpus, n_queries=6, tokens_per_query=(2, 16), seed=21)
    return dict(path=path, q=np.asarray(q), qmask=np.asarray(qmask))


def copy_store(src, dst_dir, name="idx"):
    dst = os.path.join(str(dst_dir), name)
    shutil.copytree(src, dst)
    return dst


def flip_byte(file_path, offset):
    with open(file_path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def store_files(path) -> dict:
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, path)] = f.read()
    return out


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plans_fire_at_the_same_hits_as_jax(seed):
    assert fault.SITES == jfault.SITES
    rules = [FaultRule("store.array_read", at=3, times=2), FaultRule("server.reload", at=1)]
    jrules = [jfault.FaultRule(r.site, at=r.at, times=r.times) for r in rules]
    rates = {"store.array_read": 0.2, "engine.kernel_call": 0.35, "store.compact_step": 0.5}
    plans = (FaultPlan(rules, seed=seed, rates=rates), jfault.FaultPlan(jrules, seed=seed, rates=rates))
    sites = np.random.default_rng(seed).choice(fault.SITES, 300)
    fired = ([], [])
    for k, (plan, err) in enumerate(zip(plans, (InjectedFault, jfault.InjectedFault))):
        for i, site in enumerate(sites):
            try:
                plan.check(str(site), i=i)
            except err as e:
                fired[k].append((i, str(e)))
    assert fired[0] == fired[1] and fired[0]
    assert plans[0].hits == plans[1].hits and plans[0].fired == plans[1].fired


def test_custom_errors_and_scoped_install():
    plan = FaultPlan([FaultRule("store.array_read", error=OSError("disk")),
                      FaultRule("server.reload", error=ValueError)])
    with fault.active(plan) as p:
        assert fault.FAULTS.plan is p
        with pytest.raises(OSError, match="disk"):
            fault.check("store.array_read")
        with pytest.raises(ValueError):
            fault.check("server.reload")
        fault.check("server.reload")  # hit 1: past the rule
    assert fault.FAULTS.plan is None
    fault.install(plan)
    fault.uninstall()
    fault.check("store.array_read")  # disabled: nothing fires


@pytest.mark.parametrize("seed", [3, 4])
def test_seeded_store_plans_fire_at_the_same_loader_calls_as_jax(base_store, seed):
    rates = {"store.array_read": 0.08, "store.manifest_parse": 0.08, "store.segment_load": 0.25}
    plan, jplan = FaultPlan(seed=seed, rates=rates), jfault.FaultPlan(seed=seed, rates=rates)

    def outcomes(load, corrupt, active, p):
        out = []
        with active(p):
            for _ in range(8):
                try:
                    idx = load()
                    out.append(("ok", tuple(getattr(idx, "quarantined", ())), idx.n_docs))
                except corrupt as e:
                    out.append(("corrupt", os.path.basename(str(e).split(":")[0])))
        return out

    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = outcomes(
            lambda: load_index(base_store["path"], device="cpu", quarantine_segments=True),
            StoreCorruption, fault.active, plan,
        )
        from repro.store import StoreCorruption as JaxCorruption

        want = outcomes(
            lambda: jax_load_index(base_store["path"], quarantine_segments=True),
            JaxCorruption, jfault.active, jplan,
        )
    assert got == want
    assert dict(plan.hits) == dict(jplan.hits) and dict(plan.fired) == dict(jplan.fired)
    assert sum(plan.fired.values()) > 0


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["flipped byte", "segment_load fault"])
def test_quarantine_keeps_doc_ids(base_store, tmp_path, how):
    path = copy_store(base_store["path"], tmp_path)
    clean = load_index(path, device="cpu")
    seg_root = os.path.join(path, "segments")
    first = sorted(os.listdir(seg_root))[0]
    plan = None
    if how == "flipped byte":
        flip_byte(os.path.join(seg_root, first, "arrays", "packed_codes.bin"), 10)
        with pytest.raises(StoreCorruption):
            load_index(path, device="cpu")
    else:
        plan = FaultPlan([FaultRule("store.segment_load", at=0)])
    reg = obs.enable_metrics(obs.MetricsRegistry())
    with fault.active(plan) if plan else fault.active(None):
        with pytest.warns(UserWarning, match="quarantin"):
            idx = load_index(path, device="cpu", quarantine_segments=True)
    with jfault.active(
        jfault.FaultPlan([jfault.FaultRule("store.segment_load", at=0)]) if plan else None
    ):
        with pytest.warns(UserWarning, match="quarantin"):
            jidx = jax_load_index(path, quarantine_segments=True)
    assert idx.quarantined == jidx.quarantined == (first,)
    assert idx.n_docs == jidx.n_docs == clean.n_docs
    assert idx.doc_starts == tuple(jidx.doc_starts) == (0, 130)
    assert reg.counter("store_segments_quarantined_total").value == 1
    q, qmask = base_store["q"], base_store["qmask"]
    from repro.core import Retriever as JaxRetriever
    from repro.core import WarpSearchConfig as JaxConfig

    got = Retriever.from_index(idx, device="cpu").plan(CFG).retrieve_batch(q, qmask)
    want = JaxRetriever.from_index(jidx).plan(
        JaxConfig(nprobe=8, k=5, layout="ragged", gather="fused", reduce_impl="scan",
                  executor="reference")
    ).retrieve_batch(q, qmask)
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    assert not np.isin(got.doc_ids.numpy(), np.arange(100, 130)).any()


@pytest.mark.parametrize("at", range(5), ids=STEPS)
def test_compact_kill_point_recovers_to_jax_store(base_store, tmp_path, at):
    path = copy_store(base_store["path"], tmp_path, "port")
    jpath = copy_store(base_store["path"], tmp_path, "jax")
    n_docs = load_index(path, device="cpu").n_docs
    jax_delete(jpath, DELETED)
    jax_delete(path, DELETED)
    plan = FaultPlan([FaultRule("store.compact_step", at=at)])
    with fault.active(plan):
        with pytest.raises(InjectedFault):
            compact(path)
    assert plan.fired["store.compact_step"] == 1 and plan.hits["store.compact_step"] == at + 1
    with jfault.active(jfault.FaultPlan([jfault.FaultRule("store.compact_step", at=at)])):
        with pytest.raises(jfault.InjectedFault):
            jax_compact(jpath)
    recover_interrupted_compact(path)
    jax_recover(jpath)
    assert store_files(path) == store_files(jpath)
    assert os.path.exists(path) and not os.path.exists(compact_lock_path(path))
    promoted = not os.path.isdir(os.path.join(path, "segments"))
    # Old XOR new: rolled back before the old base went aside, promoted after.
    assert promoted == (at >= 3)
    verify_store(path)
    assert load_index(path, device="cpu").n_docs == n_docs
    compact(path)  # a re-run completes the job
    jax_compact(jpath)
    assert store_files(path) == store_files(jpath)


def test_store_metrics_match_jax(base_store, tmp_path):
    """save -> add -> load -> delete -> delta_stats -> compact records the
    JAX package's store series with the same labels, counts and values
    (durations aside). ``store_load_seconds`` counts one load fewer: the
    port's ``add_documents`` reads only the base's codec arrays, JAX's
    loads the whole base."""
    from repro.store import delta_stats as jax_delta_stats
    from repro_torch.core import WarpIndex
    from repro_torch.store import add_documents, delete_documents, delta_stats, save_index

    base = jax_load_index(base_store["path"], with_segments=False)
    extra = make_corpus(n_docs=20, mean_doc_len=8, seed=17)

    def run(reg, save, add, load, delete, stats, comp, path):
        save(path)
        add(path, extra.emb, extra.token_doc_ids, extra.n_docs)
        load(path)
        delete(path, DELETED)
        stats(path)
        comp(path)
        return {
            (m.name, m.labels, m.kind): (m.count if m.kind == "histogram" else m.value)
            for m in reg.metrics()
        }

    got = run(
        obs.enable_metrics(obs.MetricsRegistry()),
        lambda p: save_index(WarpIndex.from_arrays(base, device="cpu"), p),
        lambda *a: add_documents(*a, device="cpu"),
        lambda p: load_index(p, device="cpu"), delete_documents, delta_stats, compact,
        str(tmp_path / "port"),
    )
    want = run(
        jobs.enable_metrics(jobs.MetricsRegistry()),
        lambda p: jax_save(base, p), jax_add, jax_load_index, jax_delete, jax_delta_stats,
        jax_compact, str(tmp_path / "jax"),
    )
    load_key = ("store_load_seconds", (), "histogram")
    assert got.pop(load_key) == 2 and want.pop(load_key) == 3
    assert got == want
    assert {k[0] for k in got} == {
        "store_save_seconds", "store_add_documents_seconds", "store_documents_added_total",
        "store_documents_deleted_total", "store_tombstones", "store_delta_segments",
        "store_delta_tokens", "store_delta_token_frac", "store_compact_seconds",
    }


def test_stale_lock_takeover_is_counted(base_store, tmp_path):
    path = copy_store(base_store["path"], tmp_path)
    lock = compact_lock_path(path)
    with open(lock, "w") as f:
        f.write("0")  # pid 0 is never alive: stale by construction
    reg = obs.enable_metrics(obs.MetricsRegistry())
    compact(path)
    assert reg.counter("store_lock_takeovers_total").value == 1
    assert reg.histogram("store_compact_seconds").count == 1
    assert not os.path.exists(lock)
    verify_store(path)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


def _server(path, clock, **kw):
    return RetrievalServer(
        Retriever.from_store(path, device="cpu"), CFG,
        BatchPolicy(max_batch=4, max_wait_s=1.0), clock, store_path=path, **kw,
    )


def test_failed_reload_leaves_server_intact(base_store, tmp_path):
    q, qmask = base_store["q"], base_store["qmask"]
    path = copy_store(base_store["path"], tmp_path)
    srv = _server(path, FakeClock())
    r0 = srv.submit(q[0], qmask[0])
    srv.drain()
    srv.poll(r0)
    before = (srv.index_epoch, srv._fingerprint, srv._requested_config, srv.retriever,
              len(srv.result_cache), srv.store_path)
    rid = srv.submit(q[1], qmask[1])  # queued across the failed reloads

    with pytest.raises(FileNotFoundError):
        srv.reload(str(tmp_path / "no-such-store"))
    bad = tmp_path / "broken-store"
    bad.mkdir()
    (bad / "MANIFEST.json").write_text("{not json")
    with pytest.raises(StoreCorruption):
        srv.reload(str(bad))
    with fault.active(FaultPlan([FaultRule("server.reload")])):
        with pytest.raises(InjectedFault):
            srv.reload(path)
    with fault.active(FaultPlan([FaultRule("store.manifest_parse")])):
        with pytest.raises(StoreCorruption):
            srv.reload(path)
    with fault.active(FaultPlan([FaultRule("engine.kernel_call")])):
        with pytest.raises(InjectedFault):  # the new plan's warmup
            srv.reload(path)

    assert (srv.index_epoch, srv._fingerprint, srv._requested_config, srv.retriever,
            len(srv.result_cache), srv.store_path) == before
    assert srv.retriever is before[3] and len(srv.scheduler) == 1
    srv.drain()
    scores, docs = srv.poll(rid)
    np.testing.assert_array_equal(docs, srv.plan.retrieve(q[1], qmask[1]).doc_ids.numpy())
    srv.reload(path)
    assert srv.index_epoch == before[0] + 1 and len(srv.result_cache) == 0


def test_reload_quarantines_a_faulted_segment_and_reports_degraded(base_store, tmp_path):
    path = copy_store(base_store["path"], tmp_path)
    srv = _server(path, FakeClock())
    assert srv.health()["status"] == "ok"
    with fault.active(FaultPlan([FaultRule("store.segment_load", at=1)])):
        with pytest.warns(UserWarning, match="quarantin"):
            srv.reload(path)
    h = srv.health()
    assert h["status"] == "degraded" and h["quarantined_segments"] == ["seg_00001"]
    assert any("quarantined" in r for r in h["reasons"])
    assert srv.metrics.gauge("serving_health_status").value == 1


def test_maintain_backs_off_and_keeps_serving(base_store, tmp_path):
    q, qmask = base_store["q"], base_store["qmask"]
    path = copy_store(base_store["path"], tmp_path)
    clock = FakeClock(100.0)
    srv = _server(
        path, clock, cache_size=0,
        compaction=CompactionPolicy(
            max_delta_segments=0, min_interval_s=0.0, retry_backoff_s=5.0,
            retry_backoff_max_s=8.0,
        ),
    )
    epoch0 = srv.index_epoch
    plan = FaultPlan([FaultRule("store.compact_step", at=0, times=100)])
    with fault.active(plan):
        with pytest.warns(RuntimeWarning, match="maintain"):
            assert srv.maintain() is False
        assert srv.stats["maintain_retries"] == 1
        fired0 = plan.fired["store.compact_step"]
        assert srv.maintain() is False  # inside the backoff: no attempt
        assert plan.fired["store.compact_step"] == fired0
        h = srv.health()
        assert h["status"] == "degraded" and any("maintenance failing" in r for r in h["reasons"])
        clock.t += 5.0
        with pytest.warns(RuntimeWarning):
            assert srv.maintain() is False
        assert plan.fired["store.compact_step"] == fired0 + 1
        assert srv.stats["maintain_retries"] == 2
        clock.t += 9.0  # doubled backoff capped at 8 s
        with pytest.warns(RuntimeWarning):
            assert srv.maintain() is False
        assert srv.stats["maintain_retries"] == 3
    assert srv.index_epoch == epoch0
    verify_store(path)
    rid = srv.submit(q[0], qmask[0])
    srv.drain()
    assert srv.poll(rid) is not None
    clock.t += 10.0
    assert srv.maintain() is True
    assert srv.stats["compactions"] == 1 and srv.index_epoch == epoch0 + 1
    assert srv.health()["status"] == "ok" and not srv.retriever.is_segmented


def test_deadline_shed_typed_error_exactly_once(base_store, tmp_path):
    q, qmask = base_store["q"], base_store["qmask"]
    clock = FakeClock()
    srv = _server(base_store["path"], clock, cache_size=0)
    shed = srv.submit(q[0], qmask[0], deadline_s=0.5)
    kept = srv.submit(q[1], qmask[1], deadline_s=5.0)
    clock.t = 1.0
    assert srv.step() == 1  # the expired one never takes a slot
    with pytest.raises(DeadlineExceeded):
        srv.poll(shed)
    with pytest.raises(ResultAlreadyTaken):
        srv.poll(shed)
    assert srv.poll(kept) is not None
    assert srv.stats["deadline_shed"] == 1 and srv.stats["served"] == 1


def test_kernel_call_fault_raises_out_of_retrieve_and_step(base_store, tmp_path):
    q, qmask = base_store["q"], base_store["qmask"]
    path = copy_store(base_store["path"], tmp_path)
    r = Retriever.from_store(path, device="cpu")
    plan = r.plan(CFG)
    want = plan.retrieve(q[0], qmask[0])
    with fault.active(FaultPlan([FaultRule("engine.kernel_call", times=1000)])) as fp:
        with pytest.raises(InjectedFault, match="engine.kernel_call"):
            plan.retrieve(q[0], qmask[0])
        with pytest.raises(InjectedFault):  # no fallback at construction either
            RetrievalServer(r, CFG, device="cpu")
    assert fp.fired["engine.kernel_call"] == 2

    srv = RetrievalServer(
        r, CFG, BatchPolicy(max_batch=4, max_wait_s=1.0), FakeClock(), bucket_aware=False
    )
    rids = [srv.submit(q[i], qmask[i]) for i in range(3)]  # one batch
    with fault.active(FaultPlan([FaultRule("engine.kernel_call", times=1000)])):
        with pytest.raises(InjectedFault) as err:
            srv.step(force=True)
        with pytest.raises(InjectedFault):  # registers nothing
            srv.add_tenant("x", path)
    assert srv.tenants == (None,)
    assert srv.stats["served"] == 0 and not srv._results and len(srv.scheduler) == 0
    assert len(srv.result_cache) == 0
    for rid in rids:
        with pytest.raises(InjectedFault) as got:
            srv.poll(rid)
        assert got.value is err.value
        with pytest.raises(ResultAlreadyTaken):
            srv.poll(rid)
    h = srv.health()
    assert h["status"] == "degraded" and h["executor_fallback"] is False
    assert any("batch dispatch failing" in r for r in h["reasons"])
    # The fault gone, the server answers again and is healthy.
    rid = srv.submit(q[0], qmask[0])
    scores, ids = srv.result(rid)
    np.testing.assert_array_equal(ids, want.doc_ids.numpy())
    assert srv.health()["status"] == "ok"
