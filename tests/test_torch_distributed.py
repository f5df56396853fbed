"""The port's document-sharded index against the JAX package's (CPU).

The JAX side runs once per module in a subprocess with three host
devices (``shard_map`` over a 3-device mesh, as ``tests/test_distributed.py``
does): it builds a 3-shard index (uneven shards, so token and cluster
padding are both exercised), saves it as a store, and records for every
plan at executor "reference" the single and batched top-k, the adaptive
rungs and ``describe()``, plus one served run (a sharded tenant, a
filter, a delete). The port loads the same store on the CPU and must give
integers exactly (doc bounds, resolved fields, rungs, doc ids) and scores
within 1e-4, the reference's own kernel tolerance.

The same store is also served by one gloo world of 3 CPU ranks, one
process per shard (``repro_torch.launch.ranks``; the world bodies are in
``tests/torch_ranks_world.py``): every plan single and batched, the
rungs, ``describe()`` and the served run must equal JAX's 3-device
``shard_map`` as the stack does, and a fault armed on one rank must make
the batch raise on every rank.

Also: ``build_sharded_index`` from JAX's per-shard centroids and
JAX-normalised embeddings gives JAX's stack exactly; a port-written
sharded store is byte-identical to JAX's and verifies; one shard view
loads as a plain ``WarpIndex``; delta segments stay refused on a sharded
base; ``shard_index`` (shared centroids) returns what the single index
returns.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_ranks_world

from repro.core import kmeans as jk
from repro.core.docfilter import DocFilter as JaxDocFilter
from repro.core.docfilter import resolve_sharded as jax_resolve_sharded
from repro.store import load_index as jax_load_index
from repro.store import verify_store as jax_verify_store
from repro_torch import obs
from repro_torch.core import (
    DocFilter,
    IndexBuildConfig,
    Retriever,
    ShardedWarpIndex,
    WarpIndex,
    WarpSearchConfig,
    build_index,
    shard_index,
    sharded_search,
)
from repro_torch.core import distributed as dist
from repro_torch.core.docfilter import resolve_rank, resolve_sharded
from repro_torch.data import make_corpus, make_queries
from repro_torch.launch import build_index as build_cli
from repro_torch.launch.ranks import WorldFailed, run_world
from repro_torch.serving import BatchPolicy, RetrievalServer
from repro_torch.store import (
    add_documents,
    builder,
    load_index,
    load_shard,
    save_index,
    verify_store,
)

torch.set_num_threads(1)  # xdist runs one test process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
N_SHARDS = 3
BUILD = dict(nbits=4, kmeans_iters=2)  # n_centroids resolved per shard: uneven
PLANS = {
    "materialize_dense": dict(gather="materialize", layout="dense"),
    "fused_dense": dict(gather="fused", layout="dense"),
    "fused_ragged": dict(gather="fused", layout="ragged"),
    "materialize_ragged": dict(gather="materialize", layout="ragged"),
    "fused_ragged_allow": dict(gather="fused", layout="ragged"),
}
SEARCH = dict(nprobe=16, k=10, executor="reference")
SERVE_SEARCH = dict(nprobe=8, k=5, t_prime=400, layout="ragged", gather="fused")

JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import numpy as np
from repro.core import (DocFilter, IndexBuildConfig, Retriever, WarpSearchConfig,
                        build_sharded_index)
from repro.data import make_corpus, make_queries
from repro.serving import BatchPolicy, RetrievalServer
from repro.store import save_index

out, n_shards = sys.argv[1], int(sys.argv[2])
build, plans, search, serve_search = (json.loads(a) for a in sys.argv[3:7])
corpus = make_corpus(n_docs=300, mean_doc_len=20, seed=0)
q, qmask, _ = make_queries(corpus, n_queries=8, tokens_per_query=(2, 24), seed=1)
cfg = IndexBuildConfig(**build)
sidx = build_sharded_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, n_shards, cfg)
save_index(sidx, os.path.join(out, "store"), build_config=cfg)
r = Retriever.from_index(sidx)
allow = DocFilter.allow(np.arange(0, corpus.n_docs, 2), corpus.n_docs)
res = dict(q=q, qmask=qmask, emb=corpus.emb, tdi=corpus.token_doc_ids,
           doc_start=np.asarray(sidx.doc_start))
desc = {}
for name, strat in plans.items():
    p = r.plan(WarpSearchConfig(**search, **strat),
               dfilter=allow if name.endswith("_allow") else None)
    one = [p.retrieve(q[i], qmask[i]) for i in range(len(q))]
    res[name + "/ids"] = np.stack([np.asarray(x.doc_ids) for x in one])
    res[name + "/scores"] = np.stack([np.asarray(x.scores) for x in one])
    b = p.retrieve_batch(q[:4], qmask[:4])
    res[name + "/batch_ids"], res[name + "/batch_scores"] = np.asarray(b.doc_ids), np.asarray(b.scores)
    if p.adaptive_bucket(q[0], qmask[0]) is not None:
        res[name + "/rungs"] = np.array([p.adaptive_bucket(q[i], qmask[i]) for i in range(len(q))])
    desc[name] = p.describe()

clock = lambda: 0.0
srv = RetrievalServer(r, WarpSearchConfig(**serve_search), BatchPolicy(max_batch=4), clock)
rids = [srv.submit(q[i], qmask[i]) for i in range(8)]
rids += [srv.submit(q[i], qmask[i], dfilter=allow) for i in range(8)]
srv.drain()
srv.delete_documents([int(i) for i in res["fused_ragged/ids"][:, 0]])
rids += [srv.submit(q[i], qmask[i]) for i in range(8)]
srv.drain()
got = [srv.poll(rid) for rid in rids]
res["serve/scores"] = np.stack([np.asarray(s) for s, _ in got])
res["serve/ids"] = np.stack([np.asarray(d) for _, d in got])
np.savez(os.path.join(out, "jax.npz"), **res)
with open(os.path.join(out, "describe.json"), "w") as f:
    json.dump(desc, f, default=str)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (BUILD, PLANS, SEARCH, SERVE_SEARCH)]
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, out, str(N_SHARDS), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with open(os.path.join(out, "describe.json")) as f:
        desc = json.load(f)
    return dict(store=os.path.join(out, "store"), z=dict(np.load(os.path.join(out, "jax.npz"))),
                describe=desc)


@pytest.fixture(scope="module")
def retriever(jax_run):
    return Retriever.from_store(jax_run["store"], device="cpu")


def _allow(n_docs):
    return DocFilter.allow(np.arange(0, n_docs, 2), n_docs)


# ---------------------------------------------------------------------------
# geometry and resolution
# ---------------------------------------------------------------------------


def test_doc_bounds_and_geometry_match_jax(jax_run, retriever):
    z = jax_run["z"]
    sidx = retriever.index
    assert isinstance(sidx, ShardedWarpIndex) and sidx.n_shards == N_SHARDS
    bounds = dist.shard_doc_bounds(z["tdi"], sidx.n_docs, N_SHARDS)
    np.testing.assert_array_equal(bounds[:-1], z["doc_start"])
    np.testing.assert_array_equal(sidx.doc_start.numpy(), z["doc_start"])
    assert bounds[-1] == sidx.n_docs == 300
    assert sidx.n_tokens_total == z["tdi"].shape[0]
    sizes = sidx.cluster_sizes.numpy()
    # Uneven shards: one is padded with empty clusters, tokens are padded too.
    assert (sizes == 0).any() and (sizes.sum(1) < sidx.n_tokens_padded).any()
    pad = sidx.token_doc_ids.numpy()[sizes.sum(1) < sidx.n_tokens_padded]
    assert (pad[:, -1] == sidx.local_docs).all()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_resolved_plan_matches_jax(jax_run, retriever, name):
    dfilter = _allow(retriever.n_docs) if name.endswith("_allow") else None
    plan = retriever.plan(WarpSearchConfig(**SEARCH, **PLANS[name]), dfilter=dfilter)
    got, want = plan.describe(), jax_run["describe"][name]
    assert got == want
    assert got["n_shards"] == N_SHARDS and plan.n_shards == N_SHARDS


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PLANS))
def test_sharded_search_matches_jax(jax_run, retriever, name):
    z = jax_run["z"]
    dfilter = _allow(retriever.n_docs) if name.endswith("_allow") else None
    plan = retriever.plan(WarpSearchConfig(**SEARCH, **PLANS[name]), dfilter=dfilter)
    q, qmask = z["q"], z["qmask"]
    one = [plan.retrieve(q[i], qmask[i]) for i in range(len(q))]
    np.testing.assert_array_equal(np.stack([r.doc_ids.numpy() for r in one]), z[name + "/ids"])
    np.testing.assert_allclose(np.stack([r.scores.numpy() for r in one]), z[name + "/scores"], **TOL)
    b = plan.retrieve_batch(q[:4], qmask[:4])
    np.testing.assert_array_equal(b.doc_ids.numpy(), z[name + "/batch_ids"])
    np.testing.assert_allclose(b.scores.numpy(), z[name + "/batch_scores"], **TOL)
    if name + "/rungs" in z:
        rungs = [plan.adaptive_bucket(q[i], qmask[i]) for i in range(len(q))]
        np.testing.assert_array_equal(rungs, z[name + "/rungs"])
        for rung in plan.config.worklist_buckets:
            if rung >= max(rungs):
                at = plan.retrieve_batch_at(q[:4], qmask[:4], bucket=rung)
                np.testing.assert_array_equal(at.doc_ids.numpy(), z[name + "/batch_ids"])
    if dfilter is not None:
        ids = np.stack([r.doc_ids.numpy() for r in one])
        assert (ids[ids >= 0] % 2 == 0).all()


def test_sharded_search_function_equals_the_plan(jax_run, retriever):
    z = jax_run["z"]
    sidx = retriever.index
    cfg = WarpSearchConfig(**SEARCH, gather="fused", layout="dense")
    allow = _allow(sidx.n_docs)
    for i in range(3):
        got = sharded_search(sidx, z["q"][i], z["qmask"][i], cfg, dfilter=allow)
        np.testing.assert_array_equal(got.doc_ids.numpy(), z["fused_ragged_allow/ids"][i])
        np.testing.assert_allclose(got.scores.numpy(), z["fused_ragged_allow/scores"][i], **TOL)
    sizes, cids = dist.sharded_probe_sizes(
        sidx, torch.from_numpy(z["q"][None, 0]), torch.from_numpy(z["qmask"][None, 0]),
        retriever.plan(cfg).config,
    )
    assert sizes.shape == cids.shape == (N_SHARDS, 1, z["q"].shape[1], SEARCH["nprobe"])


def test_sharded_filter_resolves_like_jax(jax_run, retriever):
    sidx = retriever.index
    mask = np.random.default_rng(3).random(sidx.n_docs) < 0.3
    got = resolve_sharded(DocFilter.from_bitmap(mask), sidx)
    want = jax_resolve_sharded(JaxDocFilter.from_bitmap(mask), jax_load_index(jax_run["store"]))
    np.testing.assert_array_equal(got.doc_mask.numpy(), np.asarray(want.doc_mask))
    np.testing.assert_array_equal(got.cluster_live.numpy(), np.asarray(want.cluster_live))
    assert got.doc_mask.shape == (N_SHARDS, sidx.local_docs + 1)
    assert not got.doc_mask[:, -1].any()  # the padding doc id is dead


def test_sharded_tenant_served_like_jax(jax_run, retriever):
    """The JAX script's served run: 8 requests, 8 more under a 50%
    allowlist, a delete of each query's first hit, 8 more."""
    z = jax_run["z"]
    q, qmask = z["q"], z["qmask"]
    srv = RetrievalServer(
        retriever, WarpSearchConfig(**SERVE_SEARCH), BatchPolicy(max_batch=4), lambda: 0.0,
        device="cpu",
    )
    allow = _allow(retriever.n_docs)
    rids = [srv.submit(q[i], qmask[i]) for i in range(8)]
    rids += [srv.submit(q[i], qmask[i], dfilter=allow) for i in range(8)]
    srv.drain()
    deleted = [int(i) for i in z["fused_ragged/ids"][:, 0]]
    srv.delete_documents(deleted)
    rids += [srv.submit(q[i], qmask[i]) for i in range(8)]
    srv.drain()
    got = [srv.poll(rid) for rid in rids]
    np.testing.assert_array_equal(np.stack([d for _, d in got]), z["serve/ids"])
    np.testing.assert_allclose(np.stack([s for s, _ in got]), z["serve/scores"], **TOL)
    tomb = DocFilter.tombstones(deleted, retriever.n_docs)
    for j, (scores, ids) in enumerate(got):
        i, dfilter = j % 8, (None, allow, tomb)[j // 8]
        want = retriever.plan(WarpSearchConfig(**SERVE_SEARCH), dfilter=dfilter).retrieve(q[i], qmask[i])
        np.testing.assert_array_equal(ids, want.doc_ids.numpy())
        np.testing.assert_array_equal(scores, want.scores.numpy())
    assert not set(np.stack([d for _, d in got[16:]]).ravel().tolist()) & set(deleted)
    # A reload from the sharded store keeps the sharded topology.
    srv.reload(jax_run["store"])
    st = srv._state(None)
    assert st.retriever.is_sharded and st.retriever.n_shards == N_SHARDS and srv.index_epoch == 2
    scores, ids = srv.result(srv.submit(q[0], qmask[0]))
    np.testing.assert_array_equal(ids, got[0][1])


# ---------------------------------------------------------------------------
# the build and the store
# ---------------------------------------------------------------------------


def test_build_sharded_index_from_jax_centroids(jax_run, retriever, monkeypatch):
    """Each shard through the port's assign/buckets/scatter passes from
    JAX's centroids and JAX-normalised embeddings (XLA's rsqrt is not
    correctly rounded), as ``tests/test_torch_build.py`` does for one
    index: the stack equals JAX's array for array."""
    z = jax_run["z"]
    want = retriever.index
    cfg = IndexBuildConfig(**BUILD)

    def shard_build(emb, tdi, n_docs, sub_cfg, *, device):
        s = sub_cfg.seed - cfg.seed
        n = emb.shape[0]
        c = sub_cfg.resolved_n_centroids(n)
        jnorm = np.asarray(jk.l2_normalize(jnp.asarray(emb)))

        def normed():
            yield torch.from_numpy(jnorm.copy()), np.asarray(tdi, np.int32)

        packed = np.empty((n, want.packed_codes.shape[-1]), np.uint8)
        docs = np.empty(n, np.int32)
        small = builder.encode_corpus(
            normed, want.centroids[s, :c].clone(), sub_cfg.nbits, n,
            assign_out=np.empty(n, np.int32), packed_out=packed, docs_out=docs,
        )
        return WarpIndex.from_arrays(
            dict(small, packed_codes=packed, token_doc_ids=docs, dim=emb.shape[1],
                 nbits=sub_cfg.nbits, cap=int(small["cluster_sizes"].max()), n_docs=n_docs,
                 n_tokens=n),
            device=device,
        )

    monkeypatch.setattr(dist, "build_index", shard_build)
    got = dist.build_sharded_index(z["emb"], z["tdi"], 300, N_SHARDS, cfg, device="cpu")
    for name in dist.SHARDED_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    for name in dist.SHARDED_STATIC:
        assert getattr(got, name) == getattr(want, name), name


def test_port_saves_jax_bytes(jax_run, retriever, tmp_path):
    out = save_index(retriever.index, str(tmp_path / "s"), build_config=IndexBuildConfig(**BUILD))
    src = jax_run["store"]
    files = sorted(
        os.path.relpath(os.path.join(d, f), src) for d, _, fs in os.walk(src) for f in fs
    )
    assert files == sorted(
        os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out) for f in fs
    )
    assert len([f for f in files if f.startswith("shard_")]) == N_SHARDS
    for rel in files:
        with open(os.path.join(src, rel), "rb") as a, open(os.path.join(out, rel), "rb") as b:
            assert a.read() == b.read(), rel
    # The root's 7 stacked arrays and each view's 6 slices + the shared cutoffs.
    assert verify_store(out)["checked"] == 7 + N_SHARDS * 7
    jax_verify_store(out)
    again = load_index(out, device="cpu")
    assert all(torch.equal(getattr(again, f), getattr(retriever.index, f)) for f in dist.SHARDED_ARRAYS)


@pytest.mark.parametrize("s", range(N_SHARDS))
def test_shard_view_loads_as_a_warp_index(jax_run, retriever, s):
    view = load_index(os.path.join(jax_run["store"], f"shard_{s:05d}"), device="cpu")
    local = dist.local_index(retriever.index, s)
    assert isinstance(view, WarpIndex)
    for name in ("centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
                 "cluster_sizes", "bucket_weights", "bucket_cutoffs"):
        assert torch.equal(getattr(view, name), getattr(local, name)), name
    for name in ("dim", "nbits", "cap", "n_docs", "n_tokens"):
        assert getattr(view, name) == getattr(local, name), name
    plan = Retriever.from_index(view, device="cpu").plan(WarpSearchConfig(nprobe=8, k=5))
    ids = plan.retrieve(jax_run["z"]["q"][0], jax_run["z"]["qmask"][0]).doc_ids.numpy()
    assert ((ids >= -1) & (ids < retriever.index.local_docs)).all()


def test_segments_refused_on_a_sharded_base(jax_run, tmp_path):
    extra = make_corpus(n_docs=5, mean_doc_len=6, seed=9)
    with pytest.raises(NotImplementedError, match="single-device base"):
        add_documents(jax_run["store"], extra.emb, extra.token_doc_ids, extra.n_docs, device="cpu")
    with pytest.raises(NotImplementedError, match="per-shard view"):
        add_documents(os.path.join(jax_run["store"], "shard_00000"), extra.emb,
                      extra.token_doc_ids, extra.n_docs, device="cpu")
    assert not os.path.exists(os.path.join(jax_run["store"], "segments"))


# ---------------------------------------------------------------------------
# the port's own: shared centroids, the build entry points, tracing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shared():
    corpus = make_corpus(n_docs=240, mean_doc_len=16, seed=4)
    idx = build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs,
                      IndexBuildConfig(n_centroids=32, nbits=4, kmeans_iters=2), device="cpu")
    q, qmask, _ = make_queries(corpus, n_queries=6, tokens_per_query=(2, 24), seed=5)
    return idx, shard_index(idx, 4), q, qmask


@pytest.mark.parametrize("name", sorted(PLANS))
def test_shared_centroid_shards_return_the_single_index_results(shared, name):
    idx, sidx, q, qmask = shared
    assert sidx.n_tokens_total == idx.n_tokens and sidx.n_centroids == idx.n_centroids
    assert int(sidx.cluster_sizes.sum()) == idx.n_tokens
    cfg = WarpSearchConfig(nprobe=8, k=10, **PLANS[name])
    dfilter = _allow(idx.n_docs) if name.endswith("_allow") else None
    a = Retriever.from_index(idx, device="cpu").plan(cfg, dfilter=dfilter).retrieve_batch(q, qmask)
    b = Retriever.from_index(sidx, device="cpu").plan(cfg, dfilter=dfilter).retrieve_batch(q, qmask)
    np.testing.assert_array_equal(a.doc_ids.numpy(), b.doc_ids.numpy())
    np.testing.assert_allclose(a.scores.numpy(), b.scores.numpy(), **TOL)


def test_retriever_build_n_shards_and_traced_retrieve(shared):
    idx, _, q, qmask = shared
    corpus = make_corpus(n_docs=240, mean_doc_len=16, seed=4)
    r = Retriever.build(corpus.emb, corpus.token_doc_ids, corpus.n_docs,
                        IndexBuildConfig(n_centroids=16, nbits=4, kmeans_iters=2),
                        n_shards=2, device="cpu")
    assert r.is_sharded and r.n_shards == 2 and r.n_docs == corpus.n_docs
    plan = r.plan_for_k(10)
    assert plan.describe()["k_ladder"] == "small" and plan.describe()["n_shards"] == 2
    want = plan.retrieve(q[0], qmask[0])
    tracer = obs.set_tracer(obs.Tracer())
    try:
        got = plan.retrieve(q[0], qmask[0])
    finally:
        obs.disable_all()
    assert torch.equal(got.doc_ids, want.doc_ids) and torch.equal(got.scores, want.scores)
    names = [e.name for e in tracer.events()]
    assert "engine" in names and "warp_select" not in names
    assert plan.warmup() is False


def test_cli_builds_a_sharded_store(tmp_path, capsys):
    out = str(tmp_path / "sharded")
    build_cli.main(["build", "--out", out, "--synth-docs", "120", "--n-centroids", "16",
                    "--kmeans-iters", "2", "--n-shards", "2", "--device", "cpu"])
    assert "built sharded_warp_index" in capsys.readouterr().out
    build_cli.main(["inspect", "--index", out])
    assert json.loads(capsys.readouterr().out)["n_shards"] == 2
    build_cli.main(["verify", "--index", out])
    assert "21 arrays ok" in capsys.readouterr().out
    build_cli.main(["smoke", "--index", out, "--device", "cpu"])
    assert "smoke top-5" in capsys.readouterr().out
    assert jax_load_index(out).n_shards == 2


# ---------------------------------------------------------------------------
# one process per shard: a gloo world of 3 CPU ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ranked_run(jax_run, tmp_path_factory):
    """One world of N_SHARDS gloo ranks on the CPU over JAX's store, rank r
    holding shard r; rank 0 drives (``torch_ranks_world.jax_parity``)."""
    out = str(tmp_path_factory.mktemp("ranked"))
    env = dict(os.environ)
    run_world(
        torch_ranks_world.jax_parity, N_SHARDS, backend="gloo", device="cpu",
        args=(jax_run["store"], os.path.join(os.path.dirname(jax_run["store"]), "jax.npz"),
              out, PLANS, SEARCH, SERVE_SEARCH),
        threads=1, join_timeout_s=300, workdir=out,
    )
    # The test process joined no group and keeps its environment.
    assert not torch.distributed.is_initialized() and dict(os.environ) == env
    with open(os.path.join(out, "ranked.json")) as f:
        info = json.load(f)
    followers = []
    for r in range(1, N_SHARDS):
        with open(os.path.join(out, f"follower{r}.json")) as f:
            followers.append(json.load(f))
    return dict(z=dict(np.load(os.path.join(out, "ranked.npz"))), info=info, followers=followers)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranked_search_matches_jax(jax_run, ranked_run, name):
    z, got = jax_run["z"], ranked_run["z"]
    np.testing.assert_array_equal(got[name + "/ids"], z[name + "/ids"])
    np.testing.assert_allclose(got[name + "/scores"], z[name + "/scores"], **TOL)
    np.testing.assert_array_equal(got[name + "/batch_ids"], z[name + "/batch_ids"])
    np.testing.assert_allclose(got[name + "/batch_scores"], z[name + "/batch_scores"], **TOL)
    assert (name + "/rungs" in got) == (name + "/rungs" in z)
    if name + "/rungs" in z:
        np.testing.assert_array_equal(got[name + "/rungs"], z[name + "/rungs"])
        forced = [k for k in got if k.startswith(name + "/at")]
        assert forced
        for k in forced:
            np.testing.assert_array_equal(got[k], z[name + "/batch_ids"])


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranked_plan_describes_like_jax(jax_run, ranked_run, name):
    got = ranked_run["info"]["describe"][name]
    assert got == jax_run["describe"][name]
    assert got["n_shards"] == N_SHARDS


def test_ranked_tenant_served_like_jax(jax_run, ranked_run):
    z, got, info = jax_run["z"], ranked_run["z"], ranked_run["info"]
    np.testing.assert_array_equal(got["serve/ids"], z["serve/ids"])
    np.testing.assert_allclose(got["serve/scores"], z["serve/scores"], **TOL)
    # A reload from the store reloads each rank's own view.
    assert info["reload"] == [True, N_SHARDS, 2]
    np.testing.assert_array_equal(got["reload/ids"], z["serve/ids"][0])


def _served_after(jax_run, ranked_run, tag, nxt):
    """A failed batch raised on rank 0 once per member; the next one (of
    query ``nxt``) is served."""
    info = ranked_run["info"]
    msg = info[tag]
    assert info[tag + "_polls"] == [msg] * 3  # each member of the batch, once
    assert info[tag + "_health"] == "degraded"
    z = jax_run["z"]
    want = Retriever.from_store(jax_run["store"], device="cpu").plan(
        WarpSearchConfig(**SERVE_SEARCH)).retrieve(z["q"][nxt], z["qmask"][nxt])
    np.testing.assert_array_equal(ranked_run["z"][f"after_{tag}/ids"], want.doc_ids.numpy())
    assert info[tag + "_health_after"] == "ok"
    return msg


def test_ranked_fault_on_one_rank_raises_on_every_rank(jax_run, ranked_run):
    msg = _served_after(jax_run, ranked_run, "fault", 4)
    assert "score_and_reduce failed on rank 1 (InjectedFault" in msg
    assert "engine.kernel_call" in msg
    # Every follower raised in both failed batches (this one and the copy
    # fault's), then went on.
    followers = ranked_run["followers"]
    for f in followers:
        assert f["failed"] == 2 and f["ops"] > 0
    assert followers[0]["ops"] == followers[1]["ops"]
    # A retriever closed by the reload refuses on rank 0, before any rank
    # could wait for it.
    assert "was closed" in ranked_run["info"]["closed"]


def test_ranked_query_copy_failing_on_one_rank_raises_on_every_rank(jax_run, ranked_run):
    """The copy of the broadcast queries to a rank's device is a local step
    before the first gather: it fails on rank 1 alone, and every rank
    raises at that gather."""
    msg = _served_after(jax_run, ranked_run, "copy_fault", 5)
    assert msg == "warp_select failed on rank 1 (RuntimeError: rank 1 could not copy the queries)"
    for f in ranked_run["followers"]:
        assert f["last_error"] == f"RankFailure: {msg}"


def test_unsettled_failure_on_a_follower_ends_the_world(jax_run, tmp_path):
    """A follower's failure outside any collective (here its query
    conversion) ends its loop, and ``run_world`` ends the world, rather
    than leave rank 0 waiting in a gather the follower never enters."""
    with pytest.raises(WorldFailed, match="rank 1 could not take the queries"):
        run_world(torch_ranks_world.unsettled_failure, N_SHARDS, backend="gloo", device="cpu",
                  args=(jax_run["store"], SEARCH), threads=1, join_timeout_s=120,
                  workdir=str(tmp_path))
    assert not torch.distributed.is_initialized()


def test_each_rank_holds_its_shard_alone(jax_run, retriever, ranked_run):
    ranks = ranked_run["info"]["ranks"]
    sidx = retriever.index
    assert [r["rank"] for r in ranks] == list(range(N_SHARDS))
    for r, got in enumerate(ranks):
        assert got["device"] == "cpu" and got["allocated_bytes"] is None
        assert got["index_bytes"] == dist.local_index(sidx, r).nbytes() < sidx.nbytes()
        assert got["launches"]["selective_sum"] == 0  # the reference executor


@pytest.mark.parametrize("r", range(N_SHARDS))
def test_rank_shard_and_filter_equal_the_stack_row(jax_run, retriever, r):
    """``load_shard`` (no collective) gives shard r of the stack, and
    ``resolve_rank`` row r of ``resolve_sharded``."""
    group = dist.RankGroup(r, N_SHARDS, "gloo", "cpu")
    shard = load_shard(jax_run["store"], group)
    sidx, local = retriever.index, dist.local_index(retriever.index, r)
    for name in ("centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
                 "cluster_sizes", "bucket_weights", "bucket_cutoffs"):
        assert torch.equal(getattr(shard.local, name), getattr(local, name)), name
    assert shard.doc_start == int(sidx.doc_start[r])
    np.testing.assert_array_equal(shard.shard_cluster_sizes, sidx.cluster_sizes.numpy())
    for name in ("n_docs", "n_tokens_padded", "n_tokens_total", "local_docs", "cap", "n_centroids"):
        assert getattr(shard, name) == getattr(sidx, name), name
    mask = np.random.default_rng(r).random(sidx.n_docs) < 0.4
    row, stack = resolve_rank(DocFilter.from_bitmap(mask), shard), resolve_sharded(
        DocFilter.from_bitmap(mask), sidx)
    assert torch.equal(row.doc_mask, stack.doc_mask[r])
    assert torch.equal(row.cluster_live, stack.cluster_live[r])
    cfg = WarpSearchConfig(**SEARCH, gather="fused", layout="ragged")
    assert dist.resolve_sharded_config(shard, cfg) == retriever.plan(cfg).config


def test_rank_count_other_than_the_store_raises(jax_run, tmp_path):
    with pytest.raises(WorldFailed, match="holds 3 shards but the group has 2 ranks"):
        run_world(torch_ranks_world.load_only, 2, backend="gloo", device="cpu",
                  args=(jax_run["store"],), threads=1, join_timeout_s=120,
                  workdir=str(tmp_path))
    assert not torch.distributed.is_initialized()


def test_nccl_needs_cards():
    with pytest.raises(ValueError, match="ranks on the CPU take backend='gloo'"):
        run_world(torch_ranks_world.load_only, 2, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_world(torch_ranks_world.load_only, 2, backend="nccl")
    with pytest.raises(ValueError, match="backend='mpi' is not one of"):
        run_world(torch_ranks_world.load_only, 2, backend="mpi", device="cpu")


def test_serve_launcher_with_one_process_per_shard(capfd, monkeypatch):
    from repro_torch.launch import serve as serve_cli

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks inherit it: one thread each

    with pytest.raises(SystemExit):
        serve_cli.main(["--device", "cpu", "--n-shards", "2", "--ranks"])  # no --backend
    assert serve_cli.main(["--device", "cpu", "--n-shards", "2", "--ranks", "--backend", "gloo",
                           "--n-docs", "120", "--queries", "4", "--layout", "ragged"]) == 0
    out = capfd.readouterr().out
    assert "ranked index: 2 ranks (gloo)" in out and "rank 1: cpu, its shard alone" in out
    assert "'n_shards': 2" in out and "served 4 queries" in out and "health: ok" in out
    assert not torch.distributed.is_initialized()


def test_world_devices_are_explicit(monkeypatch):
    from repro_torch.launch.ranks import world_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(2)]
    assert world_devices(2, "nccl") == cuda
    assert world_devices(3, "gloo") == [cuda[0], cuda[1], cuda[0]]
    assert world_devices(3, "gloo", "cuda:1") == [cuda[1]] * 3
    assert world_devices(3, "gloo", "cpu") == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="2 card"):
        world_devices(3, "nccl")
    with pytest.raises(ValueError, match="not all on cuda:0"):
        world_devices(2, "nccl", "cuda:0")
    with pytest.raises(ValueError, match="not one of the 2 visible"):
        world_devices(2, "gloo", "cuda:5")
