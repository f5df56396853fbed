"""Port parity of segmented indexes: a store built, grown and tombstoned by
the JAX package, loaded by both packages.

- Integers exactly: ``worklist_bound_segmented``, ``build_tile_worklist``
  with ``seg``, ``segmented_probe_cids``, the resolved config fields,
  ``delta_stats``, and top-k doc ids of segmented search (single and
  batched, dense and ragged, both gathers, unfiltered, allowlist and
  tombstones; JAX at executor "reference", reduce_impl "scan").
- Floats within rtol = atol = 1e-4: scores, and the plain
  ``segmented_ragged_fused_gather_score`` against JAX's.
- Store bytes exactly: the port's ``add_documents`` on embeddings JAX has
  normalized (XLA's rsqrt is not correctly rounded, so the port's own
  normalization differs in the last bit), ``compact`` with and without
  tombstones, ``delete_documents``, and the ``add``/``compact`` CLI.
- The anchor: after ``compact`` (tombstones held aside) the single index
  retrieves the segmented plan's doc ids; with tombstones ``compact``
  drops exactly the deleted docs' rows.
- Lifecycle: a corrupt delta quarantined, a stale compact lock taken
  over, an interrupted compaction recovered.
"""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import build_index as jax_build_index
from repro.core import kmeans as jax_kmeans
from repro.core import worklist as jax_wl
from repro.core.docfilter import DocFilter as JaxDocFilter
from repro.data import make_corpus
from repro.kernels import ref as jax_ref
from repro.launch import build_index as jax_cli
from repro.store import add_documents as jax_add
from repro.store import compact as jax_compact
from repro.store import delete_documents as jax_delete
from repro.store import delta_stats as jax_delta_stats
from repro.store import inspect_index as jax_inspect
from repro.store import load_index as jax_load_index
from repro.store import read_tombstones as jax_read_tombstones
from repro.store import save_index as jax_save
from repro.store import segments as jax_segments
from repro.store import verify_store as jax_verify
from repro_torch.core import Retriever, WarpSearchConfig
from repro_torch.core import worklist as wl
from repro_torch.core.docfilter import DocFilter
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import build_index as cli
from repro_torch.store import (
    SegmentedWarpIndex,
    StoreCorruption,
    compact,
    delete_documents,
    delta_stats,
    inspect_index,
    load_index,
    read_tombstones,
    save_index,
    verify_store,
)
from repro_torch.store import format as store_format
from repro_torch.store import segments

torch.set_num_threads(1)  # xdist runs one test process per core

BUILD = JaxBuildConfig(n_centroids=64, nbits=4, kmeans_iters=3)
TOL = dict(rtol=1e-4, atol=1e-4)
CONFIGS = [(g, l) for g in ("materialize", "fused") for l in ("dense", "ragged")]
TOMBSTONED = (3, 57, 161, 170, 199, 201)  # base, delta and tiny-delta docs


def _corpora():
    kw = dict(mean_doc_len=14, topic_strength=3.0, n_topics=200)
    return (
        make_corpus(n_docs=160, seed=31, **kw),
        make_corpus(n_docs=40, seed=32, **kw),
        make_corpus(n_docs=3, seed=33, mean_doc_len=3, topic_strength=3.0, n_topics=200),
    )


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A JAX-built base of 160 docs, a delta of 40 and one of 3 docs (fewer
    rows than a tile), six docs tombstoned; both packages loaded (CPU)."""
    base_c, delta_c, tiny_c = _corpora()
    root = tmp_path_factory.mktemp("segments")
    path = str(root / "grown")
    jax_save(jax_build_index(base_c.emb, base_c.token_doc_ids, base_c.n_docs, BUILD), path,
             build_config=BUILD)
    pristine = str(root / "base_only")
    shutil.copytree(path, pristine)
    jax_add(path, delta_c.emb, delta_c.token_doc_ids, delta_c.n_docs)
    jax_add(path, tiny_c.emb, tiny_c.token_doc_ids, tiny_c.n_docs)
    jax_delete(path, TOMBSTONED)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((4, 8, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qmask = np.ones((4, 8), bool)
    qmask[1, 5:] = False
    qmask[3, 2:] = False
    return dict(
        path=path, pristine=pristine, corpora=(base_c, delta_c, tiny_c), q=q, qmask=qmask,
        jr=JaxRetriever.from_store(path), tr=Retriever.from_store(path, device="cpu"),
    )


def _jax_normalized(monkeypatch):
    """Hand the port's ``add_documents`` JAX's normalization."""
    monkeypatch.setattr(
        segments.kmeans, "l2_normalize",
        lambda x: torch.from_numpy(np.array(jax_kmeans.l2_normalize(jnp.asarray(x.cpu().numpy())))),
    )


def _files(path):
    out = {}
    for d, _, names in os.walk(path):
        for n in names:
            full = os.path.join(d, n)
            with open(full, "rb") as f:
                out[os.path.relpath(full, path)] = f.read()
    return out


def _assert_same_tree(a, b):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


def _filters(grown, which):
    n = grown["tr"].n_docs
    if which == "tombstones":
        tomb = read_tombstones(grown["path"])
        return JaxDocFilter.tombstones(tomb, n), DocFilter.tombstones(tomb, n)
    if which == "allow":
        ids = np.random.default_rng(9).choice(n, n // 2, replace=False)
        return JaxDocFilter.allow(ids, n), DocFilter.allow(ids, n)
    return None, None


# ---------------------------------------------------------------------------
# loading and geometry
# ---------------------------------------------------------------------------


def test_load_segmented_geometry_matches_jax(grown):
    j, t = jax_load_index(grown["path"]), grown["tr"].index
    assert isinstance(t, SegmentedWarpIndex) and grown["tr"].is_segmented
    assert (t.n_segments, t.doc_starts, t.n_docs, t.n_tokens, t.cap, t.quarantined) == (
        j.n_segments, j.doc_starts, j.n_docs, j.n_tokens, j.cap, j.quarantined
    )
    np.testing.assert_array_equal(t.combined_cluster_sizes().numpy(), np.asarray(j.combined_cluster_sizes()))
    np.testing.assert_array_equal(t.per_segment_cluster_sizes(), j.per_segment_cluster_sizes())
    for ts, js in zip(t.segments, j.segments):
        for name in store_format.SEGMENT_ARRAYS:
            np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    assert all(d.centroids is t.base.centroids for d in t.deltas)
    assert t.nbytes() == j.nbytes()
    assert load_index(grown["path"], device="cpu", with_segments=False).n_docs == 160


@pytest.mark.parametrize("nprobe,tile_c", [(1, 8), (8, 8), (8, 32), (64, 16)])
def test_worklist_bound_segmented_matches_jax(grown, nprobe, tile_c):
    sizes = grown["tr"].index.per_segment_cluster_sizes()
    assert wl.worklist_bound_segmented(sizes, nprobe, tile_c) == jax_wl.worklist_bound_segmented(
        sizes, nprobe, tile_c
    )
    with pytest.raises(ValueError, match="n_segments"):
        wl.worklist_bound_segmented(sizes[0], nprobe, tile_c)


@pytest.mark.parametrize("tile_c", [8, 16])
def test_build_tile_worklist_with_seg_matches_jax(tile_c):
    rng = np.random.default_rng(tile_c)
    q, p = 5, 12
    starts = rng.integers(0, 500, (q, p)).astype(np.int32)
    sizes = rng.integers(0, 40, (q, p)).astype(np.int32)
    sizes[rng.random((q, p)) < 0.3] = 0
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    seg = rng.integers(0, 4, (q, p)).astype(np.int32)
    bound = jax_wl.needed_worklist_tiles(jax_wl.probe_tile_counts(sizes, tile_c)) + 2
    want = jax_wl.build_tile_worklist(
        jnp.asarray(starts), jnp.asarray(sizes), jnp.asarray(pscore), seg=jnp.asarray(seg),
        tile_c=tile_c, tiles_per_qtoken=bound,
    )
    got = wl.build_tile_worklist(
        *(torch.from_numpy(a) for a in (starts, sizes, pscore)), seg=torch.from_numpy(seg),
        tile_c=tile_c, tiles_per_qtoken=bound,
    )
    assert isinstance(got, wl.SegmentedTileWorklist)
    for name in ("row0", "nvalid", "seg", "qtok"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.pscore.numpy(), np.asarray(want.pscore))
    # Batched: each element its own worklist, as JAX's vmap gives.
    two = wl.build_tile_worklist(
        *(torch.from_numpy(np.stack([a, a])) for a in (starts, sizes, pscore)),
        seg=torch.from_numpy(np.stack([seg, seg])), tile_c=tile_c, tiles_per_qtoken=bound,
    )
    assert torch.equal(two.seg[1], got.seg) and torch.equal(two.row0[0], got.row0)


def test_segmented_probe_cids_match_jax(grown):
    jr, tr = grown["jr"], grown["tr"]
    jcfg = jr.plan(JaxConfig(nprobe=8, k=10, executor="reference")).config
    tcfg = tr.plan(WarpSearchConfig(nprobe=8, k=10, executor="reference")).config
    want = jax_segments.segmented_probe_cids(
        jr.index.base.centroids, jr.index.combined_cluster_sizes(), jnp.asarray(grown["q"]),
        jnp.asarray(grown["qmask"]), jcfg, True,
    )
    got = segments.segmented_probe_cids(
        tr.index.base.centroids, tr.index.combined_cluster_sizes(),
        torch.from_numpy(grown["q"]), torch.from_numpy(grown["qmask"]), tcfg,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


FIELDS = ("t_prime", "k_impute", "layout", "tile_c", "worklist_tiles", "worklist_buckets")


@pytest.mark.parametrize("layout", ["dense", "ragged", "auto"])
@pytest.mark.parametrize("extra", [{}, {"tile_c": 8}, {"nprobe": 2, "k": 5}, {"t_prime": 50}])
def test_resolved_segmented_config_matches_jax(grown, layout, extra):
    kw = dict(dict(nprobe=8, k=10), **extra)
    j = grown["jr"].plan(JaxConfig(layout=layout, executor="reference", **kw)).config
    t = grown["tr"].plan(WarpSearchConfig(layout=layout, executor="reference", **kw)).config
    assert [getattr(t, f) for f in FIELDS] == [getattr(j, f) for f in FIELDS]


def test_plan_describes_segments_and_refuses_kernel_on_cpu(grown):
    d = grown["tr"].plan(WarpSearchConfig(nprobe=8, k=10)).describe()
    assert d["n_segments"] == 3 and d["n_docs"] == 203 and d["filter"] is None
    with pytest.raises(ValueError, match="executor='kernel'"):
        grown["tr"].plan(WarpSearchConfig(nprobe=8, k=10, executor="kernel"))


# ---------------------------------------------------------------------------
# search against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", [None, "allow", "tombstones"])
@pytest.mark.parametrize("gather,layout", CONFIGS)
def test_segmented_search_matches_jax(grown, gather, layout, which):
    jf, tf = _filters(grown, which)
    kw = dict(nprobe=8, k=10, gather=gather, layout=layout, executor="reference")
    jp = grown["jr"].plan(JaxConfig(**kw, reduce_impl="scan"), dfilter=jf)
    tp = grown["tr"].plan(WarpSearchConfig(**kw), dfilter=tf)
    q, m = grown["q"], grown["qmask"]
    want = jp.retrieve_batch(q, m)
    got = tp.retrieve_batch(q, m)
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    one = tp.retrieve(q[1], m[1])
    np.testing.assert_array_equal(one.doc_ids.numpy(), np.asarray(jp.retrieve(q[1], m[1]).doc_ids))
    if which == "tombstones":
        assert not set(TOMBSTONED) & set(got.doc_ids.numpy().ravel().tolist())
    if tf is not None:
        assert tp.describe()["filter"] == tf.describe() == jf.describe()


@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("which", ["allow", "tombstones"])
def test_filtered_plan_equals_post_hoc_filtering(grown, layout, which):
    _, tf = _filters(grown, which)
    q, m = grown["q"], grown["qmask"]
    tr = grown["tr"]
    got = tr.plan(WarpSearchConfig(nprobe=8, k=10, gather="fused", layout=layout), dfilter=tf)
    wide = tr.plan(WarpSearchConfig(nprobe=8, k=200, gather="fused", layout=layout))
    a, b = got.retrieve_batch(q, m), wide.retrieve_batch(q, m)
    keep = tf.survivor_mask
    for i in range(q.shape[0]):
        ids, sc = b.doc_ids[i].numpy(), b.scores[i].numpy()
        ok = (ids >= 0) & keep[np.clip(ids, 0, None)]
        want = ids[ok][:10]
        np.testing.assert_array_equal(a.doc_ids[i].numpy()[: len(want)], want)
        np.testing.assert_array_equal(a.scores[i].numpy()[: len(want)], sc[ok][:10])


def test_segmented_dense_and_ragged_agree(grown):
    q, m = grown["q"], grown["qmask"]
    res = [
        grown["tr"].plan(WarpSearchConfig(nprobe=8, k=10, gather=g, layout=l)).retrieve_batch(q, m)
        for g, l in CONFIGS
    ]
    for r in res[1:]:
        np.testing.assert_array_equal(r.doc_ids.numpy(), res[0].doc_ids.numpy())
        np.testing.assert_allclose(r.scores.numpy(), res[0].scores.numpy(), **TOL)


def test_adaptive_rungs_give_the_same_ids(grown):
    plan = grown["tr"].plan(WarpSearchConfig(nprobe=8, k=10, gather="fused", layout="ragged"))
    assert plan.adaptive
    q, m = grown["q"], grown["qmask"]
    base = plan.retrieve_batch(q, m).doc_ids
    rung = plan.adaptive_bucket(q[0], m[0])
    assert rung in plan.config.worklist_buckets
    top = plan.config.worklist_buckets[-1]
    assert torch.equal(plan.retrieve_batch_at(q, m, bucket=top).doc_ids, base)


@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_plain_kernel_matches_jax(grown, seed):
    """The plain segmented scoring and gather against JAX's, on the grown
    store's segments (one smaller than a tile) and a worklist that also
    holds padding."""
    segs = grown["tr"].index.segments
    rng = np.random.default_rng(seed)
    w, tile = 40, 8
    seg = rng.integers(0, 3, w).astype(np.int32)
    rows = np.array([s.n_tokens for s in segs])[seg]
    row0 = rng.integers(0, np.maximum(rows - 1, 1)).astype(np.int32)
    nvalid = np.minimum(rng.integers(0, tile + 1, w), rows - row0).astype(np.int32)
    nvalid[-5:] = 0
    qtok = rng.integers(0, 4, w).astype(np.int32)
    pscore = rng.standard_normal(w).astype(np.float32)
    v = rng.standard_normal((4, 128, 16)).astype(np.float32)
    packed = [s.packed_codes.numpy() for s in segs]
    want = jax_ref.segmented_ragged_fused_gather_score(
        tuple(jnp.asarray(p) for p in packed), *(jnp.asarray(a) for a in (row0, nvalid, seg, qtok, pscore, v)),
        nbits=4, dim=128, tile_c=tile,
    )
    t = [torch.from_numpy(a) for a in (row0, nvalid, seg, qtok, pscore, v)]
    got = tref.segmented_ragged_fused_gather_score(
        [s.packed_codes for s in segs], *t, nbits=4, dim=128, tile_c=tile
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool((got.reshape(w, tile)[-5:] == 0).all())
    codes_j, valid_j = jax_ref.segmented_ragged_gather_codes(
        tuple(jnp.asarray(p) for p in packed), *(jnp.asarray(a) for a in (row0, nvalid, seg)), tile_c=tile
    )
    codes_t, valid_t = tref.segmented_ragged_gather_codes(
        [s.packed_codes for s in segs], *t[:3], tile_c=tile
    )
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    # The dispatcher's kernel route on a CPU tensor is the plain version.
    via_kernel = ops.segmented_ragged_fused_gather_selective_sum(
        [s.packed_codes for s in segs], *t[:5], t[5], nbits=4, dim=128, tile_c=tile,
        use_kernel=True,
    )
    assert torch.equal(via_kernel, got)


# ---------------------------------------------------------------------------
# store bytes: add, delete, compact, the CLI
# ---------------------------------------------------------------------------


def test_add_documents_writes_jax_segment_bytes(grown, tmp_path, monkeypatch):
    _, delta_c, tiny_c = grown["corpora"]
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(grown["pristine"], pj)
    shutil.copytree(grown["pristine"], pt)
    _jax_normalized(monkeypatch)
    for c in (delta_c, tiny_c):
        jax_add(pj, c.emb, c.token_doc_ids, c.n_docs)
        segments.add_documents(pt, c.emb, c.token_doc_ids, c.n_docs, device="cpu")
    _assert_same_tree(pj, pt)
    assert delta_stats(pt) == jax_delta_stats(pj)
    with pytest.raises(ValueError, match="local"):
        segments.add_documents(pt, delta_c.emb, delta_c.token_doc_ids, 2, device="cpu")


def test_delete_documents_writes_jax_tombstones(grown, tmp_path):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(grown["pristine"], pj)
    shutil.copytree(grown["pristine"], pt)
    for batch in ([5, 1, 5], [300, 2]):
        assert delete_documents(pt, batch) == jax_delete(pj, batch)
    assert read_tombstones(pt) == jax_read_tombstones(pj) == (1, 2, 5, 300)
    _assert_same_tree(pj, pt)
    assert read_tombstones(grown["pristine"]) == ()


@pytest.mark.parametrize("tombstones", [False, True])
def test_compact_writes_jax_bytes(grown, tmp_path, tombstones):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(grown["path"], pj)
    if not tombstones:
        os.remove(os.path.join(pj, segments.TOMBSTONES_FILE))
    shutil.copytree(pj, pt)
    jax_compact(pj)
    compact(pt)
    _assert_same_tree(pj, pt)
    assert not os.path.exists(os.path.join(pt, "segments"))
    assert not any(n.startswith("t.compact") for n in os.listdir(tmp_path))


def test_compact_tombstones_only_and_already_compact(grown, tmp_path):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(grown["pristine"], pj)
    shutil.copytree(grown["pristine"], pt)
    before = _files(pt)
    assert compact(pt) == pt and _files(pt) == before  # nothing to fold
    jax_delete(pj, [4, 9])
    delete_documents(pt, [4, 9])
    jax_compact(pj)
    compact(pt)
    _assert_same_tree(pj, pt)


def test_compacted_index_retrieves_segmented_ids(grown, tmp_path):
    """The subsystem's anchor: folding the deltas in (the tombstones held
    aside) keeps cluster sizes, t' and m_i, so the single index gives the
    segmented plan's doc ids, scores within 1e-4."""
    path = str(tmp_path / "c")
    shutil.copytree(grown["path"], path)
    os.remove(os.path.join(path, segments.TOMBSTONES_FILE))
    compact(path)
    single = Retriever.from_store(path, device="cpu")
    assert not single.is_segmented and single.n_docs == grown["tr"].n_docs
    q, m = grown["q"], grown["qmask"]
    for g, l in CONFIGS:
        kw = dict(nprobe=8, k=10, gather=g, layout=l)
        want = grown["tr"].plan(WarpSearchConfig(**kw)).retrieve_batch(q, m)
        got = single.plan(WarpSearchConfig(**kw)).retrieve_batch(q, m)
        np.testing.assert_array_equal(got.doc_ids.numpy(), want.doc_ids.numpy())
        np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), **TOL)


def test_compact_with_tombstones_drops_exactly_their_rows(grown, tmp_path):
    """Dropping rows shrinks cluster sizes (and t'), so m_i may move; what
    is exact is the layout: the deltas' compaction without the deleted
    docs' rows, and no deleted doc is ever returned."""
    folded, dropped = str(tmp_path / "f"), str(tmp_path / "d")
    shutil.copytree(grown["path"], dropped)
    shutil.copytree(grown["path"], folded)
    os.remove(os.path.join(folded, segments.TOMBSTONES_FILE))
    compact(folded)
    compact(dropped)
    a, b = load_index(folded, device="cpu"), load_index(dropped, device="cpu")
    keep = ~np.isin(a.token_doc_ids.numpy(), TOMBSTONED)
    np.testing.assert_array_equal(b.packed_codes.numpy(), a.packed_codes.numpy()[keep])
    np.testing.assert_array_equal(b.token_doc_ids.numpy(), a.token_doc_ids.numpy()[keep])
    cluster_of = np.repeat(np.arange(a.n_centroids), a.cluster_sizes.numpy())
    np.testing.assert_array_equal(
        b.cluster_sizes.numpy(), np.bincount(cluster_of[keep], minlength=a.n_centroids)
    )
    assert read_tombstones(dropped) == () and b.n_docs == a.n_docs
    res = Retriever.from_index(b, device="cpu").plan(WarpSearchConfig(nprobe=8, k=10)).retrieve_batch(
        grown["q"], grown["qmask"]
    )
    assert not set(TOMBSTONED) & set(res.doc_ids.numpy().ravel().tolist())


def test_cli_add_compact_match_jax_cli(grown, tmp_path, monkeypatch, capsys):
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(grown["pristine"], pj)
    shutil.copytree(grown["pristine"], pt)
    _jax_normalized(monkeypatch)
    add = ["add", "--synth-docs", "20", "--synth-seed", "9", "--mean-doc-len", "12"]
    for argv, path in ((add, pj), (["compact"], pj)):
        monkeypatch.setattr(sys, "argv", ["build_index", *argv, "--index", path])
        jax_cli.main()
    cli.main([*add, "--index", pt, "--device", "cpu"])
    assert "seg_00000" in capsys.readouterr().out
    cli.main(["inspect", "--index", pt])
    assert '"n_segments": 1' in capsys.readouterr().out
    cli.main(["smoke", "--index", pt, "--device", "cpu"])
    cli.main(["compact", "--index", pt])
    assert "compacted" in capsys.readouterr().out
    _assert_same_tree(pj, pt)


def test_inspect_and_verify_match_jax(grown):
    assert inspect_index(grown["path"]) == jax_inspect(grown["path"])
    assert verify_store(grown["path"]) == jax_verify(grown["path"])


def test_save_index_of_a_segmented_index_raises(grown, tmp_path):
    with pytest.raises(TypeError, match="segmented indexes are saved via"):
        save_index(grown["tr"].index, str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# lifecycle: quarantine, the compact lock, crash recovery
# ---------------------------------------------------------------------------


def test_corrupt_delta_is_quarantined_or_raises(grown, tmp_path):
    path = str(tmp_path / "q")
    shutil.copytree(grown["path"], path)
    seg_dir = store_format.list_segment_dirs(path)[0]
    with open(os.path.join(seg_dir, "arrays", "packed_codes.bin"), "r+b") as f:
        f.seek(3)
        byte = f.read(1)
        f.seek(3)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(StoreCorruption, match="packed_codes"):
        load_index(path, device="cpu")
    with pytest.warns(UserWarning, match="quarantined"):
        got = load_index(path, device="cpu", quarantine_segments=True)
    want = jax_load_index(path, quarantine_segments=True)
    assert got.quarantined == want.quarantined == ("seg_00000",)
    assert got.doc_starts == want.doc_starts == (0, 200)  # the gap keeps ids stable
    assert got.n_docs == want.n_docs == 203


def test_stale_compact_lock_is_taken_over_and_a_live_one_refuses(grown, tmp_path):
    path = str(tmp_path / "l")
    shutil.copytree(grown["path"], path)
    lock = store_format.compact_lock_path(path)
    with open(lock, "w") as f:
        f.write(str(os.getpid()))  # a live holder: this process
    with pytest.raises(RuntimeError, match="already running"):
        compact(path)
    with open(lock, "w") as f:
        f.write("0")  # no live holder
    compact(path)
    assert not os.path.exists(lock)
    assert not isinstance(load_index(path, device="cpu"), SegmentedWarpIndex)


@pytest.mark.parametrize("crash_at", ["old_aside", "arrays"])
def test_interrupted_compaction_is_recovered(grown, tmp_path, crash_at):
    """A crash after the old store went aside (the new one complete):
    load_index finishes the swap. A crash before the new one was
    finalized: load_index rolls back to the old store."""
    path = str(tmp_path / "r")
    shutil.copytree(grown["path"], path)
    done = str(tmp_path / "done")
    shutil.copytree(path, done)
    compact(done)
    tmp = path + store_format.COMPACT_TMP_SUFFIX
    old = path + store_format.COMPACT_OLD_SUFFIX
    if crash_at == "old_aside":
        shutil.copytree(done, tmp)
    else:
        os.makedirs(os.path.join(tmp, "arrays"))  # no manifest yet
    os.rename(path, old)
    with open(store_format.compact_lock_path(path), "w") as f:
        f.write("0")  # the dead writer's lock
    idx = load_index(path, device="cpu")
    assert not os.path.exists(tmp) and not os.path.exists(old)
    assert not os.path.exists(store_format.compact_lock_path(path))
    if crash_at == "old_aside":
        _assert_same_tree(done, path)
    else:
        assert isinstance(idx, SegmentedWarpIndex) and idx.n_segments == 3
