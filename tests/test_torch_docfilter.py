"""Port parity of doc filtering (``repro_torch.core.docfilter``) against
``repro.core.docfilter`` on the same inputs: the filters' bitmaps and
digests, ``cluster_survivor_counts`` and ``cluster_live`` exactly,
``filtered_probe_sizes`` on numpy and tensors, the reduction's
``doc_mask`` (doc ids exact, scores within a few float32 ulps), and
filtered retrieval from the committed single-index fixture store (doc ids
exact, scores within 1e-4; a filtered plan equals post-hoc filtering of
an unfiltered one at a larger k)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import docfilter as jdf
from repro.core import worklist as jax_wl
from repro.core.reduction import two_stage_reduce as jax_reduce
from repro.store import load_index as jax_load_index
from repro_torch.core import Retriever, WarpSearchConfig
from repro_torch.core import docfilter as df
from repro_torch.core import worklist as wl
from repro_torch.core.reduction import two_stage_reduce
from repro_torch.store import load_index

torch.set_num_threads(1)  # xdist runs one test process per core

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_fixture", "store")
CONFIGS = [(g, l) for g in ("materialize", "fused") for l in ("dense", "ragged")]


def _both(kind, *args):
    return getattr(jdf.DocFilter, kind)(*args), getattr(df.DocFilter, kind)(*args)


@pytest.mark.parametrize("kind,args", [
    ("allow", ([3, 1, 1, 40, -2, 99], 50)),
    ("deny", ([0, 49, 7], 50)),
    ("tombstones", ([5, 6, 500], 50)),
    ("from_bitmap", (np.arange(17) % 3 == 0,)),
])
def test_filters_match_jax(kind, args):
    j, t = _both(kind, *args)
    np.testing.assert_array_equal(t.survivor_mask, j.survivor_mask)
    assert t.digest == j.digest and t.describe() == j.describe() and t.kind == j.kind
    assert (t.n_docs, t.n_survivors, t.is_noop) == (j.n_docs, j.n_survivors, j.is_noop)
    assert not t.survivor_mask.flags.writeable


def test_filter_algebra():
    a = df.DocFilter.allow([1, 2, 3], 8)
    assert a == df.DocFilter.deny([0, 4, 5, 6, 7], 8) and hash(a) == hash(df.DocFilter.deny([0, 4, 5, 6, 7], 8))
    both = a.intersect(df.DocFilter.tombstones([2], 8))
    assert both.survivor_mask.nonzero()[0].tolist() == [1, 3] and both.kind == "bitmap"
    assert both.digest == jdf.DocFilter.allow([1, 2, 3], 8).intersect(jdf.DocFilter.tombstones([2], 8)).digest
    assert df.DocFilter.deny([], 4).is_noop
    with pytest.raises(ValueError, match="length mismatch"):
        a.intersect(df.DocFilter.allow([1], 9))
    assert "n_survivors=3" in repr(a)


@pytest.mark.parametrize("seed", range(4))
def test_cluster_survivor_counts_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_docs, c = 30, 9
    sizes = rng.integers(0, 12, c)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    tok = rng.integers(-1, n_docs + 2, offsets[-1]).astype(np.int32)  # padding ids too
    mask = rng.random(n_docs) < 0.4
    want = jdf.cluster_survivor_counts(mask, tok, offsets)
    np.testing.assert_array_equal(df.cluster_survivor_counts(mask, tok, offsets), want)
    got_t = df.cluster_survivor_counts(torch.from_numpy(mask), torch.from_numpy(tok), torch.from_numpy(offsets))
    np.testing.assert_array_equal(got_t.numpy(), want)


@pytest.mark.parametrize("which", ["allow", "deny", "none_survive"])
def test_resolve_local_matches_jax(which):
    j_idx, t_idx = jax_load_index(FIXTURE), load_index(FIXTURE, device="cpu")
    n = t_idx.n_docs
    ids = np.random.default_rng(1).choice(n, n // 3, replace=False)
    if which == "none_survive":
        which, ids = "allow", []
    jf, tf = _both(which, ids, n)
    want, got = jdf.resolve_local(jf, j_idx), df.resolve_local(tf, t_idx)
    np.testing.assert_array_equal(got.doc_mask.numpy(), np.asarray(want.doc_mask))
    np.testing.assert_array_equal(got.cluster_live.numpy(), np.asarray(want.cluster_live))
    assert got.doc_mask.device == t_idx.device


def test_filtered_probe_sizes_match_jax():
    rng = np.random.default_rng(2)
    sizes = rng.integers(0, 50, (2, 4, 6))
    cids = rng.integers(0, 20, (2, 4, 6))
    live = rng.random(20) < 0.5
    want = np.asarray(jax_wl.filtered_probe_sizes(jnp.asarray(sizes), jnp.asarray(cids), jnp.asarray(live)))
    np.testing.assert_array_equal(wl.filtered_probe_sizes(sizes, cids, live), want)
    np.testing.assert_array_equal(jax_wl.filtered_probe_sizes(sizes, cids, live), want)
    got = wl.filtered_probe_sizes(torch.from_numpy(sizes), torch.from_numpy(cids), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_reduction_doc_mask_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    n, n_docs, q_max = 200, 25, 4
    doc_ids = rng.integers(0, n_docs, n).astype(np.int32)
    qtok = rng.integers(0, q_max, n).astype(np.int32)
    scores = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) > 0.2
    mse = (rng.standard_normal(q_max) * 0.1).astype(np.float32)
    doc_mask = rng.random(n_docs) < 0.5
    args = (doc_ids, qtok, scores, valid, mse, doc_mask)
    want = jax_reduce(*(jnp.asarray(a) for a in args), q_max=q_max, k=8, n_docs=n_docs)
    got = two_stage_reduce(*(torch.from_numpy(a) for a in args), q_max=q_max, k=8)
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=4e-6)
    ids = got.doc_ids.numpy()
    assert doc_mask[ids[ids >= 0]].all()
    # Survivors keep their unfiltered scores.
    free = two_stage_reduce(*(torch.from_numpy(a) for a in args[:5]), q_max=q_max, k=n_docs)
    by_doc = dict(zip(free.doc_ids.numpy().tolist(), free.scores.numpy().tolist()))
    for d, s in zip(ids.tolist(), got.scores.numpy().tolist()):
        if d >= 0:
            assert by_doc[d] == s


@pytest.fixture(scope="module")
def fixture_retrievers():
    z = np.load(os.path.join(os.path.dirname(FIXTURE), "queries.npz"))
    return JaxRetriever.from_store(FIXTURE), Retriever.from_store(FIXTURE, device="cpu"), z


@pytest.mark.parametrize("gather,layout", CONFIGS)
@pytest.mark.parametrize("which", ["allow", "deny"])
def test_filtered_single_index_retrieval_matches_jax(fixture_retrievers, gather, layout, which):
    jr, tr, z = fixture_retrievers
    n = tr.n_docs
    ids = np.random.default_rng(3).choice(n, n // 2, replace=False)
    jf, tf = _both(which, ids, n)
    kw = dict(nprobe=8, k=10, gather=gather, layout=layout, executor="reference")
    jp = jr.plan(JaxConfig(**kw, reduce_impl="scan"), dfilter=jf)
    tp = tr.plan(WarpSearchConfig(**kw), dfilter=tf)
    want, got = jp.retrieve_batch(z["q"], z["qmask"]), tp.retrieve_batch(z["q"], z["qmask"])
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-4)
    one = tp.retrieve(z["q"][0], z["qmask"][0])
    np.testing.assert_array_equal(one.doc_ids.numpy(), got.doc_ids[0].numpy())
    assert tp.describe()["filter"] == jf.describe()
    if layout == "ragged" and tp.adaptive:
        assert tp.adaptive_bucket(z["q"][0], z["qmask"][0]) <= tr.plan(
            WarpSearchConfig(**kw)
        ).adaptive_bucket(z["q"][0], z["qmask"][0])


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_filtered_plan_equals_post_hoc_filtering(fixture_retrievers, layout):
    _, tr, z = fixture_retrievers
    n = tr.n_docs
    tf = df.DocFilter.allow(np.random.default_rng(4).choice(n, n // 2, replace=False), n)
    got = tr.plan(WarpSearchConfig(nprobe=8, k=10, gather="fused", layout=layout), dfilter=tf)
    wide = tr.plan(WarpSearchConfig(nprobe=8, k=120, gather="fused", layout=layout))
    a, b = got.retrieve_batch(z["q"], z["qmask"]), wide.retrieve_batch(z["q"], z["qmask"])
    for i in range(a.doc_ids.shape[0]):
        ids, sc = b.doc_ids[i].numpy(), b.scores[i].numpy()
        ok = (ids >= 0) & tf.survivor_mask[np.clip(ids, 0, None)]
        k = min(10, int(ok.sum()))
        np.testing.assert_array_equal(a.doc_ids[i].numpy()[:k], ids[ok][:k])
        np.testing.assert_array_equal(a.scores[i].numpy()[:k], sc[ok][:k])


def test_plans_cached_per_config_and_filter_digest(fixture_retrievers):
    _, tr, _ = fixture_retrievers
    n = tr.n_docs
    cfg = WarpSearchConfig(nprobe=8, k=10)
    a = tr.plan(cfg, dfilter=df.DocFilter.allow([1, 2], n))
    assert tr.plan(cfg, dfilter=df.DocFilter.deny([i for i in range(n) if i not in (1, 2)], n)) is a
    assert tr.plan(cfg) is not a and tr.plan(cfg, dfilter=df.DocFilter.allow([1], n)) is not a
    with pytest.raises(ValueError, match="covers"):
        tr.plan(cfg, dfilter=df.DocFilter.allow([1], n + 1))
    with pytest.raises(TypeError, match="DocFilter"):
        tr.plan(cfg, dfilter=[1, 2])
