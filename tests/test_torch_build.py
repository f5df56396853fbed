"""Port parity of the index build: ``repro_torch``'s k-means, residual codec
and chunked builder against the JAX package on the same numpy inputs.

- k-means: the port's ``lloyd_step`` chain, fed JAX's initial permutation
  and reseed indices (``jax.random`` with ``repro/core/kmeans.py``'s key
  splits), against ``repro.core.kmeans``: assignments identical except
  points whose reference top-2 dot products lie within 1e-6 (counted and
  printed), centroids within 1e-5.
- ``compute_buckets`` bit-identical to ``jnp.quantile`` at nbits 2, 4, 8
  up to a 2^22-value sample; ``encode_residuals`` identical, values equal
  to a cutoff included.
- The build: given the JAX build's centroids and its normalized
  embeddings, the port's assign and scatter passes give bit-identical
  cutoffs and weights and identical codes, doc ids and CSR. (Normalization
  is held apart, within 2^-21 relative: XLA's CPU ``rsqrt`` is within one
  ulp, not correctly rounded, and its float32 sum of squares runs in
  another order, so it is not reproducible bit for bit.) The port's own
  build does not depend on ``chunk_size`` and is the same for the same
  seed.
- The store: what the port writes, the JAX package loads and verifies;
  ``save_index`` of the same arrays writes the same bytes.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import build_index as jax_build_index
from repro.core import index_stats as jax_index_stats
from repro.core import kmeans as jk
from repro.core import quantization as jq
from repro.store import inspect_index as jax_inspect_index
from repro.store import load_index as jax_load_index
from repro.store import save_index as jax_save_index
from repro.store import StoreCorruption as JaxStoreCorruption
from repro.store import verify_store as jax_verify_store
from repro_torch.core import IndexBuildConfig, WarpIndex, build_index, index_stats, kmeans
from repro_torch.core import quantization as tq
from repro_torch.data import make_corpus
from repro_torch.store import (
    StoreCorruption,
    array_chunks,
    build_index_chunked,
    build_index_to_store,
    inspect_index,
    load_index,
    save_index,
    verify_store,
)
from repro_torch.store import builder

torch.set_num_threads(1)  # xdist runs one test process per core

ARRAYS = (
    "centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
    "cluster_sizes", "bucket_weights", "bucket_cutoffs",
)
STATIC = ("dim", "nbits", "cap", "n_docs", "n_tokens")
CFG = dict(n_centroids=64, nbits=4, kmeans_iters=3)
NEAR_TIE = 1e-6


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(n_docs=300, mean_doc_len=20, seed=0)


@pytest.fixture(scope="module")
def jax_index(corpus):
    return jax_build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, JaxBuildConfig(**CFG))


@pytest.fixture(scope="module")
def port_index(corpus):
    return build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(**CFG), device="cpu"
    )


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same_index(a, b, fields=ARRAYS):
    for name in fields:
        x, y = _np(getattr(a, name)), _np(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in STATIC:
        assert getattr(a, name) == getattr(b, name), name


# ---- IndexBuildConfig -------------------------------------------------------


@pytest.mark.parametrize("n_tokens", [0, 1, 31, 1000, 262_000, 23_710_000])
def test_index_build_config_matches_jax(n_tokens):
    assert dataclasses.asdict(IndexBuildConfig()) == dataclasses.asdict(JaxBuildConfig())
    for kw in ({}, {"n_centroids": 77}):
        assert IndexBuildConfig(**kw).resolved_n_centroids(n_tokens) == JaxBuildConfig(
            **kw
        ).resolved_n_centroids(n_tokens)


# ---- k-means ----------------------------------------------------------------


def test_l2_normalize_close_to_jax(corpus):
    """Within 2^-21 relative (4 float32 ulps): JAX's rsqrt is off by up to
    one ulp and its float32 sum of 128 squares by a few. The port's is two
    roundings (the inverse norm, the product) from the exact value."""
    rng = np.random.default_rng(5)
    for x in (corpus.emb, 3 * rng.standard_normal((500, 128)).astype(np.float32)):
        want = np.asarray(jk.l2_normalize(jnp.asarray(x)))
        got = kmeans.l2_normalize(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=2.0**-21, atol=0)
        exact = x / np.sqrt((x.astype(np.float64) ** 2).sum(-1, keepdims=True))
        np.testing.assert_allclose(got, exact, rtol=2.0**-22, atol=0)


def _ref_top2_gap(points, centroids):
    s = np.sort(np.asarray(points @ centroids.T), axis=-1)
    return s[:, -1] - s[:, -2]


@pytest.mark.parametrize("iters", [4])
def test_lloyd_steps_match_jax_kmeans(corpus, iters):
    """JAX's draws (kmeans.py: ``init_key, *step_keys = split(key, iters +
    1)``; the permutation's first k; each step's ``randint``) fed to the
    port's ``lloyd_step`` chain."""
    sample = corpus.emb[:2000]
    k, key = 64, jax.random.PRNGKey(3)
    init_key, *step_keys = jax.random.split(key, iters + 1)
    perm = np.asarray(jax.random.permutation(init_key, sample.shape[0])[:k])
    want_final = np.asarray(jk.spherical_kmeans(key, jnp.asarray(sample), k, iters=iters))

    jpoints = jk.l2_normalize(jnp.asarray(sample))
    jcent = jpoints[perm]
    points = kmeans.l2_normalize(torch.from_numpy(sample))
    cent = points[torch.from_numpy(perm.astype(np.int64))]
    ties = 0
    for i in range(iters):
        reseed = np.asarray(jax.random.randint(step_keys[i], (k,), 0, sample.shape[0]))
        want_assign = np.asarray(jnp.argmax(jpoints @ jcent.T, axis=-1))
        got_assign = kmeans.assign_clusters(points, cent).numpy()
        differ = want_assign != got_assign
        gap = _ref_top2_gap(jpoints, jcent)
        assert (gap[differ] <= NEAR_TIE).all(), f"step {i}: a non-tie assignment differs"
        ties += int(differ.sum())
        jcent = jk._lloyd_step(jpoints, jcent, step_keys[i], k=k)
        cent = kmeans.lloyd_step(points, cent, torch.from_numpy(reseed.astype(np.int64)))
        np.testing.assert_allclose(cent.numpy(), np.asarray(jcent), rtol=0, atol=1e-5)
    print(f"k-means: {ties} assignments differ, each at a near-tie")
    np.testing.assert_allclose(cent.numpy(), want_final, rtol=0, atol=1e-5)


def test_assign_clusters_ignores_block_and_takes_first_max():
    rng = np.random.default_rng(0)
    pts = kmeans.l2_normalize(torch.from_numpy(rng.standard_normal((301, 16)).astype(np.float32)))
    cent = kmeans.l2_normalize(torch.from_numpy(rng.standard_normal((40, 16)).astype(np.float32)))
    cent[7] = cent[3]  # exact duplicate: every tie goes to the lower index
    base = kmeans.assign_clusters(pts, cent)
    assert not (base == 7).any()
    for block in (1, 8, 64, 4096):
        assert torch.equal(kmeans.assign_clusters(pts, cent, block=block), base)
    assert torch.equal(
        torch.cat([kmeans.assign_clusters(pts[:100], cent), kmeans.assign_clusters(pts[100:], cent)]),
        base,
    )
    assert kmeans.assign_block(1 << 17) == 2048 and kmeans.assign_block(64) == 4096


def test_lloyd_step_sums_are_order_free():
    """The fixed-point sums do not depend on the order of the points."""
    rng = np.random.default_rng(1)
    pts = kmeans.l2_normalize(torch.from_numpy(rng.standard_normal((500, 8)).astype(np.float32)))
    assign = torch.from_numpy(rng.integers(0, 9, 500))
    sums, counts = kmeans.cluster_sums(pts, assign, 10)
    perm = torch.from_numpy(rng.permutation(500))
    sums_p, counts_p = kmeans.cluster_sums(pts[perm], assign[perm], 10)
    assert torch.equal(sums, sums_p) and torch.equal(counts, counts_p)
    assert counts[9] == 0 and (sums[9] == 0).all()
    exact = np.zeros((10, 8))
    np.add.at(exact, assign.numpy(), pts.numpy().astype(np.float64))
    np.testing.assert_allclose(sums.numpy(), exact, rtol=0, atol=1e-9)


def test_spherical_kmeans_draws_from_its_generator(corpus):
    pts = torch.from_numpy(corpus.emb[:600])

    def run(seed):
        return kmeans.spherical_kmeans(pts, 32, iters=2, generator=torch.Generator().manual_seed(seed))

    a, b = run(0), run(0)
    assert torch.equal(a, b) and not torch.equal(a, run(1))
    np.testing.assert_allclose(a.norm(dim=1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="k=601"):
        kmeans.spherical_kmeans(pts, 601, generator=torch.Generator())


# ---- the codec ----------------------------------------------------------------


def _residual_sample(n, seed, ties):
    x = (0.05 * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)
    return np.round(x, 3).astype(np.float32) if ties else x


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("n, ties", [(1000, False), (4097, True), (1 << 22, False)])
def test_compute_buckets_bit_identical_to_jax(nbits, n, ties):
    flat = _residual_sample(n, nbits + n, ties)
    want_c, want_w = (np.asarray(a) for a in jq.compute_buckets(jnp.asarray(flat), nbits))
    got_c, got_w = tq.compute_buckets(torch.from_numpy(flat), nbits)
    assert got_c.dtype == torch.float32 and got_c.shape == ((1 << nbits) - 1,)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_w.numpy(), want_w)


def test_compute_buckets_nan_and_empty():
    flat = np.array([0.1, np.nan, -0.2], np.float32)
    want = np.asarray(jq.compute_buckets(jnp.asarray(flat), 2)[0])
    got = tq.compute_buckets(torch.from_numpy(flat), 2)[0].numpy()
    assert np.isnan(want).all() and np.isnan(got).all()
    with pytest.raises(ValueError, match="at least one"):
        tq.compute_buckets(torch.zeros(0), 4)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_encode_residuals_identical_to_jax(nbits):
    rng = np.random.default_rng(nbits)
    flat = _residual_sample(20000, nbits, False)
    cut = np.array(jq.compute_buckets(jnp.asarray(flat), nbits)[0])
    vals = np.concatenate([
        flat[:4000], cut, np.nextafter(cut, -1), np.nextafter(cut, 1),
        [-1.0, 1.0, 0.0, -0.0], rng.choice(cut, 500),
    ]).astype(np.float32).reshape(1, -1)
    want = np.asarray(jq.encode_residuals(jnp.asarray(vals), jnp.asarray(cut)))
    got = tq.encode_residuals(torch.from_numpy(vals), torch.from_numpy(cut))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the build ------------------------------------------------------------------


@pytest.mark.parametrize("chunk_size", [None, 97])
def test_build_passes_match_jax_build(corpus, jax_index, chunk_size):
    """The JAX build's centroids and normalized embeddings through the
    port's assign, buckets and scatter passes (``builder.encode_corpus``)."""
    jnorm = np.asarray(jk.l2_normalize(jnp.asarray(corpus.emb)))
    src = array_chunks(jnorm, corpus.token_doc_ids, chunk_size)

    def normed():
        return ((torch.from_numpy(np.array(e)), np.asarray(t, np.int32)) for e, t in src())

    n = corpus.n_tokens
    assign, docs = np.empty(n, np.int32), np.empty(n, np.int32)
    packed = np.empty_like(np.asarray(jax_index.packed_codes))
    small = builder.encode_corpus(
        normed, torch.from_numpy(np.array(jax_index.centroids)), CFG["nbits"], n,
        assign_out=assign, packed_out=packed, docs_out=docs,
    )
    want_assign = np.asarray(jnp.argmax(jnp.asarray(jnorm) @ jax_index.centroids.T, axis=-1))
    np.testing.assert_array_equal(assign, want_assign)
    for name, got in small.items():
        np.testing.assert_array_equal(got, np.asarray(getattr(jax_index, name)), err_msg=name)
    assert int(small["cluster_sizes"].max()) == jax_index.cap
    np.testing.assert_array_equal(packed, np.asarray(jax_index.packed_codes))
    np.testing.assert_array_equal(docs, np.asarray(jax_index.token_doc_ids))


def test_port_build_geometry(corpus, port_index, jax_index):
    idx = port_index
    offs, sizes = idx.cluster_offsets.numpy(), idx.cluster_sizes.numpy()
    assert offs[0] == 0 and offs[-1] == corpus.n_tokens
    np.testing.assert_array_equal(np.diff(offs), sizes)
    assert idx.cap == sizes.max() and idx.n_centroids == jax_index.n_centroids
    np.testing.assert_allclose(idx.centroids.norm(dim=1).numpy(), 1.0, atol=1e-4)
    np.testing.assert_array_equal(np.sort(idx.token_doc_ids.numpy()), corpus.token_doc_ids)
    # Every token's code row decodes to within a bucket of its residual.
    assert idx.packed_codes.shape == (corpus.n_tokens, 64)
    stats, jstats = index_stats(idx), jax_index_stats(jax_index)
    assert stats.keys() == jstats.keys()
    for key in ("n_tokens", "n_docs", "n_centroids", "nbits", "bytes", "bytes_per_token"):
        assert stats[key] == jstats[key], key


@pytest.mark.parametrize("chunk_size", [97, 1024])
def test_port_build_independent_of_chunk_size(corpus, port_index, chunk_size):
    chunked = build_index_chunked(
        array_chunks(corpus.emb, corpus.token_doc_ids, chunk_size), corpus.n_docs,
        IndexBuildConfig(**CFG), device="cpu",
    )
    assert_same_index(chunked, port_index)


def test_port_build_same_seed_same_index(corpus, port_index):
    again = build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(**CFG), device="cpu"
    )
    assert_same_index(again, port_index)
    other = build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(**CFG, seed=1),
        device="cpu",
    )
    assert not torch.equal(other.centroids, port_index.centroids)


def test_build_counts_tokens_itself_and_rejects_bad_sources(corpus, port_index):
    counted = build_index_chunked(
        array_chunks(corpus.emb, corpus.token_doc_ids, 333), corpus.n_docs,
        IndexBuildConfig(**CFG), device="cpu",
    )
    assert_same_index(counted, port_index)
    with pytest.raises(ValueError, match="align"):
        build_index(corpus.emb, corpus.token_doc_ids[:-1], corpus.n_docs, device="cpu")
    with pytest.raises(ValueError, match="empty corpus"):
        build_index(corpus.emb[:0], corpus.token_doc_ids[:0], 0, device="cpu")
    with pytest.raises(ValueError, match="n_tokens="):
        build_index_chunked(
            array_chunks(corpus.emb, corpus.token_doc_ids, 500), corpus.n_docs,
            IndexBuildConfig(**CFG), n_tokens=corpus.n_tokens + 1, dim=128, device="cpu",
        )


def test_build_takes_torch_tensors(corpus, port_index):
    idx = build_index(
        torch.from_numpy(corpus.emb), torch.from_numpy(corpus.token_doc_ids), corpus.n_docs,
        IndexBuildConfig(**CFG), device="cpu",
    )
    assert_same_index(idx, port_index)


# ---- the store ------------------------------------------------------------------


def test_store_build_loads_and_verifies_in_jax(corpus, port_index, tmp_path):
    out = str(tmp_path / "idx")
    stored = build_index_to_store(
        array_chunks(corpus.emb, corpus.token_doc_ids, 256), out, corpus.n_docs,
        IndexBuildConfig(**CFG), n_tokens=corpus.n_tokens, dim=128, device="cpu",
    )
    assert_same_index(stored, port_index)
    assert not os.path.exists(os.path.join(out, "arrays", "assign.scratch"))
    jidx = jax_load_index(out)
    assert_same_index(jidx, port_index)
    report = jax_verify_store(out, full=True)
    assert report == verify_store(out, full=True) and report["checked"] == 7
    assert inspect_index(out) == jax_inspect_index(out)
    manifest = json.load(open(os.path.join(out, "MANIFEST.json")))
    assert manifest["build_config"] == dataclasses.asdict(JaxBuildConfig(**CFG))
    with pytest.raises(FileExistsError):
        build_index_to_store(
            array_chunks(corpus.emb, corpus.token_doc_ids), out, corpus.n_docs,
            IndexBuildConfig(**CFG), device="cpu",
        )


def test_save_index_byte_identical_to_jax(jax_index, tmp_path):
    cfg = IndexBuildConfig(**CFG)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    save_index(WarpIndex.from_arrays(jax_index, device="cpu"), a, build_config=cfg)
    jax_save_index(jax_index, b, build_config=JaxBuildConfig(**CFG))
    names = sorted(os.listdir(os.path.join(b, "arrays")))
    assert sorted(os.listdir(os.path.join(a, "arrays"))) == names and len(names) == 7
    for name in names:
        with open(os.path.join(a, "arrays", name), "rb") as fa, open(
            os.path.join(b, "arrays", name), "rb"
        ) as fb:
            assert fa.read() == fb.read(), name
    with open(os.path.join(a, "MANIFEST.json")) as fa, open(os.path.join(b, "MANIFEST.json")) as fb:
        assert json.load(fa) == json.load(fb)
    assert_same_index(load_index(a, device="cpu"), jax_index)


def test_verify_store_names_a_flipped_byte(port_index, tmp_path):
    out = str(tmp_path / "s")
    save_index(port_index, out)
    path = os.path.join(out, "arrays", "packed_codes.bin")
    with open(path, "r+b") as f:
        f.seek(100_000)
        byte = f.read(1)
        f.seek(100_000)
        f.write(bytes([byte[0] ^ 1]))
    assert verify_store(out, full=False)["checked"] == 7  # past the head sample
    with pytest.raises(StoreCorruption, match="packed_codes"):
        verify_store(out, full=True)
    with pytest.raises(JaxStoreCorruption, match="packed_codes"):
        jax_verify_store(out, full=True)


def test_save_refuses_sharded_and_segmented(port_index, tmp_path):
    """A sharded index saves (and loads back as one); a segmented one is
    refused, as are objects that only look like a sharded index."""
    from repro_torch.core import ShardedWarpIndex, shard_index

    class Sharded:
        n_shards = 2

    class Segmented:
        segments = ()

    sharded = shard_index(port_index, 2)
    save_index(sharded, str(tmp_path / "a"))
    again = load_index(str(tmp_path / "a"), device="cpu")
    assert isinstance(again, ShardedWarpIndex) and again.n_shards == 2
    assert torch.equal(again.packed_codes, sharded.packed_codes)
    assert jax_inspect_index(str(tmp_path / "a"))["n_shards"] == 2
    with pytest.raises(TypeError, match="cannot save Sharded"):
        save_index(Sharded(), str(tmp_path / "a2"))
    with pytest.raises(TypeError, match="segmented indexes are saved via"):
        save_index(Segmented(), str(tmp_path / "b"))
    save_index(port_index, str(tmp_path / "c"))
    with pytest.raises(FileExistsError):
        save_index(port_index, str(tmp_path / "c"))
    save_index(port_index, str(tmp_path / "c"), overwrite=True)
