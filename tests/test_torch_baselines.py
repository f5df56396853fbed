"""Port parity of the paper's baselines and of stores the port builds:

- ``maxsim_bruteforce``, ``xtr_reference`` and ``plaid_style_search``
  against the JAX package's on the same inputs: doc ids identical, scores
  within 1e-5 (1e-4 for PLAID, which sums decompressed vectors);
- the paper's implicit = explicit decompression identity in the port
  (``Retriever`` against ``plaid_style_search``);
- a store the port builds, retrieved through the JAX ``Retriever`` and
  the port's at the four (gather, layout) configs: doc ids identical,
  scores within 1e-4;
- ``Retriever.build``, the ``repro_torch.launch.build_index`` CLI and the
  warp-xtr search config.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import warp_xtr as jax_warp_xtr
from repro.core import IndexBuildConfig as JaxBuildConfig
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import build_index as jax_build_index
from repro.core import maxsim_bruteforce as jax_maxsim
from repro.core import plaid_style_search as jax_plaid
from repro.core import xtr_reference as jax_xtr
from repro.store import load_index as jax_load_index
from repro_torch.configs import warp_xtr
from repro_torch.configs.warp_family import WARP_SHAPES
from repro_torch.core import (
    IndexBuildConfig,
    Retriever,
    WarpIndex,
    WarpSearchConfig,
    maxsim_bruteforce,
    plaid_style_search,
    xtr_reference,
)
from repro_torch.data import make_corpus, make_queries
from repro_torch.launch import build_index as cli
from repro_torch.store import array_chunks, build_index_to_store

torch.set_num_threads(1)  # xdist runs one test process per core

CFG = dict(n_centroids=64, nbits=4, kmeans_iters=3)
N_Q = 4
CONFIGS = [
    (gather, layout) for gather in ("materialize", "fused") for layout in ("dense", "ragged")
]


@pytest.fixture(scope="module")
def setup():
    corpus = make_corpus(n_docs=300, mean_doc_len=20, seed=0)
    q, qmask, rel = make_queries(corpus, n_queries=N_Q, query_maxlen=12, seed=1)
    jidx = jax_build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, JaxBuildConfig(**CFG))
    return corpus, q, qmask, jidx


@pytest.fixture(scope="module")
def store(setup, tmp_path_factory):
    corpus = setup[0]
    path = str(tmp_path_factory.mktemp("store") / "idx")
    build_index_to_store(
        array_chunks(corpus.emb, corpus.token_doc_ids, 500), path, corpus.n_docs,
        IndexBuildConfig(**CFG), device="cpu",
    )
    return path


def _same(got, want, tol):
    np.testing.assert_array_equal(got.doc_ids.cpu().numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(got.scores.cpu().numpy(), np.asarray(want.scores), rtol=tol, atol=tol)


@pytest.mark.parametrize("i", range(N_Q))
def test_maxsim_bruteforce_matches_jax(setup, i):
    corpus, q, qmask, _ = setup
    args = (q[i], qmask[i], corpus.emb, corpus.token_doc_ids)
    want = jax_maxsim(*(jnp.asarray(a) for a in args), n_docs=corpus.n_docs, k=20)
    got = maxsim_bruteforce(*args, n_docs=corpus.n_docs, k=20, device="cpu")
    assert got.doc_ids.dtype == torch.int32
    _same(got, want, 1e-5)


def test_maxsim_bruteforce_scores_empty_documents_zero(setup):
    corpus, q, qmask, _ = setup
    n_docs = corpus.n_docs + 5  # five documents without tokens
    want = jax_maxsim(
        jnp.asarray(q[0]), jnp.asarray(qmask[0]), jnp.asarray(corpus.emb),
        jnp.asarray(corpus.token_doc_ids), n_docs=n_docs, k=n_docs,
    )
    got = maxsim_bruteforce(
        q[0], qmask[0], corpus.emb, corpus.token_doc_ids, n_docs=n_docs, k=n_docs, device="cpu"
    )
    _same(got, want, 1e-5)


@pytest.mark.parametrize("i", range(N_Q))
def test_xtr_reference_matches_jax(setup, i):
    corpus, q, qmask, _ = setup
    k_prime = min(corpus.n_tokens, 4000)
    args = (q[i], qmask[i], corpus.emb, corpus.token_doc_ids)
    want = jax_xtr(*(jnp.asarray(a) for a in args), k_prime=k_prime, k=20)
    got = xtr_reference(*args, k_prime=k_prime, k=20, device="cpu")
    _same(got, want, 1e-5)


@pytest.mark.parametrize("i", range(N_Q))
def test_plaid_style_search_matches_jax(setup, i):
    _, q, qmask, jidx = setup
    cfg = dict(nprobe=16, k=20)
    want = jax_plaid(jidx, q[i], jnp.asarray(qmask[i]), JaxConfig(**cfg))
    got = plaid_style_search(jidx, q[i], qmask[i], WarpSearchConfig(**cfg), device="cpu")
    _same(got, want, 1e-4)


@pytest.mark.parametrize("gather, layout", CONFIGS)
def test_implicit_equals_explicit_decompression(setup, store, gather, layout):
    """Paper Eq. 4-5 in the port, on an index the port built."""
    _, q, qmask, _ = setup
    r = Retriever.from_store(store, device="cpu")
    cfg = WarpSearchConfig(nprobe=16, k=20, gather=gather, layout=layout)
    plan = r.plan(cfg)
    for i in range(N_Q):
        got = plan.retrieve(q[i], qmask[i])
        want = plaid_style_search(r.index, q[i], qmask[i], cfg, device="cpu")
        np.testing.assert_array_equal(got.doc_ids.numpy(), want.doc_ids.numpy())
        np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("gather, layout", CONFIGS)
def test_port_store_retrieves_as_in_jax(setup, store, gather, layout):
    _, q, qmask, _ = setup
    cfg = dict(nprobe=8, k=10, gather=gather, layout=layout)
    want = JaxRetriever.from_index(jax_load_index(store)).plan(
        JaxConfig(executor="reference", **cfg)
    ).retrieve_batch(q, qmask)
    got = Retriever.from_store(store, device="cpu").plan(WarpSearchConfig(**cfg)).retrieve_batch(
        q, qmask
    )
    _same(got, want, 1e-4)


def test_retriever_build(setup):
    corpus, q, qmask, _ = setup
    r = Retriever.build(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(**CFG), device="cpu"
    )
    assert isinstance(r.index, WarpIndex) and r.n_docs == corpus.n_docs
    res = r.plan(WarpSearchConfig(nprobe=8, k=10)).retrieve(q[0], qmask[0])
    assert ((res.doc_ids >= 0) & (res.doc_ids < corpus.n_docs)).all()
    sharded = Retriever.build(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(**CFG), n_shards=2,
        device="cpu",
    )
    assert sharded.is_sharded and sharded.n_shards == 2 and sharded.n_docs == corpus.n_docs
    res = sharded.plan(WarpSearchConfig(nprobe=8, k=10)).retrieve(q[0], qmask[0])
    assert ((res.doc_ids >= 0) & (res.doc_ids < corpus.n_docs)).all()


def test_cli_build_inspect_verify_smoke(tmp_path, capsys):
    out = str(tmp_path / "cli_idx")
    cli.main(["build", "--out", out, "--synth-docs", "120", "--n-centroids", "16",
              "--kmeans-iters", "2", "--device", "cpu"])
    assert "built warp_index" in capsys.readouterr().out
    cli.main(["inspect", "--index", out])
    assert '"n_segments": 0' in capsys.readouterr().out
    cli.main(["verify", "--index", out])
    assert "7 arrays ok" in capsys.readouterr().out
    cli.main(["smoke", "--index", out, "--device", "cpu"])
    assert "smoke top-5" in capsys.readouterr().out
    assert jax_load_index(out).n_docs == 120


@pytest.mark.parametrize("shape", sorted(WARP_SHAPES))
@pytest.mark.parametrize("reduced", [False, True])
def test_search_config_matches_jax_family(shape, reduced):
    arch = jax_warp_xtr.get_def()
    want = arch.family.search_config(arch, shape, reduced=reduced)
    got = warp_xtr.search_config(shape, reduced)
    for f in ("nprobe", "k", "k_impute", "t_prime"):
        assert getattr(got, f) == getattr(want, f), f
    assert dataclasses.asdict(warp_xtr.CONFIG) == dataclasses.asdict(jax_warp_xtr.CONFIG)
    assert dataclasses.asdict(warp_xtr.REDUCED) == dataclasses.asdict(jax_warp_xtr.REDUCED)
    assert warp_xtr.SOURCE == arch.source
