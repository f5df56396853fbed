"""Retrieval quality of an index the port builds, against the JAX build of
the same corpus: nRecall@100 (``benchmarks/bench_quality.py``: the share of
exact MaxSim's top 10 found in the top 100) over 128 queries of the
``lifestyle_like`` tier, at the warp-xtr search config (nprobe 32, k 100,
k_impute 64). The two builds draw other k-means samples (the port's
``torch.Generator`` cannot replay JAX's PRNG), so their recall differs by
sampling; the port's may lie at most 0.02 below the JAX build's. Both are
printed.
"""

import numpy as np
import torch

from benchmarks.common import SETUPS, get_setup
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro_torch.core import (
    IndexBuildConfig,
    Retriever,
    WarpSearchConfig,
    build_index,
    maxsim_bruteforce,
)
from repro_torch.data import make_queries

torch.set_num_threads(1)  # xdist runs one test process per core

N_Q = 128
SEARCH = dict(nprobe=32, k=100, k_impute=64, gather="fused", layout="ragged")


def _n_recall(ids, gold):
    return len(set(ids[:100].tolist()) & set(gold[:10].tolist())) / 10


def test_port_build_recall_within_002_of_jax_build():
    corpus, jax_index, _, _, _ = get_setup("lifestyle_like")
    tier = SETUPS["lifestyle_like"]
    index = build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs,
        IndexBuildConfig(n_centroids=tier["n_centroids"], nbits=4, kmeans_iters=4),
        device="cpu",
    )
    # Eight active tokens per query (make_queries' default); a query_maxlen of
    # 8 draws the same queries as 32 without the masked padding.
    q, qmask, _ = make_queries(corpus, n_queries=N_Q, query_maxlen=8, seed=1)
    gold = [
        maxsim_bruteforce(
            q[i], qmask[i], corpus.emb, corpus.token_doc_ids, n_docs=corpus.n_docs, k=10,
            device="cpu",
        ).doc_ids.numpy()
        for i in range(N_Q)
    ]
    want = JaxRetriever.from_index(jax_index).plan(
        JaxConfig(executor="reference", **SEARCH)
    ).retrieve_batch(q, qmask)
    got = Retriever.from_index(index, device="cpu").plan(WarpSearchConfig(**SEARCH)).retrieve_batch(
        q, qmask
    )
    jax_recall = np.mean([_n_recall(np.asarray(want.doc_ids[i]), gold[i]) for i in range(N_Q)])
    port_recall = np.mean([_n_recall(got.doc_ids[i].numpy(), gold[i]) for i in range(N_Q)])
    print(f"nRecall@100 over {N_Q} lifestyle_like queries: JAX build {jax_recall:.4f}, "
          f"port build {port_recall:.4f}")
    assert port_recall >= jax_recall - 0.02
