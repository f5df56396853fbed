#!/usr/bin/env python
"""nRecall@100 and success@5 of the port's index build and the JAX
package's, on the CPU, on the corpus of ``chip_smoke.py``'s build phase.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/build_recall_vs_jax.py [--queries 32]

Both packages build at ``IndexBuildConfig(nbits=4)`` defaults (2^13
centroids at ~258,000 tokens) from the same corpus; each build's WARP
retrieval (the JAX package at ``executor="reference"``) is scored against
exact MaxSim's top 10 (nRecall@100) and each query's relevant document
(success@5) at nprobe 32 and 256. It shows whether a recall the card
measures on that corpus comes from the build or from the corpus. Takes a
few minutes and ~6 GB.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the build phase's corpus constants)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--seed", type=int, default=5, help="chip_smoke's build seed (--seed 0 + 5)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from repro.core import IndexBuildConfig as JaxBuildConfig
    from repro.core import Retriever as JaxRetriever
    from repro.core import WarpSearchConfig as JaxConfig
    from repro.core import build_index as jax_build_index
    from repro_torch.core import (
        IndexBuildConfig, Retriever, WarpSearchConfig, build_index, maxsim_bruteforce,
    )
    from repro_torch.data import make_corpus, make_queries

    cs = chip_smoke
    corpus = make_corpus(
        cs.BUILD_DOCS, cs.ARCH["dim"], mean_doc_len=cs.BUILD_DOC_LEN, seed=args.seed,
        **cs.BUILD_TOPICS,
    )
    nq = args.queries
    q, qmask, rel = make_queries(
        corpus, n_queries=nq, query_maxlen=cs.ARCH["query_maxlen"], tokens_per_query=(8, 32),
        seed=args.seed + 1,
    )
    gold = [
        maxsim_bruteforce(q[i], qmask[i], corpus.emb, corpus.token_doc_ids,
                          n_docs=corpus.n_docs, k=10, device="cpu").doc_ids.numpy()
        for i in range(nq)
    ]

    def quality(ids):
        return (
            float(np.mean([cs.n_recall(np.asarray(ids[i]), gold[i]) for i in range(nq)])),
            float(np.mean([rel[i] in np.asarray(ids[i])[:5].tolist() for i in range(nq)])),
        )

    port = Retriever.from_index(
        build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, IndexBuildConfig(),
                    device="cpu"),
        device="cpu",
    )
    jax_r = JaxRetriever.from_index(
        jax_build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, JaxBuildConfig())
    )
    print(f"{corpus.n_tokens} tokens, {port.index.n_centroids} centroids, {nq} queries")
    for nprobe in (32, 256):
        search = dict(nprobe=nprobe, k=100, k_impute=max(64, nprobe), gather="fused",
                      layout="ragged")
        p_plan = port.plan(WarpSearchConfig(**search))
        j_plan = jax_r.plan(JaxConfig(executor="reference", **search))
        p_ids = [p_plan.retrieve(q[i], qmask[i]).doc_ids.numpy() for i in range(nq)]
        j_ids = [np.asarray(j_plan.retrieve(q[i], jnp.asarray(qmask[i])).doc_ids)
                 for i in range(nq)]
        print(f"nprobe {nprobe}: (nRecall@100, success@5) port build {quality(p_ids)}, "
              f"JAX build {quality(j_ids)}")


if __name__ == "__main__":
    main()
