#!/usr/bin/env python
"""Write the committed cross-package fixture of the PyTorch port.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_torch_fixture.py

Builds the ``nfcorpus_like`` tier (``benchmarks/common.py::SETUPS``) with
the JAX package, saves it as a store under ``tests/data/torch_fixture/
store``, and records the JAX ``executor="reference"`` top-k of four
queries under three configs — (materialize, dense), (fused, dense),
(fused, ragged) — in ``expected.json`` (queries in ``queries.npz``).
``tests/test_torch_fixture.py`` checks that the JAX package still
reproduces it and that the port matches it on the CPU; ``chip_smoke.py``
matches it on the GPU. The whole fixture stays under 1 MB.
"""

from __future__ import annotations

import json
import os
import sys

os.environ.setdefault("REPRO_AUTOTUNE_TABLE", os.devnull)  # heuristic tiles

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_fixture")

TIER = dict(n_docs=250, mean_doc_len=16, n_centroids=64, kmeans_iters=4, nbits=4)
QUERIES = dict(n_queries=4, tokens_per_query=(4, 16), seed=5)
SEARCH = dict(nprobe=8, k=10)
CONFIGS = (
    ("materialize_dense", dict(gather="materialize", layout="dense")),
    ("fused_dense", dict(gather="fused", layout="dense")),
    ("fused_ragged", dict(gather="fused", layout="ragged")),
)


def build():
    """-> (JAX WarpIndex, q f32[4, 32, 128], qmask bool[4, 32])."""
    from repro.core import IndexBuildConfig, build_index
    from repro.data import make_corpus, make_queries

    corpus = make_corpus(TIER["n_docs"], mean_doc_len=TIER["mean_doc_len"], seed=0)
    index = build_index(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs,
        IndexBuildConfig(
            n_centroids=TIER["n_centroids"], nbits=TIER["nbits"],
            kmeans_iters=TIER["kmeans_iters"],
        ),
    )
    q, qmask, _ = make_queries(corpus, **QUERIES)
    return index, q, qmask


def expected_results(retriever, q, qmask) -> list[dict]:
    """JAX reference top-k of every config, JSON-ready."""
    from repro.core import WarpSearchConfig

    cases = []
    for name, strategy in CONFIGS:
        cfg = {**SEARCH, **strategy}
        res = retriever.plan(
            WarpSearchConfig(**cfg, executor="reference")
        ).retrieve_batch(q, qmask)
        cases.append({
            "name": name,
            "config": cfg,
            "doc_ids": np.asarray(res.doc_ids).tolist(),
            "scores": np.asarray(res.scores).astype(float).tolist(),
        })
    return cases


def main() -> int:
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro.core import Retriever
    from repro.store import save_index

    index, q, qmask = build()
    os.makedirs(OUT, exist_ok=True)
    save_index(index, os.path.join(OUT, "store"), overwrite=True)
    np.savez(os.path.join(OUT, "queries.npz"), q=q, qmask=qmask)
    r = Retriever.from_store(os.path.join(OUT, "store"))
    doc = {
        "about": "JAX executor='reference' top-k written by "
                 "scripts/make_torch_fixture.py",
        "tier": TIER,
        "queries": QUERIES,
        "cases": expected_results(r, q, qmask),
    }
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(doc, f, indent=1)
    total = sum(
        os.path.getsize(os.path.join(d, n))
        for d, _, names in os.walk(OUT) for n in names
    )
    print(f"wrote {OUT} ({total} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
