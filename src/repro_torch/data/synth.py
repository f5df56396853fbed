"""Synthetic multi-vector corpora for quality/latency experiments (the
port's own copy of ``repro/data/synth.py``; numpy only, same draws from
the same seed).

Real LoTTE/BEIR corpora are not available offline, so quality claims are
validated against an exact oracle on *clustered* synthetic data: documents
draw their token embeddings from a mixture of latent topic directions plus
noise, and queries are perturbed copies of tokens from a designated
"relevant" document — giving a non-trivial nearest-neighbor structure that
exercises the same failure modes (cluster boundary effects, imputation
error) the paper's datasets do.

``topic_skew`` adds the heavy-tailed routing structure of real corpora:
topic popularity follows a Zipf law (P(topic r) ∝ r^-skew), so the
k-means clusters the index builds over these embeddings inherit the skew —
a few head clusters hold a large share of the tokens while the tail stays
small. This is the regime CITADEL's dynamic lexical routing and XTR's
token-retrieval analysis describe, and the one where query-adaptive ragged
worklists beat the static worst-case bound: the static bound must cover a
query probing the head clusters, while most queries probe mostly-tail
clusters and need a fraction of it. The default ``topic_skew=0`` keeps the
historical balanced behavior (uniform topics) for existing tiers/tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SynthCorpus", "make_corpus", "make_queries"]


@dataclasses.dataclass(frozen=True)
class SynthCorpus:
    emb: np.ndarray  # f32[n_tokens, dim] L2-normalized token embeddings
    token_doc_ids: np.ndarray  # i32[n_tokens]
    doc_lens: np.ndarray  # i32[n_docs]
    topic_of_doc: np.ndarray  # i32[n_docs]

    @property
    def n_docs(self) -> int:
        return len(self.doc_lens)

    @property
    def n_tokens(self) -> int:
        return len(self.token_doc_ids)


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def make_corpus(
    n_docs: int = 512,
    dim: int = 128,
    *,
    mean_doc_len: int = 24,
    n_topics: int = 32,
    topic_strength: float = 2.0,
    topic_skew: float = 0.0,
    seed: int = 0,
) -> SynthCorpus:
    """``topic_skew > 0`` draws each document's topic from a Zipf law
    (P(topic r) ∝ (r+1)^-skew) instead of uniformly, so index cluster
    sizes become heavy-tailed like skew-routed real corpora; 0 (default)
    keeps balanced topics."""
    rng = np.random.default_rng(seed)
    topics = _normalize(rng.standard_normal((n_topics, dim), dtype=np.float32))
    doc_lens = np.maximum(4, rng.poisson(mean_doc_len, n_docs)).astype(np.int32)
    if topic_skew > 0.0:
        p = np.arange(1, n_topics + 1, dtype=np.float64) ** -topic_skew
        p /= p.sum()
        topic_of_doc = rng.choice(n_topics, n_docs, p=p).astype(np.int32)
    else:
        topic_of_doc = rng.integers(0, n_topics, n_docs).astype(np.int32)

    n_tokens = int(doc_lens.sum())
    token_doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), doc_lens)
    noise = rng.standard_normal((n_tokens, dim), dtype=np.float32)
    emb = topic_strength * topics[topic_of_doc[token_doc_ids]] + noise
    return SynthCorpus(
        emb=_normalize(emb).astype(np.float32),
        token_doc_ids=token_doc_ids,
        doc_lens=doc_lens,
        topic_of_doc=topic_of_doc,
    )


def make_queries(
    corpus: SynthCorpus,
    n_queries: int = 16,
    *,
    query_maxlen: int = 32,
    tokens_per_query: int | tuple[int, int] = 8,
    noise: float = 0.35,
    seed: int = 1,
):
    """Queries as noisy copies of tokens from a sampled "relevant" doc.

    ``tokens_per_query`` may be an ``(lo, hi)`` range: each query then
    draws its active-token count uniformly from ``[lo, hi]`` — the
    varied-length traffic that spreads adaptive worklist demand across
    ladder rungs (a short query probes as many clusters per token but
    amortizes over fewer active tokens).

    Returns (q f32[n_queries, query_maxlen, dim], qmask bool[..., maxlen],
    relevant_doc i32[n_queries]).
    """
    rng = np.random.default_rng(seed)
    n_docs = corpus.n_docs
    dim = corpus.emb.shape[1]
    doc_offsets = np.concatenate([[0], np.cumsum(corpus.doc_lens)])

    q = np.zeros((n_queries, query_maxlen, dim), np.float32)
    qmask = np.zeros((n_queries, query_maxlen), bool)
    relevant = rng.integers(0, n_docs, n_queries).astype(np.int32)
    for i, d in enumerate(relevant):
        lo, hi = doc_offsets[d], doc_offsets[d + 1]
        want = (
            int(rng.integers(tokens_per_query[0], tokens_per_query[1] + 1))
            if isinstance(tokens_per_query, tuple)
            else tokens_per_query
        )
        n_tok = min(want, hi - lo, query_maxlen)
        picks = rng.choice(np.arange(lo, hi), size=n_tok, replace=False)
        vecs = corpus.emb[picks] + noise * rng.standard_normal((n_tok, dim)).astype(
            np.float32
        )
        q[i, :n_tok] = _normalize(vecs)
        qmask[i, :n_tok] = True
    return q, qmask, relevant
