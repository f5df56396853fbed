"""Index construction (paper §4.1): cluster, quantize, lay out
CSR-by-cluster. Counterpart of ``repro/core/index.py``.

The build lives in ``repro_torch.store.builder`` as a chunked pipeline;
``build_index`` is the in-memory wrapper (one chunk spanning the whole
corpus). The chunked build does not depend on the chunking, so both entry
points build the same index.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.types import IndexBuildConfig, WarpIndex, resolve_device

__all__ = ["build_index", "index_stats"]


def build_index(
    embeddings,
    token_doc_ids,
    n_docs: int,
    config: IndexBuildConfig = IndexBuildConfig(),
    *,
    device=None,
) -> WarpIndex:
    """embeddings f32[N, D] (any scale; normalized here), token_doc_ids
    i32[N] mapping each token to its document -> a ``WarpIndex`` on
    ``device`` (None -> the card; pass ``device="cpu"`` for the CPU)."""
    from repro_torch.store import builder  # the store depends on core's types

    device = resolve_device(device)
    n_tokens = embeddings.shape[0]
    if np.shape(token_doc_ids) != (n_tokens,):
        raise ValueError("token_doc_ids must align with embeddings")
    return builder.build_index_chunked(
        builder.array_chunks(embeddings, token_doc_ids, chunk_size=None),
        n_docs, config, n_tokens=int(n_tokens), dim=int(embeddings.shape[1]),
        device=device,
    )


def index_stats(index: WarpIndex) -> dict:
    sizes = index.cluster_sizes.cpu().numpy()
    return {
        "n_tokens": index.n_tokens,
        "n_docs": index.n_docs,
        "n_centroids": index.n_centroids,
        "nbits": index.nbits,
        "cap": index.cap,
        "mean_cluster": float(sizes.mean()),
        "p99_cluster": float(np.percentile(sizes, 99)),
        "bytes": index.nbytes(),
        "bytes_per_token": index.nbytes() / max(1, index.n_tokens),
    }
