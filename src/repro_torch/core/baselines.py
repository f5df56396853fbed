"""Baselines the paper compares against. Counterpart of
``repro/core/baselines.py``.

- ``maxsim_bruteforce``: exact ColBERT/XTR MaxSim over the uncompressed
  corpus, the quality oracle ("gold") of recall measurements.
- ``xtr_reference``: XTR's retrieve-then-impute scoring with exact token
  retrieval: the top-k' corpus tokens per query token, missing entries
  imputed with the lowest retrieved score of that query token.
- ``plaid_style_search``: WARP's candidate generation with *explicit*
  decompression (centroid + bucket weight per dimension, then a dot
  product), the PLAID-shaped path. Its doc ids equal the implicit
  engine's (the paper's Eq. 4-5 identity).

Top-k keeps ``jax.lax.top_k``'s tie order (``topk_lower_index_first``).
Each runs on ``device`` (None -> the card; pass ``device="cpu"`` for the
CPU) and raises without CUDA unless asked for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quantization
from repro_torch.core.engine import gather_candidates, resolve_config
from repro_torch.core.reduction import TopKResult, two_stage_reduce
from repro_torch.core.types import WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import topk_lower_index_first, warp_select

__all__ = ["maxsim_bruteforce", "xtr_reference", "plaid_style_search"]


def _on(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)


def maxsim_bruteforce(
    q, qmask, emb, token_doc_ids, *, n_docs: int, k: int, device=None
) -> TopKResult:
    """Exact sum of MaxSim: q f32[Q, D], qmask bool[Q], emb f32[N, D]
    (both normalized), token_doc_ids i32[N] -> top-k of n_docs. A document
    without tokens scores 0 per query token."""
    device = resolve_device(device)
    q, emb = _on(q, torch.float32, device), _on(emb, torch.float32, device)
    qmask = _on(qmask, torch.bool, device)
    docs = _on(token_doc_ids, torch.long, device)
    sim = emb @ q.T  # [N, Q]
    per_doc = torch.full((n_docs, q.shape[0]), float("-inf"), device=device)
    per_doc.scatter_reduce_(0, docs.unsqueeze(1).expand_as(sim), sim, "amax")
    per_doc = torch.where(torch.isfinite(per_doc), per_doc, 0.0)
    scores = (per_doc * qmask).sum(dim=-1)
    top_scores, top_docs = topk_lower_index_first(scores, k)
    return TopKResult(scores=top_scores, doc_ids=top_docs.to(torch.int32))


def xtr_reference(
    q, qmask, emb, token_doc_ids, *, k_prime: int, k: int, device=None
) -> TopKResult:
    """XTR scoring: each query token retrieves its top-``k_prime`` corpus
    tokens; missing (doc, token) entries take that token's lowest
    retrieved score."""
    device = resolve_device(device)
    q, emb = _on(q, torch.float32, device), _on(emb, torch.float32, device)
    qmask = _on(qmask, torch.bool, device)
    docs = _on(token_doc_ids, torch.int32, device)
    qm = q.shape[0]
    vals, idx = topk_lower_index_first(q @ emb.T, k_prime)  # [Q, k']
    mse = torch.where(qmask, vals[:, -1], 0.0)
    qtok = torch.arange(qm, device=device).unsqueeze(1).expand(qm, k_prime)
    valid = qmask.unsqueeze(1).expand(qm, k_prime)
    return two_stage_reduce(
        docs[idx].reshape(-1), qtok.reshape(-1), vals.reshape(-1), valid.reshape(-1),
        mse, q_max=qm, k=k,
    )


def plaid_style_search(
    index, q, qmask=None, config: WarpSearchConfig = WarpSearchConfig(), *, device=None
) -> TopKResult:
    """WARP_SELECT, then the probed clusters' codes decompressed explicitly
    (``quantization.decompress``) and scored by dot product, then the
    two-stage reduction. ``index`` is a ``WarpIndex`` or anything
    ``WarpIndex.from_arrays`` takes; it is moved to ``device`` as
    ``Retriever.from_index`` moves it."""
    device = resolve_device(device)
    if isinstance(index, WarpIndex):
        index = index.to(device)
    else:
        index = WarpIndex.from_arrays(index, device=device)
    config = resolve_config(index, config)
    q = _on(q, torch.float32, device)
    qmask = (
        torch.ones(q.shape[0], dtype=torch.bool, device=device)
        if qmask is None else _on(qmask, torch.bool, device)
    )
    qm, p, cap = q.shape[0], config.nprobe, index.cap
    sel = warp_select(
        q, index.centroids, index.cluster_sizes, nprobe=p,
        t_prime=config.t_prime, k_impute=config.k_impute, qmask=qmask,
    )
    packed, doc_ids, valid = gather_candidates(index, sel.probe_cids)
    centroid_vecs = index.centroids[sel.probe_cids]  # [Q, P, D]
    vecs = quantization.decompress(
        packed.reshape(qm, p * cap, -1),
        centroid_vecs.repeat_interleave(cap, dim=1),
        index.bucket_weights, nbits=index.nbits, dim=index.dim,
    )  # [Q, P * cap, D]
    cand = torch.einsum("qnd,qd->qn", vecs, q)
    valid = valid & qmask[:, None, None]
    qtok = torch.arange(qm, device=device)[:, None, None].expand(qm, p, cap)
    return two_stage_reduce(
        doc_ids.reshape(-1), qtok.reshape(-1), cand.reshape(-1), valid.reshape(-1),
        sel.mse, q_max=qm, k=config.k,
    )
