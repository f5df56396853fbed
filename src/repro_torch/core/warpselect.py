"""WARP_SELECT: candidate generation + missing similarity imputation
(paper §4.3). Counterpart of ``repro/core/warpselect.py``.

``q @ Cᵀ`` is a plain matrix product (cuBLAS on the card, as the JAX
package leaves it to XLA). The top-``max(nprobe, k_impute)`` centroids per
query token give both the probe set and, through ``impute_mse``, the
missing similarity estimate. Leading batch dimensions pass straight
through: ``q`` may be ``[Q, D]`` or ``[B, Q, D]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["WarpSelectOut", "warp_select", "impute_mse", "topk_lower_index_first"]


class WarpSelectOut(NamedTuple):
    probe_scores: torch.Tensor  # f32[..., Q, nprobe]
    probe_cids: torch.Tensor  # i64[..., Q, nprobe]
    probe_sizes: torch.Tensor  # i64[..., Q, nprobe]
    mse: torch.Tensor  # f32[..., Q]
    top_scores: torch.Tensor  # f32[..., Q, kk]
    top_sizes: torch.Tensor  # i64[..., Q, kk]


def topk_lower_index_first(x: torch.Tensor, k: int):
    """Top-k of float32 ``x`` along the last axis, descending, equal values
    in ascending index order — the tie rule of ``jax.lax.top_k``, also for
    which of several tied values make the cut. ``torch.topk`` runs on one
    unique int64 key per entry: the float's bits mapped to a signed int of
    the same order, then the reversed position."""
    bits = x.float().contiguous().view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    pos = torch.arange(x.shape[-1], device=x.device)
    _, idx = torch.topk((ordered << 32) | (0xFFFFFFFF - pos), k, dim=-1, sorted=True)
    return torch.gather(x, -1, idx), idx


def impute_mse(
    scores: torch.Tensor,
    sizes: torch.Tensor,
    t_prime: int,
    qmask: torch.Tensor | None = None,
) -> torch.Tensor:
    """mse f32[...]: the score at the first position, in score-descending
    order, where the cumulative cluster size exceeds ``t_prime``; the
    smallest retained score when it never does. Masked tokens get 0."""
    s_sorted, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(torch.gather(sizes, -1, order), dim=-1)
    crossed = csum > int(t_prime)
    first = torch.argmax(crossed.to(torch.int32), dim=-1)
    first = torch.where(
        crossed.any(dim=-1), first, torch.full_like(first, scores.shape[-1] - 1)
    )
    mse = torch.gather(s_sorted, -1, first.unsqueeze(-1)).squeeze(-1)
    if qmask is not None:
        mse = torch.where(qmask, mse, torch.zeros_like(mse))
    return mse


def warp_select(
    q: torch.Tensor,
    centroids: torch.Tensor,
    cluster_sizes: torch.Tensor,
    *,
    nprobe: int,
    t_prime: int,
    k_impute: int,
    qmask: torch.Tensor | None = None,
) -> WarpSelectOut:
    """q f32[..., Q, D], centroids f32[C, D], cluster_sizes i32[C]."""
    kk = max(nprobe, k_impute)
    s_cq = torch.matmul(q, centroids.T)  # [..., Q, C]
    top_scores, top_cids = topk_lower_index_first(s_cq, kk)
    top_sizes = cluster_sizes.long()[top_cids]
    mse = impute_mse(top_scores, top_sizes, t_prime, qmask)
    return WarpSelectOut(
        probe_scores=top_scores[..., :nprobe],
        probe_cids=top_cids[..., :nprobe],
        probe_sizes=top_sizes[..., :nprobe],
        mse=mse,
        top_scores=top_scores,
        top_sizes=top_sizes,
    )
