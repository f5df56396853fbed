"""Two-stage reduction (paper §4.5). Counterpart of
``repro/core/reduction.py::two_stage_reduce`` with its ``impl="scan"``
semantics.

A stable sort on the int64 key ``doc * q_max + qtok`` (after a stable
sort by score) groups the candidates into (doc, query-token) runs that
end on their maximum (int64 never overflows here, so the JAX package's
int32 and two-key paths become one). Stage 1 reads each run's max at its
end; stage 2 sums the imputation-adjusted run maxima of each document:

    S_d = sum_i m_i + sum_{(i, d) present} (max_score_{i,d} - m_i)

as the difference of one float64 running sum at the document's two ends:
no atomics, so results do not change from run to run, and no segmented
scan (PyTorch's ``cummax`` runs a row in one block). Top-k breaks ties
toward the lower sorted position (the lower doc id), as
``jax.lax.top_k`` does. Inputs may carry leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.warpselect import topk_lower_index_first

__all__ = ["TopKResult", "two_stage_reduce", "KEY_SENTINEL"]

KEY_SENTINEL = 1 << 62
REDUCE_IMPLS = ("scan", "segment")


class TopKResult(NamedTuple):
    scores: torch.Tensor  # f32[..., k], -inf padded
    doc_ids: torch.Tensor  # i32[..., k], -1 padded


def _shifted(x: torch.Tensor, fill_prev: int, fill_next: int):
    """(x shifted right with ``fill_prev`` first, x shifted left with
    ``fill_next`` last) along the last axis."""
    lead = x.shape[:-1]
    prev = torch.cat([x.new_full((*lead, 1), fill_prev), x[..., :-1]], dim=-1)
    nxt = torch.cat([x[..., 1:], x.new_full((*lead, 1), fill_next)], dim=-1)
    return prev, nxt


def two_stage_reduce(
    doc_ids: torch.Tensor,
    qtok_ids: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    mse: torch.Tensor,
    doc_mask: torch.Tensor | None = None,
    *,
    q_max: int,
    k: int,
    impl: str = "scan",
    pad_to_k: bool = False,
) -> TopKResult:
    """doc_ids/qtok_ids [..., N], scores f32[..., N], valid bool[..., N],
    mse f32[..., q_max] -> TopKResult of [..., k]. ``impl`` "segment" is
    accepted and gives the same result as "scan"; ``pad_to_k`` appends
    invalid entries when N < k instead of raising. ``doc_mask``
    (bool[n_docs], ``core/docfilter.py``) masks filtered documents'
    totals to -inf before the top-k; surviving documents' scores do not
    change."""
    if impl not in REDUCE_IMPLS:
        raise ValueError(f"impl={impl!r} not in {REDUCE_IMPLS}")
    n = doc_ids.shape[-1]
    if k > n:
        if not pad_to_k:
            raise ValueError(
                f"k={k} > candidate count {n} (flat entries; pass "
                "pad_to_k=True to pad a statically short candidate stream)"
            )
        pad = (0, k - n)
        doc_ids = torch.nn.functional.pad(doc_ids, pad)
        qtok_ids = torch.nn.functional.pad(qtok_ids, pad)
        scores = torch.nn.functional.pad(scores, pad)
        valid = torch.nn.functional.pad(valid, pad)  # False sorts last
        n = k
    lead = doc_ids.shape[:-1]
    dev = doc_ids.device
    rows = int(np.prod(lead, dtype=np.int64))
    key = torch.where(
        valid, doc_ids.long() * q_max + qtok_ids.long(),
        torch.full((), KEY_SENTINEL, dtype=torch.long, device=dev),
    )
    # Order by (key, score): a stable sort by score, then a stable sort by
    # key, so every (doc, qtok) run ends on its maximum (stage 1 needs no
    # scatter).
    scores = scores.float()
    by_score = torch.argsort(scores, dim=-1, stable=True)
    key_sorted, by_key = torch.sort(torch.gather(key, -1, by_score), dim=-1, stable=True)
    scores_sorted = torch.gather(scores, -1, torch.gather(by_score, -1, by_key))
    valid_sorted = key_sorted != KEY_SENTINEL
    qtok = torch.where(valid_sorted, key_sorted % q_max, 0)
    docid = torch.where(valid_sorted, key_sorted // q_max, KEY_SENTINEL)

    next_key = _shifted(key_sorted, -1, -2)[1]
    run_end = key_sorted != next_key
    prev_doc, next_doc = _shifted(docid, -1, -2)
    doc_start = docid != prev_doc  # every row starts a run
    doc_end = (docid != next_doc) & valid_sorted
    mse_q = torch.gather(mse.float(), -1, qtok)
    adj = torch.where(run_end & valid_sorted, scores_sorted - mse_q, 0.0)

    # Stage 2: a document's total is the difference of one running sum at
    # its two ends. The scans run over the flattened rows (one pass; doc
    # runs never cross a row because each row starts one).
    flat_start = doc_start.reshape(-1)
    csum = torch.cumsum(adj.reshape(-1).double(), 0)
    run_no = torch.cumsum(flat_start.long(), 0) - 1
    pos = torch.arange(rows * n, device=dev)
    # First position of each doc run: starts write to their run's slot,
    # every other entry to a private slot, so no two writes collide.
    first = torch.empty(2 * rows * n, dtype=torch.long, device=dev)
    first.scatter_(0, torch.where(flat_start, run_no, rows * n + pos), pos)
    start = first[run_no]
    before = torch.where(start > 0, csum[(start - 1).clamp_min(0)], 0.0)
    total = (csum - before).float().reshape(docid.shape)
    total = total + mse.float().sum(dim=-1, keepdim=True)

    if doc_mask is not None:
        # Invalid rows carry KEY_SENTINEL doc ids (doc_end is already
        # False there): clamp for the gather.
        doc_end = doc_end & doc_mask[docid.clamp(0, doc_mask.shape[0] - 1)]
    final = torch.where(doc_end, total, float("-inf"))
    top_scores, top_idx = topk_lower_index_first(final, k)
    top_docs = torch.where(
        torch.isfinite(top_scores), torch.gather(docid, -1, top_idx), -1
    ).to(torch.int32)
    return TopKResult(scores=top_scores, doc_ids=top_docs)
