#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--profile] [--lm-seeds 1]

Drives the port's retrieval path at warp-xtr width on a synthetic index of
LoTTE Lifestyle geometry (``repro/configs/warp_family.py``,
``search_lifestyle``: 23.71M tokens, 119,461 docs, 2^17 centroids, cap
1024; D = 128, nbits = 4, 32 query tokens, nprobe 32, k 100, k_impute 64;
``repro_torch/configs/warp_xtr.py``), synthesised on the card from
``--seed`` (phase 7 builds a smaller index from embeddings):

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
     one process per source, in parallel) and hold each kernel against
     its plain PyTorch version at the main path's shapes, with timings and
     the bytes bound; the three scoring kernels also on code views at +1
     and +16 bytes, Q 128 and D 256 at nbits 8, the dense and ragged ones
     on skewed probe sizes and against two planted faults each that the
     checks must reject;
  2. retrieve through ``Retriever.plan(...).retrieve`` / ``retrieve_batch``
     for (materialize, dense), (fused, dense), (fused, ragged) and
     (materialize, ragged), each at executor "kernel" and "reference",
     128 timed queries per plan; the launch counts of this phase show the
     main path went through the kernels;
  3. serve requests of varied length through ``RetrievalServer``: a
     burst of 256 (drain throughput), then 256 Poisson arrivals at half
     that rate (submit-to-reply latency); every reply is held against
     ``plan.retrieve``;
  4. match the committed fixture (``tests/data/torch_fixture``, expected
     results written by the JAX package) on the card;
  5. segmented indexes (``segments``): the index saved, grown by 4 delta
     segments on the card, 1% tombstoned, served at the four configs,
     filtered and compacted (see ``phase_segments``);
  6. the retrieval server (``serving``): one ``RetrievalServer`` with two
     tenants (the store of phase 5 before compaction, through the
     segmented entry, and the in-memory index, through the ragged kernel),
     result and rung caches, an admission gate and metrics on; 1024
     open-loop Poisson arrivals at 0.7x the burst capacity, Zipf 1.6 over
     64 queries, 10% with a deadline, 25% with a 50% allowlist, 1% of the
     store's docs deleted midway; every reply held against
     ``plan.retrieve`` of its epoch and filter, hits against misses bit for
     bit; three injected faults (a failing reload, a quarantining reload, a
     failing kernel call: the batch's polls raise, nothing is answered);
     one ``maintain()``; 32 traced requests checked span by span; retrieve
     p50 with obs off, metrics and tracing; one run of
     ``repro_torch.launch.serve`` (see ``phase_serving``);
  6b. document-sharded search (``sharded``, after ``serving``): the
     index cut into 4 contiguous token-balanced document shards that keep
     its centroids and codec (``shard_index``), stacked on the card; 128
     queries single and batched at the four configs x both executors
     through ``Retriever.from_index(sharded).plan``, doc ids equal to the
     single index's (shared centroids make them so) up to reported tie
     swaps, exactly one scoring launch per shard per retrieve, p50 / p95
     beside the single index's; the sharded store saved, verified and
     reloaded bit for bit; a ``RetrievalServer`` over that store (a burst
     of 256, 256 Poisson arrivals, a 50% allowlist, a 1% delete), every
     reply equal to ``plan.retrieve``; ``launch.serve --n-shards 4``
     (see ``phase_sharded``); then ``encode``: the XTR token encoder at
     ``EncoderConfig`` defaults (12 layers, d 768) with random float32
     weights from ``--seed`` on 128 queries of 8-32 tokens at batch 1 and
     32 (unit rows, padding rows 0), the encoded queries retrieved over
     the sharded and the single index (ids equal up to ties), the encode
     p50 beside the retrieve p50 (see ``phase_encode``);
  7. the index build (``build``): a corpus at Lifestyle's mean document
     length (1,320 docs, ~262,000 tokens, D 128, zipf_like's topic skew)
     built on the card by ``build_index_to_store`` at
     ``IndexBuildConfig(nbits=4)`` defaults (2^13 centroids), each pass
     timed beside its fp32 bound; the store's CSR invariants and
     ``verify_store``; passes 2-3 again at another chunk_size and one
     Lloyd step twice, bit-identical; 128 queries retrieved from the
     store at the four configs x both executors (the scoring kernels'
     launches counted), WARP at the kernel executor held to
     ``plaid_style_search`` (implicit = explicit decompression), and
     nRecall@100 / success@5 of WARP, XTR and PLAID against exact MaxSim;
     then ``Retriever.build(n_shards=4)`` of the same corpus (kernel =
     reference executor, one launch per shard per retrieve, its
     nRecall@100 beside the single build's); then one assignment chunk of
     4,096 tokens timed against Lifestyle's 2^17 centroids, with the full
     build's assignment time it implies;
  8. LM generation (``lm``) at qwen2-0.5b full width and depth
     (``repro_torch/configs/qwen2_0_5b.py``: 24 layers, d 896, 14 heads,
     2 kv heads, head_dim 64, vocab 151,936; random bf16 weights from
     ``--seed``): the flash-attention kernel against its plain version at
     the prefill's shapes (and padded, windowed, non-causal and Dh 128
     ones), element by element, and planted faults the bf16 rule must
     reject; the kernel timed beside SDPA at the prefill's shape and the
     Dh 128 one, each in the contiguous layout and the model's own; then
     ``repro_torch.serving.generate`` on a 4 x 2048-token prompt for 32
     greedy tokens at executor "kernel" and "reference", with exactly one
     flash launch per layer per kernel ``generate``, and each executor's
     prefill tokens/s and profiled attention share of device time.
     Fed the same tokens (the reference's), the two executors must agree:
     the kernel at each layer's own attention inputs, the prefill KV cache
     per layer, and the logits at every step; tokens are identical or
     first differ at a reported near-tie of the reference's top-2 logits.
     ``--lm-seeds N`` repeats these checks on N weight seeds.
     Then the ``zoo`` step: qwen3-4b (36 layers) and yi-6b (32) on a
     4 x 2048 prompt, mixtral-8x7b (8 of its 32 layers) and dbrx-132b
     (4 of 40) at full width on 2 x 8192 (mixtral's 4096-token window
     binds in prefill and decode), random bf16 weights, the same checks
     and rates, with the MoE parity run teacher-forced in routing too
     (the kernel run's own router choices may part from the reference's
     only at a near-tie), two identical MoE prefills bit for bit, and the
     dropped (token, slot) pairs and free-run routing flips printed. The
     flash phase also holds, plants faults at and times the zoo's prefill
     shapes (Dh 128; mixtral's with its window at S 8192).
  9. recsys serving (``recsys``) at full width: the embedding-bag kernel
     against its plain version per element within
     ``ref.embedding_bag_error_bound`` at the path's shapes (int32 and
     int64 ids, zero weights, ids outside [0, V), an unaligned table
     view), two planted faults the limit must reject, and the kernel timed
     beside its plain version and ``F.embedding_bag``; then
     two-tower-retrieval (``repro_torch/configs/two_tower_retrieval.py``:
     user table 5M x 256, item table 2M x 256, tower MLP 1024-512-256;
     random weights from ``--seed``) through ``serve_step`` at serve_p99
     (512 users), serve_bulk (262,144) and retrieval_cand (one user
     against 1M candidates made by ``item_embed`` on the card) at executor
     "kernel" (two bag launches per serve step) and "reference", outputs
     within 1e-5 and the top-100 candidates identical up to a reported
     swap inside a tie; DIN, xDeepFM and SASRec at serve_p99 (their
     retrieval_cand shapes do not fit on one card).
 10. LM training (``train``): qwen2-0.5b at full width and depth (4 x
     4096, train_4k's sequence) and one mixtral-8x7b layer at full width
     (2 x 4096 in its 2 microbatches), float32 parameters and Adam state,
     bf16 compute, remat, batches from ``ShardedBatcher`` +
     ``synthetic_lm_fetch``: the step-1 loss equals the no-grad loss,
     every parameter gets a gradient, the loss falls over 10 steps on one
     repeated batch, microbatches 2 equal 1 (qwen2), a ``train_loop``
     killed at step 7 resumes from its step-5 checkpoint to the same bits,
     and ``launch.train`` runs and resumes on the card; train tokens/s,
     step p50, peak memory and attention's share of the step printed.

Top-k doc ids must be identical. A swap is allowed only between scores
tied within what the kernels' measured error allows (``tie_tolerance``),
and every one is reported.

Any failed check raises: the script exits non-zero and prints no result.
Its last three lines are the kernels JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``. It exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import warp_xtr  # noqa: E402  (fails outside a checkout of the repo)
from repro_torch.configs.warp_family import WARP_SHAPES  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # dense tensor cores

ARCH = dataclasses.asdict(warp_xtr.CONFIG)
_LIFESTYLE = WARP_SHAPES["search_lifestyle"]
GEOMETRY = dict(
    n_tokens=_LIFESTYLE.n_tokens, n_docs=_LIFESTYLE.n_docs,
    n_centroids=_LIFESTYLE.n_centroids, cap=_LIFESTYLE.cap,
)
CONFIGS = (
    ("materialize", "dense"), ("fused", "dense"), ("fused", "ragged"), ("materialize", "ragged"),
)
KERNEL_OF = {
    ("materialize", "dense"): "selective_sum",
    ("fused", "dense"): "fused_gather_score",
    ("fused", "ragged"): "ragged_fused_gather_score",
    # Scores the gathered copy of the worklist's rows with the worklist kernel.
    ("materialize", "ragged"): "ragged_fused_gather_score",
}
KERNEL_INFO = {
    "selective_sum": (
        "src/repro_torch/kernels/csrc/selective_sum.cu",
        "src/repro/kernels/decompress_score.py:72",
    ),
    "fused_gather_score": (
        "src/repro_torch/kernels/csrc/fused_gather_score.cu",
        "src/repro/kernels/fused_gather_score.py:312",
    ),
    "ragged_fused_gather_score": (
        "src/repro_torch/kernels/csrc/ragged_fused_gather_score.cu",
        "src/repro/kernels/fused_gather_score.py:537",
    ),
    # One launch over every segment: the JAX op replays the same TPU kernel
    # once per segment (repro/kernels/ops.py:388).
    "segmented_ragged_fused_gather_score": (
        "src/repro_torch/kernels/csrc/ragged_fused_gather_score.cu",
        "src/repro/kernels/fused_gather_score.py:537",
    ),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:85",
    ),
    "embedding_bag": (
        "src/repro_torch/kernels/csrc/embedding_bag.cu",
        "src/repro/kernels/embedding_bag.py:53",
    ),
}
TOL = 1e-4  # kernel vs plain version, and scores across executors
# The scoring kernels' times before the ragged kernel's move onto
# score_rows.cuh and the v-table chunks (the ragged kernel then still at
# half a warp per row, one block per 4 tiles), at this script's
# kernel-phase shapes on an H100 80GB HBM3 at 700 W, L2 flushed, median of
# 25 (PERF.md, section 6): printed beside each new time.
EARLIER_MS = {
    "selective_sum": 0.04963,
    "fused_gather_score": 0.02099,
    "ragged_fused_gather_score": 0.03558,
}

# LM phase: qwen2-0.5b generation. The prompt is 4 x 2048 random token ids.
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
# Flash kernel vs its plain version, element by element: float32 sums in
# another order (float32: abs limit); at bf16 both outputs are rounded once
# from float32 values that differ by far less than a bf16 ulp, so they may
# differ by one ulp of the larger, plus FLASH_BF16_ATOL for outputs near 0.
FLASH_F32_TOL = 1e-4
FLASH_BF16_ATOL = 1e-5
FLASH_CASES = (  # name, B, H, Hkv, S, Dh, causal, window
    ("qwen2", 4, 14, 2, 2048, 64, True, None),  # the prefill's shape: timed
    ("padded", 4, 14, 2, 1000, 64, True, None),
    ("window", 4, 14, 2, 2048, 64, True, 512),
    ("noncausal", 4, 14, 2, 1024, 64, False, None),
    # The zoo's prefill shapes (timed; qwen3's was the earlier dh128 case).
    ("qwen3", 4, 32, 8, 2048, 128, True, None),
    ("yi", 4, 32, 4, 2048, 128, True, None),
    ("mixtral", 2, 32, 8, 8192, 128, True, 4096),
    ("dbrx", 2, 48, 8, 8192, 128, True, None),
)
FLASH_TIMED = ("qwen2", "qwen3", "yi", "mixtral", "dbrx")  # each also rejects two planted faults
# Prefill and teacher-forced decode logits, kernel vs reference executor,
# and the top-2 gap that counts as a near-tie: 4 bf16 ulps at the logits'
# magnitude (4 to 8).
LM_LOGITS_TOL = 0.125
# Prefill KV cache, kernel vs reference executor, per layer: the norm of
# the difference relative to the reference's. Not a per-element ulp limit:
# one-ulp differences in a layer's attention flip bf16 roundings in every
# later layer, and the difference grows with depth (to ~2^-6 at layer 23).
LM_KV_TOL = 2.0 ** -5
# Zoo step of the lm phase: the registry's other LMs at full width, random
# bf16 weights from --seed, one arch at a time. Depth is cut only where
# the weights do not fit one 80 GB card: mixtral's 32 layers (2.90 GB
# each) and dbrx's 40 (6.52 GB each). The MoE prompts are longer than
# mixtral's 4096-token window, so it binds in prefill and in decode.
ZOO = (  # arch, layers run (None: all), batch, prompt length
    ("qwen3-4b", None, 4, 2048),
    ("yi-6b", None, 4, 2048),
    ("mixtral-8x7b", 8, 2, 8192),
    ("dbrx-132b", 4, 2, 8192),
)
# A router choice the kernel run would make apart from the reference's
# (teacher-forced tokens and routing) must sit at a near-tie: the
# reference's k-th and (k+1)-th router probabilities at most this far
# apart. The executors' hidden states differ by ~1e-2 of their norm at
# depth (LM_KV_TOL's error model), which moves a router logit by ~1e-2 and
# a probability by a quarter of that; 2^-5 leaves a margin of ~10.
MOE_FLIP_GAP = 2.0 ** -5

# Train phase: batches from ShardedBatcher + synthetic_lm_fetch at train_4k's
# sequence length (configs/families.py LM_SHAPES), float32 parameters and
# Adam state, each config's bf16 compute and remat. train_4k's global batch
# of 256 is cut to what one card holds beside float32 logits.
TRAIN_SEQ = 4096
TRAIN_RUNS = (  # arch, layers run (None: all), batch, microbatches
    ("qwen2-0.5b", None, 4, 1),
    ("mixtral-8x7b", 1, 2, 2),  # its train_microbatches
)
TRAIN_STEPS = 10  # on one repeated batch; the loss must fall
TRAIN_OPT = dict(lr=1e-3, warmup_steps=0)
TRAIN_RESUME_AT = (5, 7)  # checkpoint every 5 steps, a failure injected at step 7
# The step-1 loss against the no-grad loss: the same ops on the same
# inputs, so float32 round-off at most.
TRAIN_LOSS_TOL = 1e-6
# Microbatches 2 against 1 (qwen2; dense): the bf16 products run at other
# shapes and the weight gradients are rounded to bf16 per microbatch
# before the float32 sum, so the loss (a mean over 16k tokens) may move by
# ~1e-4 and the global gradient norm by ~2^-8. An MoE layer's capacity and
# aux loss are per microbatch (in JAX too), so mixtral's are reported only.
TRAIN_MB_LOSS_TOL = 2.0 ** -7
TRAIN_MB_GNORM_TOL = 2.0 ** -5

# Recsys phase: two-tower-retrieval at full width (serve_p99, serve_bulk,
# retrieval_cand); DIN, xDeepFM and SASRec at serve_p99. Embedding-bag
# kernel vs its plain version per element within
# ref.embedding_bag_error_bound; two-tower outputs (u, v, scores) across
# executors within RECSYS_TT_TOL abs (they are L2-normalised, ~1/16 an
# element); DIN and xDeepFM logits within RECSYS_LOGIT_TOL * max(1, |ref|).
RECSYS_TT_TOL = 1e-5
RECSYS_LOGIT_TOL = 1e-4
RECSYS_TOPK = 100
RECSYS_CAND_CHUNK = 262_144  # candidate embeddings made per item_embed call
RECSYS_P99_STEPS = 50  # timed serve_p99 steps per executor

# Build phase: a corpus at Lifestyle's mean document length (23,710,000
# tokens / 119,461 docs), D 128, with zipf_like's topic settings
# (benchmarks/common.py: heavy-tailed cluster sizes), built at
# IndexBuildConfig(nbits=4) defaults: 2^13 centroids and a 32,768-token
# k-means sample.
BUILD_DOCS = 1300  # ~258,000 tokens: at most 2^18, so the centroid rule gives 2^13
BUILD_DOC_LEN = round(_LIFESTYLE.n_tokens / _LIFESTYLE.n_docs)
BUILD_TOPICS = dict(topic_skew=1.6, n_topics=256, topic_strength=4.0)
BUILD_QUERIES = 128
BUILD_CHUNK_AGAIN = 12_345  # chunk_size of the passes' second run
XTR_K_PRIME = 4000  # bench_latency.py's k' for xtr_reference
WIDE_NPROBE = 256  # WARP's recall is also printed at this nprobe
LIFESTYLE_CHUNK = 4096  # tokens of the timed assignment chunk at 2^17 centroids

# Segments phase: the retrieval phases' Lifestyle index saved to a store,
# grown by SEG_DELTAS delta segments of SEG_DELTA_DOCS documents at
# Lifestyle's mean length (each ~1% of the base's tokens), and
# SEG_TOMBSTONE_FRAC of all doc ids tombstoned, half of them in the deltas.
SEG_DELTAS = 4
SEG_DELTA_DOCS = 1200
SEG_TOMBSTONE_FRAC = 0.01
SEG_QUERIES = 128
SEG_BATCHES = 4  # retrieve_batch calls of B 4 per plan
SEG_ALLOW_FRAC = 0.5

# Serving phase: one RetrievalServer with two tenants at Lifestyle width,
# open-loop Poisson arrivals at SERVE_LOAD x the burst capacity measured
# first, Zipf-skewed (the serve launcher's default skew) over a pool of
# SERVE_POOL queries; SERVE_DEADLINE_FRAC of the requests carry a deadline
# of SERVE_DEADLINE_S, SERVE_FILTER_FRAC a 50% allowlist.
SERVE_REQUESTS = 1024
SERVE_POOL = 64
SERVE_SKEW = 1.6
SERVE_LOAD = 0.7
SERVE_DEADLINE_FRAC = 0.10
SERVE_DEADLINE_S = 0.010
SERVE_FILTER_FRAC = 0.25
SERVE_DELETE_FRAC = 0.01
SERVE_TRACED = 32
SERVE_OBS_QUERIES = 128

# Sharded phase: the Lifestyle index cut into SHARDS document shards that
# keep its centroids and codec (``shard_index``); SHARD_QUERIES queries
# single and SHARD_BATCHES batches of 4 per plan; a server over the
# sharded store: a burst of SHARD_SERVE_REQUESTS, as many Poisson
# arrivals at half its rate, SHARD_FILTERED requests under a 50% allowlist
# and SHARD_FILTERED after deleting SHARD_DELETE_FRAC of the docs.
SHARDS = 4
SHARD_QUERIES = 128
SHARD_BATCHES = 4
SHARD_SERVE_REQUESTS = 256
SHARD_FILTERED = 32
SHARD_ALLOW_FRAC = 0.5
SHARD_DELETE_FRAC = 0.01
# Encode step: the token encoder at EncoderConfig defaults, float32;
# batch 1 and batch 32 must agree within ENCODE_TOL (float32 products of
# other shapes).
ENCODE_QUERIES = 128
ENCODE_BATCHES = (1, 32)
ENCODE_TOL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=1)
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def fail(msg: str) -> None:
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# synthetic index and queries, made on the card
# ---------------------------------------------------------------------------


def cluster_sizes(torch, g, n_clusters: int, n_tokens: int, cap: int, dev):
    """Heavy-tailed (log-normal) sizes in [1, cap] with max exactly cap
    and sum exactly n_tokens."""
    w = torch.exp(torch.randn(n_clusters, generator=g, device=dev, dtype=torch.float64))

    def sizes_at(alpha):
        return torch.clamp(torch.round(w * alpha), 1, cap).long()

    lo, hi = 0.0, 4.0 * cap / float(w.mean())
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if int(sizes_at(mid).sum()) < n_tokens:
            lo = mid
        else:
            hi = mid
    sizes = sizes_at(hi)
    excess = int(sizes.sum()) - n_tokens  # >= 0, small
    while excess > 0:
        room = torch.nonzero((sizes > 1) & (sizes < cap)).squeeze(1)
        pick = room[torch.randperm(room.numel(), generator=g, device=dev)[:excess]]
        sizes[pick] -= 1
        excess = int(sizes.sum()) - n_tokens
    if int(sizes.max()) != cap or int(sizes.sum()) != n_tokens:
        fail("synthetic cluster sizes missed their max/sum targets")
    return sizes


def make_index(torch, seed: int, dev):
    from repro_torch.core import WarpIndex

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, nbits = ARCH["dim"], ARCH["nbits"]
    n, c, cap = GEOMETRY["n_tokens"], GEOMETRY["n_centroids"], GEOMETRY["cap"]
    sizes = cluster_sizes(torch, g, c, n, cap, dev)
    offsets = torch.zeros(c + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    cent = torch.randn(c, d, generator=g, device=dev)
    cent = cent / cent.norm(dim=1, keepdim=True)
    codes = torch.randint(0, 256, (n, d * nbits // 8), generator=g, device=dev, dtype=torch.uint8)
    doc_ids = torch.randint(
        0, GEOMETRY["n_docs"], (n,), generator=g, device=dev, dtype=torch.int32
    )
    nb = 1 << nbits
    quant = torch.special.ndtri((torch.arange(nb, device=dev, dtype=torch.float64) + 0.5) / nb)
    cuts = torch.special.ndtri(torch.arange(1, nb, device=dev, dtype=torch.float64) / nb)
    return WarpIndex(
        centroids=cent,
        packed_codes=codes,
        token_doc_ids=doc_ids,
        cluster_offsets=offsets.int(),
        cluster_sizes=sizes.int(),
        bucket_weights=(0.05 * quant).float(),
        bucket_cutoffs=(0.05 * cuts).float(),
        dim=d, nbits=nbits, cap=cap, n_docs=GEOMETRY["n_docs"], n_tokens=n,
    )


def make_queries(torch, index, n: int, seed: int, *, lo=8, hi=32):
    """Noisy copies of random centroids; each query has lo..hi active
    tokens (the rest masked and zero)."""
    g = torch.Generator(device=index.device)
    g.manual_seed(seed)
    qm, d = ARCH["query_maxlen"], ARCH["dim"]
    cids = torch.randint(0, index.n_centroids, (n, qm), generator=g, device=index.device)
    q = index.centroids[cids] + 0.04 * torch.randn(n, qm, d, generator=g, device=index.device)
    q = q / q.norm(dim=-1, keepdim=True)
    active = torch.randint(lo, hi + 1, (n, 1), generator=g, device=index.device)
    qmask = torch.arange(qm, device=index.device) < active
    return q * qmask.unsqueeze(-1), qmask


# ---------------------------------------------------------------------------
# timing and comparison
# ---------------------------------------------------------------------------


def time_cuda(torch, fn, flush, iters: int = 25) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs,
    with the 50 MB L2 flushed (a 256 MB write) before each run."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def tie_tolerance(kernel_err: float, scores) -> float:
    """How far apart two doc scores may lie and still count as tied when
    two executors or batch shapes computed them: a doc's score sums one
    candidate score per query token, each off by at most the kernels'
    measured error, and is rounded once to float32 (one ulp at the
    largest score); doubled for margin."""
    top = np.abs(scores[np.isfinite(scores)]).max(initial=0.0)
    return 2.0 * (ARCH["query_maxlen"] * kernel_err + float(np.spacing(np.float32(top))))


def topk_swaps(what: str, ids_a, s_a, ids_b, s_b, kernel_err: float, *, tol=TOL, tie=None) -> int:
    """Positions where two top-k lists name different docs. Raises unless
    the scores agree within ``tol`` position by position and every such
    position lies in a run of scores tied within ``tie`` (by default
    ``tie_tolerance``) that also holds the other list's doc there (or, at
    the k-th place, whose score is tied with it)."""
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    s_a, s_b = np.asarray(s_a), np.asarray(s_b)
    if tie is None:
        tie = tie_tolerance(kernel_err, s_a)
    if not np.allclose(s_a, s_b, rtol=tol, atol=tol):
        fail(f"{what}: scores differ by more than {tol}")
    diff = np.flatnonzero(ids_a != ids_b)
    for ids_x, s_x, ids_y, s_y in ((ids_a, s_a, ids_b, s_b), (ids_b, s_b, ids_a, s_a)):
        for i in diff:
            run = np.flatnonzero(np.abs(s_x - s_x[i]) <= tie)
            at_cut = run[-1] == len(s_x) - 1 and abs(s_y[i] - s_x[i]) <= tie
            if not (ids_y[i] in ids_x[run] or at_cut):
                fail(
                    f"{what}: doc {ids_y[i]} at place {i} (score {float(s_y[i])!r}) vs doc "
                    f"{ids_x[i]} (score {float(s_x[i])!r}) is not a swap within a tie of {tie:.3g}"
                )
    if diff.size:
        log(f"[ties] {what}: places {diff.tolist()} swapped within a tie of {tie:.3g}")
    return int(diff.size)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def kernel_name(mangled: str) -> str:
    """``name<4, true, false>`` of an Itanium-mangled kernel symbol, with
    its integer and bool template arguments (``name`` alone where it has
    none; the symbol where it does not parse)."""
    names, i = [], mangled.find("N") + 1
    while 0 < i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j : j + n])
        i = j + n
    if not names:
        return mangled
    m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    if not m:
        return names[-1]
    args = [
        ("true" if v == "1" else "false") if t == "b" else v
        for t, v in re.findall(r"L([ib])(\d+)E", m.group(1))
    ]
    return f"{names[-1]}<{', '.join(args)}>"


def ptxas_report(log_path) -> list:
    """One line per kernel of an ``nvcc -Xptxas=-v`` log: its registers,
    stack and spills; and every warning or performance notice ptxas gave
    (a ``wgmma`` it had to serialize, say)."""
    lines, name, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if "Compiling entry function" in line:
                name = kernel_name(line.split("'")[1])
            elif "spill" in line and name:
                spill = line
            elif "registers" in line and name:
                lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {spill}")
                name = None
            elif "warning" in line.lower() or "Performance Loss" in line:
                lines.append(line)
    return lines


def lookup_wavefronts(nbits: int, layout: str, trials: int = 20000, seed: int = 0) -> float:
    """Mean shared-memory wavefronts of one warp-wide v-table lookup at
    D 128 over random codes (a bank serves one 32-bit word per wavefront;
    lanes reading one word share it). ``layout`` "row": one row per lane,
    all lanes at one dim d, word d * 2^b + code (csrc/score_rows.cuh).
    "half_warp" (the ragged kernel's design before it moved onto
    score_rows.cuh, nbits 4): 16 lanes per row, lane w at dim 8w + s of its
    row, word (8w + s) * 16 + code."""
    rng = np.random.default_rng(seed)
    nb = 1 << nbits
    codes = rng.integers(0, nb, (trials, 32))
    if layout == "row":
        words = rng.integers(0, 128, (trials, 1)) * nb + codes
    else:
        s = rng.integers(0, 8, (trials, 1))
        words = (8 * (np.arange(32) % 16) + s) * nb + codes
    words = np.sort(words, axis=1)
    first = np.ones_like(words, dtype=bool)
    first[:, 1:] = words[:, 1:] != words[:, :-1]  # each distinct word once
    per_bank = np.zeros((trials, 32), np.int64)
    np.add.at(per_bank, (np.nonzero(first)[0], (words % 32)[first]), 1)
    return float(per_bank.max(axis=1).mean())


def code_view(torch, codes, offset: int):
    """A copy of ``codes`` as a contiguous view ``offset`` bytes into a
    larger buffer (an unaligned base for offsets that are not 16-byte
    multiples)."""
    buf = torch.empty(codes.numel() + offset, dtype=torch.uint8, device=codes.device)
    view = buf[offset:].view(codes.shape)
    view.copy_(codes)
    return view


def check_scores(got, want, invalid=None):
    """(max abs err vs the plain version, the rule it breaks or None): every
    slot within TOL of the plain version, and the invalid ones exactly 0."""
    err = float((got - want).abs().max())
    if not err <= TOL:
        return err, f"max abs err {err} vs its plain version > {TOL}"
    if invalid is not None and bool((got[invalid] != 0).any()):
        return err, "an invalid slot is not exactly 0"
    return err, None


def kernel_probes(torch, index, cfg, n_queries: int, seed: int):
    """starts, sizes, probe scores, v-tables and probe ids of ``n_queries``
    queries of 32 active tokens, flattened to [32 * n_queries, ...]: the
    scoring kernels' inputs in the kernel phase."""
    from repro_torch.core import warpselect

    q, _ = make_queries(torch, index, n_queries, seed=seed, lo=32, hi=32)
    q = q.reshape(-1, q.shape[-1])
    sel = warpselect.warp_select(
        q, index.centroids, index.cluster_sizes, nprobe=cfg.nprobe,
        t_prime=cfg.t_prime, k_impute=cfg.k_impute,
    )
    return (
        index.cluster_offsets[sel.probe_cids].int().contiguous(),
        sel.probe_sizes.int().contiguous(),
        sel.probe_scores.float().contiguous(),
        (q.unsqueeze(-1) * index.bucket_weights).contiguous(),
        sel.probe_cids,
    )


def kernel_worklist(torch, cfg, st, sz, ps, tile_c: int, b: int = 1):
    """The worklist ``engine._ragged_block`` builds for ``b`` queries of
    32 tokens (probe arrays [32 * b, P]) at the adaptive rung, flat, qtok
    offset by query -> (TileWorklist, rung)."""
    from repro_torch.core import worklist as wl

    shape = (b, -1, st.shape[-1])
    st, sz, ps = (a.reshape(shape) for a in (st, sz, ps))
    tiles = wl.probe_tile_counts(sz.cpu().numpy(), tile_c)
    rung = wl.pick_bucket(cfg.worklist_buckets, wl.needed_worklist_tiles(tiles))
    work = wl.build_tile_worklist(st, sz, ps, tile_c=tile_c, tiles_per_qtoken=rung)
    qtok = work.qtok + (torch.arange(b, device=st.device) * st.shape[1]).unsqueeze(-1).int()
    flat = tuple(a.reshape(-1).contiguous() for a in (work.row0, work.nvalid, qtok, work.pscore))
    return wl.TileWorklist(*flat), rung


def phase_kernels(torch, index, plan_ragged, flush):
    """Each kernel against its plain version at the main path's shapes;
    the three scoring kernels also on unaligned code views, the batched
    Q = 128 and D 256 at nbits 8 (a v-table walked in chunks of
    dimensions); the dense and ragged kernels also on skewed probe sizes,
    with two planted faults each that the checks must reject; the ragged
    kernel also at tile_c 8, 16 and 64."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.decompress_score import selective_sum_cuda
    from repro_torch.kernels.flash_attention import TILE_K, bf16_smem_bytes
    from repro_torch.kernels.fused_gather_score import (
        fused_gather_score_cuda,
        ragged_fused_gather_score_cuda,
    )

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[kernels] built {len(paths)} libraries in {time.perf_counter() - t0:.1f}s")
    for name, path in paths.items():
        for line in ptxas_report(path.with_name(f"{name}.log")):
            log(f"[ptxas] {name}: {line}")
    log("[ptxas] flash_attention: flash_fwd_wgmma_kernel dynamic shared memory per block: "
        + ", ".join(f"Dh {dh} {bf16_smem_bytes(dh)} bytes" for dh in TILE_K))

    dev = index.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0])
    cfg = plan_ragged.config

    probes = functools.partial(kernel_probes, torch, index, cfg)
    starts, sizes, pscore, v, cids = probes(1, 12345)
    qm, p = starts.shape
    d, nbits, cap, pb = index.dim, index.nbits, index.cap, index.packed_codes.shape[1]
    nb = 1 << nbits
    rows = int(sizes.sum())
    vbytes = qm * d * nb * 4
    out = []

    def record(name, got, want, k_fn, p_fn, nbytes, ops, invalid=None, lookups=None):
        err, broken = check_scores(got, want, invalid)
        if broken:
            fail(f"{name}: {broken}")
        ms = time_cuda(torch, k_fn, flush)
        plain_ms = time_cuda(torch, p_fn, flush, iters=5)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        row = {
            "name": name,
            "route": "cuda",
            "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "launches": 0,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "bytes": int(nbytes),
        }
        log(f"[kernels] {json.dumps(row)}")
        # Beside the row, not in it: the earlier design's time and, where
        # the v-table lookups are a second floor, their time at one
        # conflict-free wavefront (32 lookups) per SM per clock.
        extra = {"earlier_ms": EARLIER_MS[name]} if name in EARLIER_MS else {}
        if lookups is not None:
            extra["lookup_floor_ms"] = lookups / (32 * n_sm * clock_hz) * 1e3
        log(f"[kernels] {name}: {json.dumps(extra)} beside bound_ms {row['bound_ms']:.5f} "
            f"({row['bound_by']}), ms {ms:.5f}; {n_sm} SMs at {clock_hz / 1e9:.3f} GHz max")
        out.append(row)

    def case(name, got, want, invalid=None):
        err, broken = check_scores(got, want, invalid)
        if broken:
            fail(f"{name}: {broken}")
        log(f"[kernels] {name}: max abs err {err} vs its plain version")

    def report_plan(name, *args):
        plan = _build.launch_plan(name, *args)
        warps = plan["threads"] // 32
        per_sm = plan["resident_blocks"] / n_sm
        # kStages - 1 = 2 chunks of 32 rows per warp load while one is scored
        in_flight = per_sm * warps * 2 * 32 * pb
        log(f"[kernels] {name} launch: {json.dumps(plan)}; {per_sm:g} blocks per SM, "
            f"{in_flight / 1024:.0f} KiB of code rows in flight per SM")

    # 1. selective_sum over the gathered [Q, P * cap, PB] candidate codes.
    lane = torch.arange(cap, device=dev)

    def gather(st, q_):
        pos = (st.long().unsqueeze(-1) + lane).clamp(0, index.n_tokens - 1)
        return index.packed_codes[pos].reshape(q_, p * cap, pb).contiguous()

    gathered = gather(starts, qm)
    kw = dict(nbits=nbits, dim=d)
    got = selective_sum_cuda(gathered, v, **kw)
    want = ref.selective_sum(gathered, v, **kw)
    record(
        "selective_sum", got, want,
        lambda: selective_sum_cuda(gathered, v, **kw),
        lambda: ref.selective_sum(gathered, v, **kw),
        gathered.numel() + vbytes + 4 * qm * p * cap, qm * p * cap * d,
        lookups=qm * p * cap * d,
    )
    report_plan("selective_sum", gathered.data_ptr(), qm, p * cap, pb, d, nbits)
    for offset in (1, 16):
        view = code_view(torch, gathered, offset)
        case(f"selective_sum, code view at +{offset} bytes", selective_sum_cuda(view, v, **kw), want)
        del view
    del gathered

    # 2. fused dense grid [Q, P, cap].
    kw2 = dict(nbits=nbits, dim=d, cap=cap)
    args2 = (index.packed_codes, starts, sizes, pscore, v)
    got = fused_gather_score_cuda(*args2, **kw2)
    want = ref.fused_gather_score(*args2, **kw2)
    invalid = lane >= sizes.long().unsqueeze(-1)
    record(
        "fused_gather_score", got, want,
        lambda: fused_gather_score_cuda(*args2, **kw2),
        lambda: ref.fused_gather_score(*args2, **kw2),
        rows * pb + qm * p * 12 + vbytes + 4 * qm * p * cap, rows * d,
        invalid=invalid, lookups=rows * d,
    )
    report_plan("fused_gather_score", index.packed_codes.data_ptr(), qm, p, cap, pb, d, nbits)

    # Planted faults the checks must reject: one code nibble flipped in one
    # probed row (the dim whose table entries lie furthest apart), and one
    # tail slot left holding its probe's score.
    q0, p0 = 0, int(torch.argmax(sizes[0]))
    r0 = int(starts[q0, p0])
    per_byte = 8 // nbits
    codes0 = (index.packed_codes[r0].long().unsqueeze(-1) >> (torch.arange(per_byte, device=dev) * nbits)) & (nb - 1)
    codes0 = codes0.reshape(-1)[:d]
    top = 1 << (nbits - 1)
    delta = (v[q0, torch.arange(d, device=dev), codes0 ^ top] - v[q0, torch.arange(d, device=dev), codes0]).abs()
    dim0 = int(torch.argmax(delta))
    byte0, flip = dim0 // per_byte, top << ((dim0 % per_byte) * nbits)
    saved = index.packed_codes[r0, byte0].clone()
    index.packed_codes[r0, byte0] ^= flip
    bad = fused_gather_score_cuda(*args2, **kw2)
    index.packed_codes[r0, byte0] = saved
    bad_tail = got.clone()
    slot = torch.nonzero(invalid)[0]
    bad_tail[tuple(slot)] = pscore[slot[0], slot[1]]
    for what, planted in (
        (f"code nibble of dim {dim0} flipped in row {r0} (|delta v| {float(delta[dim0]):.4g})", bad),
        (f"tail slot {tuple(slot.tolist())} left at its probe score", bad_tail),
    ):
        err, broken = check_scores(planted, want, invalid)
        if broken is None:
            fail(f"fused_gather_score: the checks do not reject a planted fault ({what})")
        log(f"[kernels] planted fault, {what}: {broken}: rejected")
    del bad, bad_tail

    # Skewed sizes at the path's width: one probe per token at cap, one
    # past cap (clamped), the rest 1 and 0; runs kept inside the index.
    g = torch.Generator(device=dev)
    g.manual_seed(99)
    sk = torch.randint(0, 2, (qm, p), generator=g, device=dev, dtype=torch.int32)
    sk[torch.arange(qm, device=dev), torch.randint(0, p, (qm,), generator=g, device=dev)] = cap
    sk[0, -1] = cap + 517
    sk_starts = starts.clamp(max=index.n_tokens - cap).contiguous()
    args_sk = (index.packed_codes, sk_starts, sk, pscore, v)
    case(
        "fused_gather_score, skewed sizes (one probe at cap per token)",
        fused_gather_score_cuda(*args_sk, **kw2), ref.fused_gather_score(*args_sk, **kw2),
        lane >= sk.long().clamp(max=cap).unsqueeze(-1),
    )
    for offset in (1, 16):
        view = code_view(torch, index.packed_codes, offset)
        case(
            f"fused_gather_score, code view at +{offset} bytes",
            fused_gather_score_cuda(view, *args2[1:], **kw2), want, invalid,
        )
        del view

    # The batched retrieve's Q = 128 (4 queries of 32 tokens): fewer blocks
    # per token, the same grid size.
    st4, sz4, ps4, v4, _ = probes(4, 54321)
    gathered = gather(st4, st4.shape[0])
    case(
        "selective_sum, Q 128", selective_sum_cuda(gathered, v4, **kw),
        ref.selective_sum(gathered, v4, **kw),
    )
    ms = time_cuda(torch, lambda: selective_sum_cuda(gathered, v4, **kw), flush)
    log(f"[kernels] selective_sum, Q 128: {ms:.5f} ms")
    report_plan("selective_sum", gathered.data_ptr(), st4.shape[0], p * cap, pb, d, nbits)
    del gathered
    args4 = (index.packed_codes, st4, sz4, ps4, v4)
    case(
        "fused_gather_score, Q 128", fused_gather_score_cuda(*args4, **kw2),
        ref.fused_gather_score(*args4, **kw2), lane >= sz4.long().unsqueeze(-1),
    )
    ms = time_cuda(torch, lambda: fused_gather_score_cuda(*args4, **kw2), flush)
    log(f"[kernels] fused_gather_score, Q 128: {ms:.5f} ms ({int(sz4.sum())} probed rows)")
    report_plan("fused_gather_score", index.packed_codes.data_ptr(), st4.shape[0], p, cap, pb, d, nbits)

    # selective_sum at the other code widths (D 128, random codes and
    # tables), beside each width's floors and lookup wavefronts.
    for b in (2, 4, 8):
        pbb = d * b // 8
        packed = torch.randint(0, 256, (qm, p * cap, pbb), generator=g, device=dev, dtype=torch.uint8)
        vb = torch.randn(qm, d, 1 << b, generator=g, device=dev)
        kwb = dict(nbits=b, dim=d)
        case(f"selective_sum, nbits {b}", selective_sum_cuda(packed, vb, **kwb),
             ref.selective_sum(packed, vb, **kwb))
        ms = time_cuda(torch, lambda: selective_sum_cuda(packed, vb, **kwb), flush)
        lookups = qm * p * cap * d
        log(
            f"[kernels] selective_sum, nbits {b}: {ms:.5f} ms; bytes bound "
            f"{(packed.numel() + vb.numel() * 4 + 4 * qm * p * cap) / HBM_BYTES_PER_S * 1e3:.5f} ms, "
            f"lookup floor {lookups / (32 * n_sm * clock_hz) * 1e3:.5f} ms at one wavefront; "
            f"{lookup_wavefronts(b, 'row'):.3f} wavefronts per lookup (numpy count over random codes)"
        )
        del packed, vb
    log(f"[kernels] the ragged kernel's earlier layout (half a warp per row) at nbits 4: "
        f"{lookup_wavefronts(4, 'half_warp'):.3f} wavefronts per lookup (numpy count)")

    # 3. ragged worklist at the rung the adaptive plan picks for this query.
    tile = cfg.tile_c

    worklist = functools.partial(kernel_worklist, torch, cfg)

    def slots_invalid(work, tile_c):
        return (torch.arange(tile_c, device=dev) >= work.nvalid.long().unsqueeze(-1)).reshape(-1)

    work, bucket = worklist(starts, sizes, pscore, tile)
    args3 = (index.packed_codes, *work, v)
    kw3 = dict(nbits=nbits, dim=d, tile_c=tile)
    got = ragged_fused_gather_score_cuda(*args3, **kw3)
    want = ref.ragged_fused_gather_score(*args3, **kw3)
    slot_invalid = slots_invalid(work, tile)
    w = work.row0.numel()
    valid_rows = int(work.nvalid.sum())
    record(
        "ragged_fused_gather_score", got, want,
        lambda: ragged_fused_gather_score_cuda(*args3, **kw3),
        lambda: ref.ragged_fused_gather_score(*args3, **kw3),
        valid_rows * pb + w * 16 + vbytes + 4 * w * tile, valid_rows * d,
        invalid=slot_invalid, lookups=valid_rows * d,
    )
    report_plan("ragged_fused_gather_score", index.packed_codes.data_ptr(), w, pb, d, nbits)
    log(
        f"[kernels] shapes: Q={qm} P={p} cap={cap} D={d} nbits={nbits} "
        f"probed_rows={rows} ragged tile_c={tile} rung={bucket} W={w} "
        f"padding tiles {int((work.nvalid == 0).sum())}"
    )

    # Planted faults the checks must reject: one code nibble flipped in a
    # row of the first tile, and one padding slot left holding a score.
    r0 = int(work.row0[0])
    codes0 = (index.packed_codes[r0].long().unsqueeze(-1) >> (torch.arange(per_byte, device=dev) * nbits)) & (nb - 1)
    codes0 = codes0.reshape(-1)[:d]
    qt0 = int(work.qtok[0])
    delta = (v[qt0, torch.arange(d, device=dev), codes0 ^ top] - v[qt0, torch.arange(d, device=dev), codes0]).abs()
    dim0 = int(torch.argmax(delta))
    byte0, flip = dim0 // per_byte, top << ((dim0 % per_byte) * nbits)
    saved = index.packed_codes[r0, byte0].clone()
    index.packed_codes[r0, byte0] ^= flip
    bad = ragged_fused_gather_score_cuda(*args3, **kw3)
    index.packed_codes[r0, byte0] = saved
    bad_pad = got.clone()
    pads = torch.nonzero(work.nvalid == 0).flatten()  # else a tail slot
    pad = int(pads[0]) * tile if pads.numel() else int(torch.nonzero(slot_invalid)[0])
    bad_pad[pad] = work.pscore[0]
    for what, planted in (
        (f"code nibble of dim {dim0} flipped in row {r0} (|delta v| {float(delta[dim0]):.4g})", bad),
        (f"padding slot {pad} left at a probe score", bad_pad),
    ):
        err, broken = check_scores(planted, want, slot_invalid)
        if broken is None:
            fail(f"ragged_fused_gather_score: the checks do not reject a planted fault ({what})")
        log(f"[kernels] planted fault, {what}: {broken}: rejected")
    del bad, bad_pad

    # Skewed sizes (one probe at cap per token, the rest 1 and 0), code
    # views at +1 and +16 bytes, the other tile sizes, and the batched
    # retrieve's Q = 128 (padding between the queries' worklists).
    sk_work, _ = worklist(sk_starts, sk.clamp(max=cap), pscore, tile)
    args_sk = (index.packed_codes, *sk_work, v)
    case(
        "ragged_fused_gather_score, skewed sizes (one probe at cap per token)",
        ragged_fused_gather_score_cuda(*args_sk, **kw3), ref.ragged_fused_gather_score(*args_sk, **kw3),
        slots_invalid(sk_work, tile),
    )
    for offset in (1, 16):
        view = code_view(torch, index.packed_codes, offset)
        case(
            f"ragged_fused_gather_score, code view at +{offset} bytes",
            ragged_fused_gather_score_cuda(view, *args3[1:], **kw3), want, slot_invalid,
        )
        del view
    for tile_c in (8, 16, 64):
        work_t, _ = worklist(starts, sizes, pscore, tile_c)
        args_t = (index.packed_codes, *work_t, v)
        kw_t = dict(nbits=nbits, dim=d, tile_c=tile_c)
        case(
            f"ragged_fused_gather_score, tile_c {tile_c}",
            ragged_fused_gather_score_cuda(*args_t, **kw_t), ref.ragged_fused_gather_score(*args_t, **kw_t),
            slots_invalid(work_t, tile_c),
        )
    work4, bucket4 = worklist(st4, sz4, ps4, tile, b=4)
    args34 = (index.packed_codes, *work4, v4)
    case(
        "ragged_fused_gather_score, Q 128", ragged_fused_gather_score_cuda(*args34, **kw3),
        ref.ragged_fused_gather_score(*args34, **kw3), slots_invalid(work4, tile),
    )
    ms = time_cuda(torch, lambda: ragged_fused_gather_score_cuda(*args34, **kw3), flush)
    log(f"[kernels] ragged_fused_gather_score, Q 128: {ms:.5f} ms ({int(work4.nvalid.sum())} "
        f"valid rows, W={work4.row0.numel()}, rung {bucket4})")
    report_plan("ragged_fused_gather_score", index.packed_codes.data_ptr(), work4.row0.numel(), pb, d, nbits)

    # 4. The segmented entry: the same probes over the index cut into 5
    # segments, one launch.
    segmented_kernel_rows(torch, index, cfg, flush, cids, pscore, v, record, case)

    # A v-table wider than one block's shared memory (D 256, nbits 8: 256
    # KiB): all three kernels walk it in chunks of dimensions.
    dw, bw = 256, 8
    n_w = 200_000
    codes_w = torch.randint(0, 256, (n_w, dw), generator=g, device=dev, dtype=torch.uint8)
    v_w = torch.randn(qm, dw, 1 << bw, generator=g, device=dev)
    kww = dict(nbits=bw, dim=dw)
    packed_w = torch.randint(0, 256, (qm, 4096, dw), generator=g, device=dev, dtype=torch.uint8)
    case("selective_sum, D 256 nbits 8", selective_sum_cuda(packed_w, v_w, **kww),
         ref.selective_sum(packed_w, v_w, **kww))
    st_w = torch.randint(0, n_w - cap, (qm, 8), generator=g, device=dev, dtype=torch.int32)
    sz_w, ps_w = sizes[:, :8].contiguous(), pscore[:, :8].contiguous()
    args_w = (codes_w, st_w, sz_w, ps_w, v_w)
    case(
        "fused_gather_score, D 256 nbits 8", fused_gather_score_cuda(*args_w, **kww, cap=cap),
        ref.fused_gather_score(*args_w, **kww, cap=cap), lane >= sz_w.long().unsqueeze(-1),
    )
    work_w, _ = worklist(st_w, sz_w, ps_w, tile)
    args3w = (codes_w, *work_w, v_w)
    case(
        "ragged_fused_gather_score, D 256 nbits 8",
        ragged_fused_gather_score_cuda(*args3w, **kww, tile_c=tile),
        ref.ragged_fused_gather_score(*args3w, **kww, tile_c=tile), slots_invalid(work_w, tile),
    )
    for name, plan in (
        ("selective_sum", _build.launch_plan("selective_sum", packed_w.data_ptr(), qm, 4096, dw, dw, bw)),
        ("fused_gather_score", _build.launch_plan("fused_gather_score", codes_w.data_ptr(), qm, 8, cap, dw, dw, bw)),
        ("ragged_fused_gather_score", _build.launch_plan(
            "ragged_fused_gather_score", codes_w.data_ptr(), work_w.row0.numel(), dw, dw, bw)),
    ):
        log(f"[kernels] {name} launch at D 256 nbits 8: {json.dumps(plan)}")
    del codes_w, packed_w, v_w
    return out

# The kernel phase's segmented case: the index cut into 5 segments over the
# same clusters. Segment 0 (the case's base) holds one row of each of the
# first SEG_TINY clusters token 0 probes, fewer rows than a tile; segments
# 1-4 hold the rest of every cluster in these shares.
SEG_TINY = 20
SEG_SHARES = (0.4, 0.25, 0.2, 0.15)


def split_segments(torch, codes, offsets, sizes, tiny_cids):
    """``codes`` u8[N, PB] in CSR order over clusters (``offsets``,
    ``sizes``) cut into 1 + len(SEG_SHARES) segments over the same
    clusters -> [(codes_s, offsets_s i32[C + 1], sizes_s i32[C], map_s
    i64[N_s]: each row's row in ``codes``)]."""
    dev = codes.device
    sizes = sizes.long()
    tiny = torch.zeros_like(sizes)
    tiny[tiny_cids] = (sizes[tiny_cids] > 0).long()
    rest = sizes - tiny
    parts, left = [tiny], rest.clone()
    for share in SEG_SHARES[:-1]:
        part = torch.floor(rest.double() * share).long()
        parts.append(part)
        left -= part
    parts.append(left)
    out, before = [], torch.zeros_like(sizes)
    for part in parts:
        n_s = int(part.sum())
        offs = torch.zeros(sizes.numel() + 1, dtype=torch.long, device=dev)
        offs[1:] = torch.cumsum(part, 0)
        shift = offsets[:-1].long() + before - offs[:-1]
        row_map = torch.repeat_interleave(shift, part, output_size=n_s) + torch.arange(n_s, device=dev)
        out.append((codes[row_map].contiguous(), offs.int(), part.int(), row_map))
        before += part
    return out


def segmented_work(torch, segs, cids, pscore, nprobe: int, tile: int):
    """The segmented ragged path's worklist over ``segs`` for probes
    ``cids`` [Q, P] (one query): each probe expanded into its per-segment
    runs, at the rung the adaptive plan would pick -> (row0, nvalid, seg,
    qtok, pscore) flat, rung."""
    from repro_torch.core import worklist as wl

    qm, p = cids.shape
    n_seg = len(segs)
    st = torch.stack([offs.long()[cids] for _, offs, _, _ in segs], -1)
    sz = torch.stack([part.long()[cids] for _, _, part, _ in segs], -1)
    per_seg = np.stack([part.cpu().numpy() for _, _, part, _ in segs]).astype(np.int64)
    bound = wl.worklist_bound_segmented(per_seg, nprobe, tile)
    needed = wl.needed_worklist_tiles(((sz + tile - 1) // tile).sum(-1).cpu().numpy())
    rung = wl.pick_bucket(wl.bucket_ladder(bound), needed)
    seg_ids = torch.arange(n_seg, device=cids.device).expand(qm, p, n_seg)
    ps = pscore.unsqueeze(-1).expand(qm, p, n_seg)
    work = wl.build_tile_worklist(
        st.reshape(1, qm, -1), sz.reshape(1, qm, -1), ps.reshape(1, qm, -1),
        seg=seg_ids.reshape(1, qm, -1), tile_c=tile, tiles_per_qtoken=rung,
    )
    return tuple(a.reshape(-1).contiguous() for a in work), rung


def segmented_kernel_rows(torch, index, cfg, flush, cids, pscore, v, record, case):
    """The segmented entry of the ragged kernel against its plain version
    (max abs err <= TOL, invalid slots exactly 0) at the kernel phase's
    probes spread over 5 segments (one of fewer rows than a tile), on code
    views at +1 and +16 bytes and at D 256 nbits 8; bit for bit the sum of
    one single-array launch per segment with the other segments' tiles at
    nvalid 0 (the JAX op's schedule) and the single-array kernel on the
    same W over the whole index; two planted faults rejected (a segment
    index off by one, every segment clamped by the base's row count);
    timed beside the single-array kernel and the S-launch replay."""
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.fused_gather_score import (
        ragged_fused_gather_score_cuda,
        segment_table,
        segmented_ragged_fused_gather_score_cuda,
    )

    dev = index.device
    d, nbits, pb = index.dim, index.nbits, index.packed_codes.shape[1]
    tile = cfg.tile_c
    tiny = torch.unique(cids[0])[:SEG_TINY]
    segs = split_segments(
        torch, index.packed_codes, index.cluster_offsets, index.cluster_sizes, tiny
    )
    codes = [c for c, _, _, _ in segs]
    if not 0 < codes[0].shape[0] < tile:
        fail(f"segmented case: segment 0 holds {codes[0].shape[0]} rows, not fewer than a tile")
    (row0, nvalid, seg, qtok, ps), rung = segmented_work(torch, segs, cids, pscore, cfg.nprobe, tile)
    w, qm = row0.numel(), v.shape[0]
    kw = dict(nbits=nbits, dim=d, tile_c=tile)
    args = (codes, row0, nvalid, seg, qtok, ps, v)
    invalid = (torch.arange(tile, device=dev) >= nvalid.long().unsqueeze(-1)).reshape(-1)

    def replay(codes_list=codes, row0=row0, nvalid=nvalid, seg=seg, qtok=qtok, ps=ps, v=v, kw=kw):
        out = None
        for s, c in enumerate(codes_list):
            if c.shape[0]:
                o = ragged_fused_gather_score_cuda(c, row0, torch.where(seg == s, nvalid, 0), qtok, ps, v, **kw)
                out = o if out is None else out + o
        return out

    got = segmented_ragged_fused_gather_score_cuda(*args, **kw)
    want = ref.segmented_ragged_fused_gather_score(*args, **kw)
    valid_rows = int(nvalid.sum())
    vbytes = qm * d * (1 << nbits) * 4
    record(
        "segmented_ragged_fused_gather_score", got, want,
        lambda: segmented_ragged_fused_gather_score_cuda(*args, **kw),
        lambda: ref.segmented_ragged_fused_gather_score(*args, **kw),
        valid_rows * pb + w * 20 + vbytes + 4 * w * tile + 16 * len(codes), valid_rows * d,
        invalid=invalid, lookups=valid_rows * d,
    )
    if not torch.equal(got, replay()):
        fail("segmented_ragged_fused_gather_score: differs from the S-launch replay")
    starts = torch.tensor([0] + [c.shape[0] for c in codes[:-1]], device=dev).cumsum(0)
    row_map = torch.cat([m for _, _, _, m in segs])
    row0_g = torch.where(nvalid > 0, row_map[(starts[seg.long()] + row0).clamp(0, row_map.numel() - 1)], 0).int()
    single_args = (index.packed_codes, row0_g, nvalid, qtok, ps, v)
    if not torch.equal(got, ragged_fused_gather_score_cuda(*single_args, **kw)):
        fail("segmented_ragged_fused_gather_score: differs from the single-array kernel on the same W")
    log(f"[kernels] segmented_ragged_fused_gather_score: equal bit for bit to the {len(codes)}-launch "
        f"replay and to the single-array kernel over the whole index at W={w} (rung {rung}, "
        f"segment rows {[c.shape[0] for c in codes]}, {valid_rows} valid rows, "
        f"{int((nvalid == 0).sum())} padding tiles)")
    # Where a difference comes from: the entry over the index as one
    # segment (the single-array kernel's rows, its own lookups), and the
    # single-array kernel over the segments laid end to end (their rows'
    # places, its lookups).
    zeros = torch.zeros_like(seg)
    one_args = ([index.packed_codes], row0_g, nvalid, zeros, qtok, ps, v)
    laid = torch.cat(codes)
    laid_args = (laid, (starts[seg.long()] + row0).int(), nvalid, qtok, ps, v)
    ms = {
        "segmented": time_cuda(torch, lambda: segmented_ragged_fused_gather_score_cuda(*args, **kw), flush),
        "single_array_same_w": time_cuda(torch, lambda: ragged_fused_gather_score_cuda(*single_args, **kw), flush),
        "segmented_one_segment": time_cuda(
            torch, lambda: segmented_ragged_fused_gather_score_cuda(*one_args, **kw), flush),
        "single_array_segments_laid_end_to_end": time_cuda(
            torch, lambda: ragged_fused_gather_score_cuda(*laid_args, **kw), flush),
        "replay": time_cuda(torch, replay, flush),
    }
    if not torch.equal(got, ragged_fused_gather_score_cuda(*laid_args, **kw)):
        fail("segmented_ragged_fused_gather_score: differs from the single-array kernel over "
             "the segments laid end to end")
    del laid, laid_args
    log(f"[kernels] segmented_ragged_fused_gather_score times (ms, L2 flushed, median of 25): "
        f"{json.dumps(ms)}; {len(codes)} launches in the replay; {card()}")

    # Planted faults the checks must reject.
    off_by_one = segmented_ragged_fused_gather_score_cuda(codes, row0, nvalid, seg + 1, qtok, ps, v, **kw)
    table = segment_table(codes, dev)
    table[len(codes):] = codes[0].shape[0]  # every segment clamped by the base's rows
    clamped = torch.empty_like(got)
    lib = _build.library("ragged_fused_gather_score")
    _build.check("ragged_fused_gather_score", lib.warp_segmented_ragged_fused_gather_score(
        row0.data_ptr(), nvalid.data_ptr(), seg.data_ptr(), qtok.data_ptr(), ps.data_ptr(),
        v.data_ptr(), clamped.data_ptr(), table.data_ptr(), len(codes),
        int(all(c.data_ptr() % 16 == 0 for c in codes)), w, tile, qm, pb, d, nbits,
        _build.stream_ptr(dev),
    ))
    for what, planted in (
        ("segment index off by one", off_by_one),
        (f"every segment clamped by the base's {codes[0].shape[0]} rows", clamped),
    ):
        _, broken = check_scores(planted, want, invalid)
        if broken is None:
            fail(f"segmented_ragged_fused_gather_score: the checks do not reject a planted fault ({what})")
        log(f"[kernels] planted fault, {what}: {broken}: rejected")
    del off_by_one, clamped

    for offset in (1, 16):
        views = [code_view(torch, c, offset) for c in codes]
        case(f"segmented_ragged_fused_gather_score, code views at +{offset} bytes",
             segmented_ragged_fused_gather_score_cuda(views, *args[1:], **kw), want, invalid)
        del views
    del segs, codes, row_map

    # D 256 at nbits 8 (a v-table walked in chunks of dims): random codes
    # in 5 segments of 20, 60,000, 0, 30,000 and 9,000 rows over 64 clusters.
    g = torch.Generator(device=dev)
    g.manual_seed(256)
    dw, bw, cw = 256, 8, 64
    segs_w = []
    for n_s in (20, 60_000, 0, 30_000, 9_000):
        part = torch.bincount(torch.randint(0, cw, (n_s,), generator=g, device=dev), minlength=cw)
        offs = torch.zeros(cw + 1, dtype=torch.long, device=dev)
        offs[1:] = torch.cumsum(part, 0)
        codes_s = torch.randint(0, 256, (n_s, dw), generator=g, device=dev, dtype=torch.uint8)
        segs_w.append((codes_s, offs.int(), part.int(), None))
    cids_w = torch.randint(0, cw, (qm, 8), generator=g, device=dev)
    work_w, _ = segmented_work(torch, segs_w, cids_w, pscore[:, :8], 8, tile)
    v_w = torch.randn(qm, dw, 1 << bw, generator=g, device=dev)
    codes_w = [c for c, _, _, _ in segs_w]
    kww = dict(nbits=bw, dim=dw, tile_c=tile)
    got_w = segmented_ragged_fused_gather_score_cuda(codes_w, *work_w, v_w, **kww)
    case("segmented_ragged_fused_gather_score, D 256 nbits 8", got_w,
         ref.segmented_ragged_fused_gather_score(codes_w, *work_w, v_w, **kww),
         (torch.arange(tile, device=dev) >= work_w[1].long().unsqueeze(-1)).reshape(-1))
    if not torch.equal(got_w, replay(codes_w, *work_w, v_w, kww)):
        fail("segmented_ragged_fused_gather_score, D 256 nbits 8: differs from the S-launch replay")



def percentiles_ms(seconds) -> dict:
    s = np.asarray(seconds) * 1e3
    return {f"p{q}": float(np.percentile(s, q)) for q in (50, 95, 99)}


def run_timed(torch, plan, q, m):
    """One ``plan.retrieve`` per query, each timed on the host clock
    between two synchronizes -> ([(ids, scores)], seconds)."""
    out, times = [], []
    for i in range(q.shape[0]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plan.retrieve(q[i], m[i])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        out.append((res.doc_ids.cpu().numpy(), res.scores.cpu().numpy()))
    return out, times


def phase_retrieve(torch, retriever, queries, qmask, batch: int, kernel_err: float):
    """Every config at both executors over all ``queries``, one retrieve
    each (after one untimed warm-up), plus one ``retrieve_batch`` of the
    first ``batch``. Returns the launch counts of the run and the
    per-plan latency percentiles (ms)."""
    from repro_torch.core import WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, reset_launches

    n = queries.shape[0]
    reset_launches()
    results, launches, lat = {}, {}, {}
    swaps = 0
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            name = "/".join(key)
            plan = retriever.plan(WarpSearchConfig(
                nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
                gather=gather, layout=layout, executor=executor,
            ))
            before = dict(LAUNCHES)
            plan.retrieve(queries[0], qmask[0])
            single, times = run_timed(torch, plan, queries, qmask)
            bres = plan.retrieve_batch(queries[:batch], qmask[:batch])
            bids, bsc = bres.doc_ids.cpu().numpy(), bres.scores.cpu().numpy()
            for i in range(batch):
                swaps += topk_swaps(
                    f"{name} retrieve_batch[{i}] vs retrieve",
                    bids[i], bsc[i], *single[i], kernel_err,
                )
            results[key] = single
            launches[key] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            lat[key] = percentiles_ms(times)
            log(
                f"[retrieve] {name}: per-query latency over {n} queries (ms) "
                f"{json.dumps(lat[key])}, launches {launches[key]}, "
                f"describe {json.dumps(plan.describe())}"
            )
    counts = dict(LAUNCHES)  # read right after the main path's run
    exact = 0
    for gather, layout in CONFIGS:
        kname = KERNEL_OF[(gather, layout)]
        if launches[(gather, layout, "kernel")][kname] <= 0:
            fail(f"{gather}/{layout}: kernel {kname} was never launched")
        if any(launches[(gather, layout, "reference")].values()):
            fail(f"{gather}/{layout}: the reference executor launched a kernel")
        for i in range(n):
            ki, ri = results[(gather, layout, "kernel")][i], results[(gather, layout, "reference")][i]
            s = topk_swaps(f"{gather}/{layout} kernel vs reference, query {i}", *ki, *ri, kernel_err)
            swaps += s
            exact += int(s == 0)
    base = results[("materialize", "dense", "reference")]
    for key, res in results.items():
        for i in range(n):
            swaps += topk_swaps(
                f"{'/'.join(key)} vs materialize/dense/reference, query {i}",
                *res[i], *base[i], kernel_err,
            )
    log(
        f"[retrieve] kernel vs reference: identical doc ids on {exact} of "
        f"{n * len(CONFIGS)} (query, config) pairs; {swaps} places swapped "
        "within a tie over all comparisons"
    )
    return counts, lat


def phase_serve(
    torch, retriever, n_requests: int, seed: int, kernel_err: float, *, index=None,
    store_path=None, tag="serve",
):
    """``RetrievalServer`` over the (fused, ragged) plan: a burst of
    ``n_requests`` drained at once (throughput), then ``n_requests``
    Poisson arrivals at half that rate, driven open loop (latency from
    each request's scheduled arrival to the loop seeing its reply).
    Every reply is held against ``plan.retrieve``. Queries are made from
    ``index`` (default the retriever's); ``store_path`` backs the server's
    deletes. Returns the server and its queries (host arrays)."""
    from repro_torch.core import WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import PENDING, BatchPolicy, RetrievalServer

    cfg = WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    )
    policy = BatchPolicy(max_batch=8, max_wait_s=0.002)
    server = RetrievalServer(retriever, cfg, policy, store_path=store_path)
    q, qmask = make_queries(torch, retriever.index if index is None else index, 2 * n_requests, seed, lo=4, hi=32)
    qh, mh = q.cpu().numpy(), qmask.cpu().numpy()
    for rung in server.config.worklist_buckets:
        server.plan.retrieve_batch_at(qh[:8], mh[:8], bucket=rung)
    reset_launches()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    rids = [server.submit(qh[i], mh[i]) for i in range(n_requests)]
    server.drain()
    burst_s = time.perf_counter() - t0
    burst = server.summary()
    replies = {i: server.poll(rid) for i, rid in enumerate(rids)}
    capacity = n_requests / burst_s
    server.latencies.clear()  # the summary's percentiles cover the paced run

    rate = 0.5 * capacity
    arrive = np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n_requests))
    waiting, lat = {}, np.zeros(n_requests)
    nxt = 0
    t0 = time.perf_counter()
    while nxt < n_requests or waiting:
        now = time.perf_counter() - t0
        while nxt < n_requests and arrive[nxt] <= now:
            j = n_requests + nxt
            waiting[server.submit(qh[j], mh[j])] = nxt
            nxt += 1
        if server.step() == 0:
            time.sleep(1e-4)
            continue
        done = time.perf_counter() - t0
        for rid, i in list(waiting.items()):
            out = server.poll(rid)
            if out is not PENDING:
                replies[n_requests + i] = out
                lat[i] = done - arrive[i]
                del waiting[rid]
    paced_s = time.perf_counter() - t0
    launched = LAUNCHES["ragged_fused_gather_score"]
    if launched <= 0:
        fail(f"{tag}: the ragged kernel was never launched")

    swaps = 0
    for i, (scores, ids) in sorted(replies.items()):
        want = server.plan.retrieve(qh[i], mh[i])
        swaps += topk_swaps(
            f"{tag} reply {i} vs plan.retrieve", ids, scores,
            want.doc_ids.cpu().numpy(), want.scores.cpu().numpy(), kernel_err,
        )
    paced = percentiles_ms(lat)
    log(
        f"[{tag}] burst: {n_requests} requests drained in {burst_s * 1e3:.3f} ms = "
        f"{capacity:.3f} requests/s ({burst['batches']} batches)"
    )
    log(
        f"[{tag}] paced: {n_requests} Poisson arrivals at {rate:.3f}/s over "
        f"{paced_s * 1e3:.3f} ms = {n_requests / paced_s:.3f} requests/s served; "
        f"arrival-to-reply latency (ms) {json.dumps(paced)}"
    )
    log(
        f"[{tag}] {2 * n_requests} replies equal plan.retrieve ({swaps} places swapped "
        f"within a tie); ragged kernel launches {launched}; summary "
        f"{json.dumps(server.summary())}"
    )
    return server, qh, mh


def delta_embeddings(torch, index, n_docs: int, doc_len: int, g):
    """A delta's token embeddings: noisy copies of random base centroids
    (as ``make_queries``), so they land in clusters queries probe, and
    their local doc ids (``doc_len`` tokens per doc)."""
    n = n_docs * doc_len
    cids = torch.randint(0, index.n_centroids, (n,), generator=g, device=index.device)
    emb = index.centroids[cids] + 0.04 * torch.randn(n, index.dim, generator=g, device=index.device)
    return emb, np.repeat(np.arange(n_docs, dtype=np.int32), doc_len)


def survivors(ids, keep):
    return (ids >= 0) & keep[np.clip(ids, 0, None)]


def phase_segments(
    torch, index, dev, seed: int, kernel_err: float, base_lat: dict, keep_store: str | None = None
) -> int:
    """Segmented indexes at full Lifestyle width: the index saved with
    ``save_index``, SEG_DELTAS deltas appended with ``add_documents`` on
    the card, 1% of doc ids tombstoned with ``delete_documents``, loaded
    with ``Retriever.from_store``. SEG_QUERIES queries single and batched
    at the four configs, kernel executor against reference (doc ids
    identical up to swaps inside ties), dense against ragged; the
    tombstone view and a 50% allowlist return no filtered doc and equal
    post-hoc filtering of an unfiltered plan at a larger k. ``compact``
    with the tombstones held aside gives one index with the segmented
    plans' doc ids; ``compact`` with them drops exactly the deleted docs'
    rows (dropping rows shrinks cluster sizes and t', so m_i moves: its
    agreement with the filtered segmented plans is reported, not held
    equal). Returns the segmented kernel's launches on the main path
    ((fused, ragged) retrieves: one each). A copy of the store as grown
    (base + deltas, before any compaction) is left at ``keep_store`` for the
    serving phase. The store is removed at the end, on success and on
    failure."""
    from repro_torch.core import Retriever, WarpSearchConfig
    from repro_torch.core.docfilter import DocFilter
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.store import (
        add_documents, compact, delete_documents, read_tombstones, save_index,
    )

    def cfg(gather, layout, executor="kernel", k=ARCH["k"]):
        return WarpSearchConfig(
            nprobe=ARCH["nprobe"], k=k, k_impute=ARCH["k_impute"],
            gather=gather, layout=layout, executor=executor,
        )

    smi = card()
    swaps = 0
    tmp = tempfile.mkdtemp(prefix="segments_phase_")
    try:
        path = os.path.join(tmp, "store")
        t0 = time.perf_counter()
        save_index(index, path)
        log(f"[segments] save_index of the base in {time.perf_counter() - t0:.3f} s; {smi}")
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        for i in range(SEG_DELTAS):
            emb, tdi = delta_embeddings(torch, index, SEG_DELTA_DOCS, BUILD_DOC_LEN, g)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            add_documents(path, emb, tdi, SEG_DELTA_DOCS, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            log(f"[segments] add_documents delta {i}: {SEG_DELTA_DOCS} docs, {emb.shape[0]} tokens "
                f"in {dt * 1e3:.3f} ms = {emb.shape[0] / dt:.1f} tokens/s; {smi}")
            del emb
        n_all = index.n_docs + SEG_DELTAS * SEG_DELTA_DOCS
        rng = np.random.default_rng(seed)
        n_tomb = int(round(SEG_TOMBSTONE_FRAC * n_all))
        dead = np.concatenate([
            rng.choice(index.n_docs, n_tomb // 2, replace=False),
            index.n_docs + rng.choice(n_all - index.n_docs, n_tomb - n_tomb // 2, replace=False),
        ])
        tomb = delete_documents(path, dead.tolist())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = Retriever.from_store(path, device=dev)
        torch.cuda.synchronize()
        log(f"[segments] Retriever.from_store (base + {r.index.n_segments - 1} deltas, "
            f"{r.index.n_tokens} tokens, {r.n_docs} docs, {len(tomb)} tombstoned) in "
            f"{(time.perf_counter() - t0) * 1e3:.3f} ms; {smi}")
        if not r.is_segmented or r.n_docs != n_all:
            fail(f"segments: loaded {type(r.index).__name__} of {r.n_docs} docs, expected {n_all}")
        r_t_prime = r.plan(cfg("fused", "ragged")).config.t_prime

        q, qmask = make_queries(torch, index, SEG_QUERIES, seed + 1)
        qh, mh = q.cpu().numpy(), qmask.cpu().numpy()
        results, lat, launched = {}, {}, 0
        for gather, layout in CONFIGS:
            for executor in ("kernel", "reference"):
                plan = r.plan(cfg(gather, layout, executor))
                plan.retrieve(q[0], qmask[0])  # warm-up
                main = (gather, layout, executor) == ("fused", "ragged", "kernel")
                if main:
                    reset_launches()
                before = dict(LAUNCHES)
                res, times = run_timed(torch, plan, q, qmask)
                used = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                if main:
                    launched = LAUNCHES["segmented_ragged_fused_gather_score"]
                    if launched != SEG_QUERIES or used["ragged_fused_gather_score"]:
                        fail(f"segments fused/ragged: {used} launches over {SEG_QUERIES} retrieves, "
                             "expected one segmented launch each")
                if executor == "reference" and any(used.values()):
                    fail(f"segments {gather}/{layout}: the reference executor launched a kernel")
                if executor == "kernel" and not used[KERNEL_OF[(gather, layout)]] and not main:
                    fail(f"segments {gather}/{layout}: kernel {KERNEL_OF[(gather, layout)]} never launched")
                results[(gather, layout, executor)] = res
                lat[(gather, layout, executor)] = percentiles_ms(times)
                for b in range(SEG_BATCHES):
                    sl = slice(4 * b, 4 * b + 4)
                    bres = plan.retrieve_batch(qh[sl], mh[sl])
                    for j in range(4):
                        swaps += topk_swaps(
                            f"segments {gather}/{layout}/{executor} retrieve_batch vs retrieve, query {4 * b + j}",
                            bres.doc_ids[j].cpu().numpy(), bres.scores[j].cpu().numpy(),
                            *res[4 * b + j], kernel_err,
                        )
                log(f"[segments] {gather}/{layout}/{executor}: per-query latency (ms) "
                    f"{json.dumps(lat[(gather, layout, executor)])} beside the base index's "
                    f"{json.dumps(base_lat[(gather, layout, executor)])}; launches {used}; {smi}")
        log(f"[segments] launches per (fused, ragged) retrieve: segmented_ragged_fused_gather_score "
            f"{launched / SEG_QUERIES:g}, ragged_fused_gather_score 0; {smi}")
        for gather, layout in CONFIGS:
            for i in range(SEG_QUERIES):
                swaps += topk_swaps(
                    f"segments {gather}/{layout} kernel vs reference, query {i}",
                    *results[(gather, layout, "kernel")][i],
                    *results[(gather, layout, "reference")][i], kernel_err,
                )
                swaps += topk_swaps(
                    f"segments {gather}/{layout} vs materialize/dense, query {i}",
                    *results[(gather, layout, "kernel")][i],
                    *results[("materialize", "dense", "kernel")][i], kernel_err,
                )

        # Filters: no filtered doc returned, and the filtered plan equals
        # post-hoc filtering of an unfiltered plan at a larger k.
        n = r.n_docs
        allow = DocFilter.allow(rng.choice(n, int(SEG_ALLOW_FRAC * n), replace=False), n)
        views = {"tombstones": DocFilter.tombstones(read_tombstones(path), n), "allow 50%": allow}
        filtered = {}
        for name, dfilter in views.items():
            keep = dfilter.survivor_mask
            for gather, layout in (("fused", "ragged"), ("fused", "dense")):
                got, _ = run_timed(torch, r.plan(cfg(gather, layout), dfilter=dfilter), q, qmask)
                # k' doubles until every query's unfiltered top-k' holds k survivors.
                k_wide = 2 * ARCH["k"]
                while True:
                    wide, _ = run_timed(torch, r.plan(cfg(gather, layout, k=k_wide)), q, qmask)
                    if min(int(survivors(w[0], keep).sum()) for w in wide) >= ARCH["k"]:
                        break
                    if k_wide >= ARCH["nprobe"] * r.index.cap:
                        fail(f"segments {name}: fewer than k survivors in every unfiltered top-k'")
                    k_wide *= 2
                for i in range(SEG_QUERIES):
                    ids = got[i][0]
                    if not keep[ids[ids >= 0]].all():
                        fail(f"segments {name} {gather}/{layout} query {i}: a filtered doc was returned")
                    ok = survivors(wide[i][0], keep)
                    swaps += topk_swaps(
                        f"segments {name} {gather}/{layout} vs post-hoc filtering at k={k_wide}, query {i}",
                        *got[i], wide[i][0][ok][: ARCH["k"]], wide[i][1][ok][: ARCH["k"]], kernel_err,
                    )
                filtered[(name, gather, layout)] = got
            log(f"[segments] {name} ({dfilter.n_survivors} of {n} survive): no filtered doc "
                f"returned; equal to post-hoc filtering of an unfiltered plan at k={k_wide} on "
                "fused/ragged and fused/dense")

        # Compaction. Without the tombstones it only folds the deltas in:
        # cluster sizes, t' and m_i stay, so the single index must give the
        # segmented plan's doc ids. With them it drops the deleted rows,
        # which shrinks cluster sizes and t' and so moves m_i: its arrays
        # must equal the first compaction's without the deleted docs' rows,
        # and its agreement with the filtered segmented plan is reported.
        del r
        torch.cuda.empty_cache()
        if keep_store is not None:
            shutil.copytree(path, keep_store)
        tomb_file = os.path.join(path, "tombstones.json")
        held = os.path.join(tmp, "tombstones.json")
        os.replace(tomb_file, held)
        t0 = time.perf_counter()
        compact(path)
        log(f"[segments] compact of {SEG_DELTAS} deltas in {time.perf_counter() - t0:.3f} s; {smi}")
        single = Retriever.from_store(path, device=dev)
        if single.is_segmented or single.n_docs != n:
            fail("segments: the compacted store is not one index of the same doc-id bound")
        for gather, layout in (("fused", "ragged"), ("fused", "dense")):
            got, _ = run_timed(torch, single.plan(cfg(gather, layout)), q, qmask)
            for i in range(SEG_QUERIES):
                swaps += topk_swaps(
                    f"segments compacted vs segmented {gather}/{layout}, query {i}",
                    *got[i], *results[(gather, layout, "kernel")][i], kernel_err,
                )
        log("[segments] compacted index = segmented plans (doc ids, scores within "
            f"{TOL}) on fused/ragged and fused/dense")
        folded = {f: getattr(single.index, f) for f in ("packed_codes", "token_doc_ids", "cluster_offsets")}
        del single
        shutil.copy(held, tomb_file)
        t0 = time.perf_counter()
        compact(path)
        log(f"[segments] compact dropping {len(tomb)} tombstoned docs' rows in "
            f"{time.perf_counter() - t0:.3f} s; {smi}")
        if os.path.exists(tomb_file):
            fail("segments: compact left tombstones.json behind")
        dropped = Retriever.from_store(path, device=dev)
        keep = torch.from_numpy(views["tombstones"].survivor_mask.copy()).to(dev)
        rows = keep[folded["token_doc_ids"].long()]
        c = folded["cluster_offsets"].numel() - 1
        cluster_of = torch.repeat_interleave(
            torch.arange(c, device=dev), folded["cluster_offsets"].diff().long(),
            output_size=rows.numel(),
        )
        sizes = torch.bincount(cluster_of[rows], minlength=c)
        if not (
            torch.equal(dropped.index.packed_codes, folded["packed_codes"][rows])
            and torch.equal(dropped.index.token_doc_ids, folded["token_doc_ids"][rows])
            and torch.equal(dropped.index.cluster_sizes.long(), sizes)
        ):
            fail("segments: the compaction with tombstones is not the deltas' compaction "
                 "without the deleted docs' rows")
        del folded, rows, cluster_of
        same, overlap, max_diff = 0, 0.0, 0.0
        for gather, layout in (("fused", "ragged"), ("fused", "dense")):
            got, _ = run_timed(torch, dropped.plan(cfg(gather, layout)), q, qmask)
            want = filtered[("tombstones", gather, layout)]
            for i in range(SEG_QUERIES):
                ids = got[i][0]
                if not views["tombstones"].survivor_mask[ids[ids >= 0]].all():
                    fail(f"segments: the compacted index returned a deleted doc (query {i})")
                same += int(np.array_equal(ids, want[i][0]))
                overlap += len(set(ids.tolist()) & set(want[i][0].tolist())) / len(ids)
                max_diff = max(max_diff, float(np.abs(got[i][1] - want[i][1]).max()))
        log(f"[segments] compacted without the deleted rows ({dropped.index.n_tokens} tokens, t' "
            f"{dropped.plan(cfg('fused', 'ragged')).config.t_prime} vs the segmented "
            f"{r_t_prime}): no deleted doc returned; vs the tombstone-filtered segmented plans "
            f"identical top-{ARCH['k']} on {same} of {2 * SEG_QUERIES}, mean overlap "
            f"{overlap / (2 * SEG_QUERIES):.4f}, max score difference {max_diff:.4g}; {swaps} "
            "places swapped within a tie over all segment comparisons")
        return launched
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def span_rows(events) -> dict:
    """Per request id, the names of its spans in one exported Chrome trace:
    ``submit`` (with its children), its ``queue_wait`` row, and the
    ``batch_dispatch`` holding it (with the engine spans and ``reply``
    nested inside, by interval containment on the dispatch's thread)."""
    by_tid: dict = {}
    for e in events:
        if e["ph"] == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    rows: dict = {}

    def inside(outer, e):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3

    for tid, evs in by_tid.items():
        for e in evs:
            args = e.get("args", {})
            if e["name"] == "submit" and "rid" in args:
                kids = [c["name"] for c in evs if c is not e and inside(e, c)]
                rows.setdefault(args["rid"], {})["submit"] = kids
            elif e["name"] == "queue_wait":
                rows.setdefault(tid, {})["queue_wait"] = e["dur"]
            elif e["name"] == "batch_dispatch":
                kids = [c["name"] for c in evs if c is not e and inside(e, c)]
                for rid in args["rids"]:
                    rows.setdefault(rid, {})["dispatch"] = kids
    return rows


def phase_serving(torch, index, dev, seed: int, kernel_err: float, store: str) -> dict:
    """The whole retrieval server at Lifestyle width (``serving``): one
    ``RetrievalServer`` (result and rung caches, an admission gate, metrics
    on) with two tenants, both (fused, ragged) at the kernel executor: the
    default tenant ``seg`` is ``store`` (the segments phase's base + 4
    deltas, served through the segmented entry) and ``base`` is the
    in-memory index (the single-array ragged kernel). SERVE_REQUESTS
    open-loop Poisson arrivals at SERVE_LOAD x the measured burst capacity,
    Zipf-skewed over SERVE_POOL queries, split across the tenants, some
    with a deadline and some with a 50% allowlist; midway 1% of ``seg``'s
    ids are deleted. Every reply is held against ``retriever.plan(cfg,
    dfilter=effective).retrieve`` of the epoch that served it (ids equal up
    to reported tie swaps), no deleted or filtered id may appear, cache hits
    must equal their misses bit for bit, and both kernels must have been
    launched. Then the fault cases (a failing ``server.reload``; a
    ``store.segment_load`` fault quarantining a delta on reload;
    ``engine.kernel_call`` failing a batch), one ``maintain()`` (compact +
    reload), SERVE_TRACED traced requests exported as Chrome JSON and
    checked span by span, retrieve p50 with obs off / metrics / tracing,
    and one run of the serve launcher on the card. Returns the phase's
    numbers."""
    from repro_torch import fault, obs
    from repro_torch.core import DocFilter, Retriever, WarpSearchConfig
    from repro_torch.fault import FaultPlan, FaultRule, InjectedFault
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import (
        PENDING, AdmissionPolicy, BatchPolicy, CompactionPolicy, DeadlineExceeded,
        Overloaded, ResultAlreadyTaken, RetrievalServer,
    )

    smi = card()
    t_phase = time.perf_counter()
    cfg = WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    )
    os.remove(os.path.join(store, "tombstones.json"))  # deletes come midway
    reg = obs.enable_metrics(obs.MetricsRegistry())
    swaps = 0
    try:
        t0 = time.perf_counter()
        server = RetrievalServer(
            Retriever.from_store(store, device=dev), cfg,
            BatchPolicy(max_batch=8, max_wait_s=0.002),
            admission=AdmissionPolicy(max_queue_depth=16 * 8),  # the serve launcher's
            compaction=CompactionPolicy(max_delta_segments=0, min_interval_s=0.0),
            store_path=store, registry=reg, cache_size=256,
        )
        server.add_tenant("base", Retriever.from_index(index, device=dev))
        tenants = (None, "base")
        names = {None: "seg", "base": "base"}
        log(f"[serving] server up with tenants seg (base + {server.retriever.index.n_segments - 1} "
            f"deltas, {server.retriever.n_docs} docs) and base ({index.n_docs} docs), every ladder "
            f"rung warmed, in {time.perf_counter() - t0:.3f} s; {smi}")

        q, qmask = make_queries(torch, index, SERVE_POOL, seed, lo=4, hi=32)
        qh, mh = q.cpu().numpy(), qmask.cpu().numpy()
        rng = np.random.default_rng(seed)
        n_docs = {t: server._state(t).retriever.n_docs for t in tenants}
        allow = {t: DocFilter.allow(rng.choice(n, n // 2, replace=False), n) for t, n in n_docs.items()}

        # Burst capacity on cache misses: every pool query, one tenant at a
        # time (a burst of SERVE_POOL stays under the gate's depth).
        burst, burst_s = [], 0.0
        for t in tenants:
            t0 = time.perf_counter()
            rids = [server.submit(qh[i], mh[i], tenant=t) for i in range(SERVE_POOL)]
            server.drain()
            burst_s += time.perf_counter() - t0
            burst += [server.poll(rid) for rid in rids]
        capacity = len(burst) / burst_s
        server.result_cache.clear()
        server._rung_cache.clear()

        # Open-loop traffic.
        rate = SERVE_LOAD * capacity
        p = np.arange(1, SERVE_POOL + 1, dtype=np.float64) ** -SERVE_SKEW
        p /= p.sum()
        n = SERVE_REQUESTS
        arrive = np.cumsum(rng.exponential(1.0 / rate, n))
        pick = rng.choice(SERVE_POOL, n, p=p)
        route = rng.integers(0, 2, n)
        with_deadline = rng.random(n) < SERVE_DEADLINE_FRAC
        with_filter = rng.random(n) < SERVE_FILTER_FRAC
        seg_n = n_docs[None]
        dead = np.sort(rng.choice(seg_n, int(round(SERVE_DELETE_FRAC * seg_n)), replace=False))
        replies, lat, hit, phase_of = {}, np.full(n, np.nan), np.zeros(n, bool), {}
        overloaded, expired = [], []
        waiting: dict = {}
        deleted_at = None

        def collect(now):
            for rid, i in list(waiting.items()):
                try:
                    out = server.poll(rid)
                except DeadlineExceeded:
                    expired.append(i)
                    del waiting[rid]
                    continue
                if out is not PENDING:
                    replies[i] = out
                    lat[i] = now - arrive[i]
                    phase_of[i] = "post" if deleted_at is not None else "pre"
                    del waiting[rid]

        reset_launches()
        nxt = 0
        t0 = time.perf_counter()
        while nxt < n or waiting:
            now = time.perf_counter() - t0
            while nxt < n and arrive[nxt] <= now:
                i, t = nxt, tenants[route[nxt]]
                nxt += 1
                try:
                    rid = server.submit(
                        qh[pick[i]], mh[pick[i]], tenant=t,
                        dfilter=allow[t] if with_filter[i] else None,
                        deadline_s=SERVE_DEADLINE_S if with_deadline[i] else None,
                    )
                except Overloaded:
                    overloaded.append(i)
                    continue
                waiting[rid] = i
                collect(now)
                hit[i] = i in replies
            if deleted_at is None and nxt >= n // 2:
                collect(time.perf_counter() - t0)
                server.delete_documents(dead.tolist())
                deleted_at = nxt
            if server.step() == 0:
                time.sleep(1e-4)
            collect(time.perf_counter() - t0)
        traffic_s = time.perf_counter() - t0
        launched = {k: LAUNCHES[k] for k in ("ragged_fused_gather_score", "segmented_ragged_fused_gather_score")}
        if not all(launched.values()):
            fail(f"serving: a kernel of the path was never launched: {launched}")

        # Every reply against plan.retrieve of its epoch and filter.
        dead_set = frozenset(dead.tolist())
        tomb = DocFilter.tombstones(dead, seg_n)
        want_cache, first_miss = {}, {}
        for i, (scores, ids) in sorted(replies.items()):
            t, f = tenants[route[i]], with_filter[i]
            post = phase_of[i] == "post" and t is None
            key = (t, int(pick[i]), bool(f), post)
            if key not in want_cache:
                eff = allow[t] if f else None
                if post:
                    eff = tomb if eff is None else eff.intersect(tomb)
                plan = server._state(t).retriever.plan(cfg, dfilter=eff)
                res = plan.retrieve(qh[pick[i]], mh[pick[i]])
                want_cache[key] = (res.doc_ids.cpu().numpy(), res.scores.cpu().numpy())
            swaps += topk_swaps(f"serving reply {i} ({names[t]}) vs plan.retrieve", ids, scores,
                                *want_cache[key], kernel_err)
            got = ids[ids >= 0]
            if f and not allow[t].survivor_mask[got].all():
                fail(f"serving reply {i}: a filtered doc was returned")
            if post and dead_set.intersection(got.tolist()):
                fail(f"serving reply {i}: a deleted doc was returned")
            ck = key + (phase_of[i],)
            if not hit[i]:
                first_miss.setdefault(ck, (scores, ids))
        hits = 0
        for i in np.flatnonzero(hit):
            t = tenants[route[i]]
            ck = (t, int(pick[i]), bool(with_filter[i]), phase_of[i] == "post" and t is None, phase_of[i])
            scores, ids = replies[i]
            ms, mi = first_miss[ck]
            if not (np.array_equal(scores, ms) and np.array_equal(ids, mi)):
                fail(f"serving reply {i}: a cache hit differs from its miss")
            hits += 1
        served = len(replies)
        if served + len(overloaded) + len(expired) != n:
            fail(f"serving: {served} replies + {len(overloaded)} overloaded + {len(expired)} "
                 f"expired != {n} requests")
        pct = percentiles_ms(lat[~np.isnan(lat)])
        summary = server.summary()
        log(f"[serving] burst capacity {capacity:.3f} requests/s ({len(burst)} misses in "
            f"{burst_s * 1e3:.3f} ms); {n} Poisson arrivals at {rate:.3f}/s over {traffic_s:.3f} s, "
            f"Zipf {SERVE_SKEW} over {SERVE_POOL} queries, {int(with_deadline.sum())} with a "
            f"{SERVE_DEADLINE_S * 1e3:g} ms deadline, {int(with_filter.sum())} with a 50% "
            f"allowlist, {len(dead)} seg docs deleted after arrival {deleted_at}; {smi}")
        log(f"[serving] arrival-to-reply latency (ms) {json.dumps(pct)}; cache hit rate "
            f"{hits / max(1, served):.4f} ({hits} of {served} replies at submit); overloaded "
            f"{len(overloaded)}, deadline-shed {len(expired)}; launches {launched}; "
            f"{served} replies equal plan.retrieve of their epoch and filter ({swaps} places "
            f"swapped within a tie); no deleted or filtered doc returned; every cache hit equals "
            f"its miss bit for bit; {smi}")
        log(f"[serving] summary {json.dumps(summary)}")

        # Faults: each leaves the server serving.
        before = (server.index_epoch, server.retriever, len(server.result_cache))
        with fault.active(FaultPlan([FaultRule("server.reload")])):
            try:
                server.reload(store)
                fail("serving: a reload under a server.reload fault succeeded")
            except InjectedFault:
                pass
        if (server.index_epoch, server.retriever, len(server.result_cache)) != before:
            fail("serving: a failed reload changed the server")
        rid = server.submit(qh[0], mh[0], tenant="base")
        _, ids = server.result(rid)
        if not np.array_equal(ids, want_cache.get(("base", 0, False, False), (ids,))[0]):
            fail("serving: after a failed reload the old epoch answers differently")
        log(f"[serving] fault server.reload: reload raised, epoch {server.index_epoch}, "
            "index, caches and queue untouched, still serving")
        t0 = time.perf_counter()
        with fault.active(FaultPlan([FaultRule("store.segment_load", at=1)])), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            server.reload(store)
        h = server.health()
        if h["status"] != "degraded" or h["quarantined_segments"] != ["seg_00001"]:
            fail(f"serving: a quarantining reload left health {h}")
        rid = server.submit(qh[1], mh[1])
        scores, ids = server.result(rid)
        want = server._plan_for(server._state(None), None)[0].retrieve(qh[1], mh[1])
        swaps += topk_swaps("serving quarantined reply vs plan.retrieve", ids, scores,
                            want.doc_ids.cpu().numpy(), want.scores.cpu().numpy(), kernel_err)
        log(f"[serving] fault store.segment_load on reload: seg_00001 quarantined in "
            f"{time.perf_counter() - t0:.3f} s, health {h['status']} ({h['reasons']}), serving "
            f"epoch {server.index_epoch}")
        before = dict(LAUNCHES)
        server.result_cache.clear()  # three misses of one rung: one batch
        rids = [server.submit(qh[-1], mh[-1], tenant="base") for _ in range(3)]
        with fault.active(FaultPlan([FaultRule("engine.kernel_call", times=1000)])):
            try:
                server.step(force=True)
                fail("serving: a batch dispatched under an engine.kernel_call fault")
            except InjectedFault as e:
                err = e
        if len(server.scheduler):
            fail("serving: the failed batch left requests queued")
        for rid in rids:
            try:
                server.poll(rid)
                fail("serving: a request of the failed batch was answered")
            except InjectedFault as e:
                if e is not err:
                    fail("serving: a poll raised another error than the batch's")
            try:
                server.poll(rid)
                fail("serving: a failed request's error was delivered twice")
            except ResultAlreadyTaken:
                pass
        if LAUNCHES != before or server.health()["status"] != "degraded":
            fail("serving: the failed batch launched a kernel or left health ok")
        log(f"[serving] fault engine.kernel_call: step raised {type(err).__name__}, each of "
            f"{len(rids)} polls raised it once, no reply, no launch; health "
            f"{server.health()['reasons'][-1]!r}")

        # Maintenance: one compaction of seg (deltas and deleted rows) and reload.
        t0 = time.perf_counter()
        if not server.maintain():
            fail(f"serving: maintain() did not compact ({server.health()})")
        maintain_s = time.perf_counter() - t0
        if server.retriever.is_segmented or server.store_path != store:
            fail("serving: after maintain() seg is not one index from its store")
        for j in range(8):
            for t in tenants:
                scores, ids = server.result(server.submit(qh[j], mh[j], tenant=t))
                want = server._plan_for(server._state(t), None)[0].retrieve(qh[j], mh[j])
                swaps += topk_swaps(f"serving after maintain, {names[t]} query {j}", ids, scores,
                                    want.doc_ids.cpu().numpy(), want.scores.cpu().numpy(), kernel_err)
                if t is None and dead_set.intersection(ids.tolist()):
                    fail("serving: the compacted seg returned a deleted doc")
        if server.health()["status"] != "ok":  # good batches cleared the dispatch failure
            fail(f"serving: after maintain() and good batches, health {server.health()}")
        log(f"[serving] maintain(): compact + reload of seg in {maintain_s:.3f} s, epoch "
            f"{server.index_epoch}, {server.retriever.index.n_tokens} tokens; 16 replies equal "
            f"plan.retrieve; {smi}")

        # Tracing: SERVE_TRACED requests, exported and checked span by span.
        tr = obs.set_tracer(obs.Tracer(clock=server.clock))
        server.result_cache.clear()
        rids = [server.submit(qh[j % SERVE_POOL], mh[j % SERVE_POOL], tenant=tenants[j % 2])
                for j in range(SERVE_TRACED)]
        server.drain()
        for rid in rids:
            server.poll(rid)
        obs.set_tracer(None)
        trace_path = os.path.join(os.path.dirname(store), "serving_trace.json")
        tr.export(trace_path)
        with open(trace_path) as f:
            rows = span_rows(json.load(f)["traceEvents"])
        for rid in rids:
            row = rows.get(rid, {})
            disp = row.get("dispatch", [])
            if not ({"admission", "rung_prepass"} <= set(row.get("submit", ()))
                    and "queue_wait" in row and {"retrieve", "reply"} <= set(disp)
                    and ({"warp_select", "gather_score", "reduce"} <= set(disp) or "engine" in disp)):
                fail(f"serving: request {rid}'s span tree is incomplete: {row}")
        stages = {
            dict(m.labels)["stage"]: m.quantile(0.5) * 1e3 for m in reg.series("warp_stage_seconds")
        }
        log(f"[serving] {SERVE_TRACED} traced requests: every span tree complete (submit > "
            f"admission, rung_prepass; queue_wait; batch_dispatch > retrieve > stages, reply); "
            f"{len(tr.events())} events, {tr.dropped} dropped; per-stage p50 (ms) "
            f"{json.dumps(stages)}; {smi}")

        # Obs overhead on the base plan: obs off / metrics / tracing,
        # interleaved; the three results must be the same bits.
        plan = server._state("base").plan
        arms = {"off": [], "metrics": [], "tracing": []}
        for i in range(SERVE_OBS_QUERIES):
            j = i % SERVE_POOL
            got = []
            for arm in arms:
                obs.disable_all()
                if arm != "off":
                    obs.enable_metrics(obs.MetricsRegistry())
                if arm == "tracing":
                    obs.set_tracer(obs.Tracer())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got.append(plan.retrieve(q[j], qmask[j]))
                torch.cuda.synchronize()
                arms[arm].append(time.perf_counter() - t0)
            if not all(torch.equal(r.doc_ids, got[0].doc_ids) and torch.equal(r.scores, got[0].scores)
                       for r in got[1:]):
                fail(f"serving: query {j}'s traced or metered retrieve is not bit-identical")
        obs.disable_all()
        p50 = {arm: percentiles_ms(v)["p50"] for arm, v in arms.items()}
        log(f"[serving] retrieve p50 over {SERVE_OBS_QUERIES} queries (ms): obs off "
            f"{p50['off']:.4f}, metrics {p50['metrics']:.4f}, tracing {p50['tracing']:.4f}; "
            f"the three bit-identical on every query; {smi}")

        # The serve launcher on the card.
        out = os.path.dirname(store)
        lt, lm = os.path.join(out, "serve_trace.json"), os.path.join(out, "serve_metrics.prom")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            rc = serve_cli.main([
                "--traffic", "poisson", "--duration-s", "2", "--tenants", "2", "--layout", "ragged",
                "--gather", "fused", "--executor", "kernel", "--trace-out", lt, "--metrics-dump", lm,
            ])
        with open(lt) as f:
            lt_names = {e["name"] for e in json.load(f)["traceEvents"]}
        with open(lm) as f:
            lm_lines = f.read().splitlines()
        sample = re.compile(r'^[a-z_]+(\{[a-z_]+="[^"]*"(,[a-z_]+="[^"]*")*\})? [-+0-9.e]+$')
        if rc != 0 or not {"submit", "batch_dispatch", "gather_score", "reply"} <= lt_names or not (
            lm_lines and all(ln.startswith("# ") or sample.match(ln) for ln in lm_lines)
        ):
            fail(f"serving: the serve launcher exited {rc} or wrote an invalid trace or dump")
        log(f"[serving] launch.serve --traffic poisson --tenants 2 on the card: exit 0 in "
            f"{time.perf_counter() - t0:.3f} s, trace of {len(lt_names)} span names, "
            f"{len(lm_lines)} metric lines valid")
        phase_s = time.perf_counter() - t_phase
        log(f"[serving] phase done in {phase_s:.3f} s; {swaps} places swapped within a tie; {smi}")
        return dict(latency_ms=pct, capacity=capacity, rate=rate, served=served, hits=hits,
                    overloaded=len(overloaded), expired=len(expired), stages_ms=stages,
                    obs_p50_ms=p50, maintain_s=maintain_s, phase_s=phase_s)
    finally:
        obs.disable_all()
        fault.uninstall()


def phase_sharded(
    torch, index, dev, seed: int, kernel_err: float, store: str, profile: bool = False
) -> dict:
    """Document-sharded search at full Lifestyle width: the index cut by
    ``shard_index`` into SHARDS contiguous token-balanced document ranges
    that keep its centroids and codec (each shard its own CSR), stacked on
    the card. With shared centroids the sharded plan must return what the
    single index returns (each shard probes the same clusters, the merged
    cumulative sizes cross t' at the same centroid score, a document's
    tokens all live in one shard): SHARD_QUERIES queries single and
    batched at the four configs x both executors, doc ids identical up to
    reported tie swaps, scores within TOL, exactly one scoring launch per
    shard per retrieve at the kernel executor. Then the store round trip
    (``save_index``, ``verify_store``, ``Retriever.from_store``: bit for
    bit), a ``RetrievalServer`` over that store (a burst, Poisson arrivals,
    a 50% allowlist, a 1% delete; every reply equal to ``plan.retrieve``)
    and ``launch.serve --n-shards SHARDS``; with ``profile``, where a
    sharded retrieve's time goes (``phase_profile``). Returns the scoring
    kernels' launches of the retrieve loop (counts set to 0 just before
    it) and the plans' latency percentiles."""
    from repro_torch.core import DocFilter, Retriever, WarpSearchConfig, shard_index
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import serve as serve_cli
    from repro_torch.store import save_index, verify_store

    def cfg(gather, layout, executor="kernel"):
        return WarpSearchConfig(
            nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
            gather=gather, layout=layout, executor=executor,
        )

    smi = card()
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sidx = shard_index(index, SHARDS)
    torch.cuda.synchronize()
    tokens = sidx.cluster_sizes.sum(dim=1).tolist()
    log(f"[sharded] shard_index into {SHARDS} shards in {(time.perf_counter() - t0) * 1e3:.3f} ms: "
        f"doc_start {sidx.doc_start.tolist()}, tokens {tokens} (padded to {sidx.n_tokens_padded}), "
        f"local_docs {sidx.local_docs}, cap {sidx.cap}, {sidx.nbytes() / 1e9:.3f} GB on the card; {smi}")
    if sum(tokens) != index.n_tokens or max(tokens) - min(tokens) > 0.01 * index.n_tokens:
        fail(f"sharded: shards hold {tokens} tokens, not a token-balanced cut of {index.n_tokens}")
    single, rs = Retriever.from_index(index, device=dev), Retriever.from_index(sidx, device=dev)
    q, qmask = make_queries(torch, index, SHARD_QUERIES, seed)
    qh, mh = q.cpu().numpy(), qmask.cpu().numpy()

    results, lat, swaps = {}, {}, 0
    plans = {}
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            for which, r in (("sharded", rs), ("single", single)):
                plan = r.plan(cfg(gather, layout, executor))
                plan.warmup()
                plan.retrieve(q[0], qmask[0])
                plans[(which, gather, layout, executor)] = plan
    reset_launches()  # the sharded main path starts here
    used = {}
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            plan = plans[("sharded",) + key]
            before = dict(LAUNCHES)
            res, times = run_timed(torch, plan, q, qmask)
            bres = [plan.retrieve_batch(qh[4 * b: 4 * b + 4], mh[4 * b: 4 * b + 4])
                    for b in range(SHARD_BATCHES)]
            used[key] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            results[key], lat[key] = (res, bres), percentiles_ms(times)
    counts = dict(LAUNCHES)  # read right after the sharded main path's run
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            name = "/".join(key)
            res, bres = results[key]
            want = (SHARD_QUERIES + SHARD_BATCHES) * SHARDS if executor == "kernel" else 0
            kname = KERNEL_OF[(gather, layout)]
            if used[key][kname] != want or sum(used[key].values()) != want:
                fail(f"sharded {name}: launches {used[key]} over {SHARD_QUERIES} retrieves and "
                     f"{SHARD_BATCHES} batches, expected {kname} once per shard per retrieve ({want})")
            for b in range(SHARD_BATCHES):
                for j in range(4):
                    swaps += topk_swaps(
                        f"sharded {name} retrieve_batch vs retrieve, query {4 * b + j}",
                        bres[b].doc_ids[j].cpu().numpy(), bres[b].scores[j].cpu().numpy(),
                        *res[4 * b + j], kernel_err,
                    )
            sres, stimes = run_timed(torch, plans[("single",) + key], q, qmask)
            for i in range(SHARD_QUERIES):
                swaps += topk_swaps(f"sharded {name} vs the single index, query {i}",
                                    *res[i], *sres[i], kernel_err)
            results[key] = res
            lat[("single",) + key] = percentiles_ms(stimes)
            d = plans[("sharded",) + key].describe()
            log(f"[sharded] {name}: per-query latency (ms) {json.dumps(lat[key])} beside the single "
                f"index's {json.dumps(lat[('single',) + key])}; launches {used[key]}; t' {d['t_prime']}, "
                f"worklist {d['worklist_tiles']} {d['worklist_buckets']}; {smi}")
    for gather, layout in CONFIGS:
        for i in range(SHARD_QUERIES):
            swaps += topk_swaps(
                f"sharded {gather}/{layout} kernel vs reference, query {i}",
                *results[(gather, layout, "kernel")][i], *results[(gather, layout, "reference")][i],
                kernel_err,
            )
    if profile:
        phase_profile(torch, rs, q, qmask, tag="sharded profile")
    log(f"[sharded] {SHARDS} shards = the single index at 4 configs x 2 executors over "
        f"{SHARD_QUERIES} queries (doc ids up to {swaps} places swapped within a tie, scores within "
        f"{TOL}); one scoring launch per shard per retrieve; {smi}")

    # Store round trip.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_index(sidx, store)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = verify_store(store)
    t_verify = time.perf_counter() - t0
    t0 = time.perf_counter()
    rl = Retriever.from_store(store, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if not rl.is_sharded or rl.n_shards != SHARDS:
        fail(f"sharded: the store loaded as {type(rl.index).__name__}")
    main_cfg = cfg("fused", "ragged")
    loaded, _ = run_timed(torch, rl.plan(main_cfg), q, qmask)
    for i in range(SHARD_QUERIES):
        a, b = loaded[i], results[("fused", "ragged", "kernel")][i]
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            fail(f"sharded: the reloaded store's query {i} differs from the in-memory stack")
    log(f"[sharded] save_index {t_save:.3f} s, verify_store {t_verify:.3f} s ({report['checked']} "
        f"arrays, {report['dirs']} manifest dirs), Retriever.from_store {t_load:.3f} s; reloaded "
        f"fused/ragged bit-identical on {SHARD_QUERIES} queries; {smi}")
    del rl, plans

    # Served from the store: a burst, Poisson arrivals, a filter, a delete.
    server, sq, sm = phase_serve(
        torch, Retriever.from_store(store, device=dev), SHARD_SERVE_REQUESTS, seed + 1,
        kernel_err, index=index, store_path=store, tag="sharded serve",
    )
    replies = {}
    rng = np.random.default_rng(seed)
    nd = rs.n_docs
    allow = DocFilter.allow(rng.choice(nd, int(SHARD_ALLOW_FRAC * nd), replace=False), nd)
    rids = [server.submit(sq[i], sm[i], dfilter=allow) for i in range(SHARD_FILTERED)]
    server.drain()
    replies.update({("allow", i): server.poll(rid) for i, rid in enumerate(rids)})
    deleted = rng.choice(nd, int(round(SHARD_DELETE_FRAC * nd)), replace=False)
    server.delete_documents(deleted.tolist())
    tomb = DocFilter.tombstones(deleted.tolist(), nd)
    rids = [server.submit(sq[i], sm[i]) for i in range(SHARD_FILTERED)]
    server.drain()
    replies.update({("deleted", i): server.poll(rid) for i, rid in enumerate(rids)})
    served = server.retriever
    views = {"allow": allow, "deleted": tomb}
    for (view, i), (scores, ids) in sorted(replies.items()):
        dfilter = views[view]
        if not dfilter.survivor_mask[ids[ids >= 0]].all():
            fail(f"sharded serving: reply {i} ({view}) holds a filtered or deleted doc")
        want = served.plan(main_cfg, dfilter=dfilter).retrieve(sq[i], sm[i])
        swaps += topk_swaps(f"sharded serving reply {i} ({view}) vs plan.retrieve", ids, scores,
                            want.doc_ids.cpu().numpy(), want.scores.cpu().numpy(), kernel_err)
    log(f"[sharded] served from the store: {SHARD_FILTERED} under a 50% allowlist, "
        f"{SHARD_FILTERED} after deleting {len(deleted)} docs: {len(replies)} replies equal "
        f"plan.retrieve, none filtered or deleted; summary {json.dumps(server.summary())}; {smi}")
    del server, served

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = serve_cli.main(["--n-shards", str(SHARDS), "--queries", "32", "--layout", "ragged",
                             "--gather", "fused", "--executor", "kernel"])
    if rc != 0:
        fail(f"sharded: launch.serve --n-shards {SHARDS} exited {rc}")
    log(f"[sharded] launch.serve --n-shards {SHARDS} on the card: exit 0 in "
        f"{time.perf_counter() - t0:.3f} s")
    out = dict(counts=counts, lat=lat, swaps=swaps, sidx=sidx, single=single, rs=rs)
    log(f"[sharded] phase done in {time.perf_counter() - t_phase:.3f} s; {smi}")
    return out


def encode_tokens(torch, n: int, vocab: int, seed: int, dev, *, lo=8, hi=32, s=32):
    """n queries of lo..hi random token ids, padded to s: (tokens i32[n, s],
    mask bool[n, s]) on ``dev``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, vocab, (n, s), generator=g, device=dev, dtype=torch.int32)
    lens = torch.randint(lo, hi + 1, (n, 1), generator=g, device=dev)
    mask = torch.arange(s, device=dev) < lens
    return tokens * mask, mask


def phase_encode(torch, dev, seed: int, kernel_err: float, sh: dict, profile: bool = False) -> None:
    """The XTR token encoder at ``EncoderConfig`` defaults (12 layers, d
    768, 12 heads, d_ff 2048, vocab 32,128, out 128) with random float32
    weights from ``seed``: ENCODE_QUERIES queries of 8-32 token ids padded
    to 32, encoded at batch 1 and batch 32 (p50 / p95 per batch); valid
    rows unit-norm, padding rows exactly 0, the two batchings within
    ENCODE_TOL. The encoded queries are then retrieved over the sharded and
    the single index at (fused, ragged, kernel): doc ids identical up to
    reported tie swaps; the encode p50 is printed beside the retrieve p50
    at batch 1. With ``profile``, five batch-1 encodes under
    ``torch.profiler``: device-busy share and launches per encode."""
    from repro_torch.models import EncoderConfig, TokenEncoder, init_params

    smi = card()
    cfg = EncoderConfig()
    g = torch.Generator(device=dev).manual_seed(seed)
    model = TokenEncoder.from_params(cfg, init_params(cfg, g, device=dev))
    tokens, mask = encode_tokens(torch, ENCODE_QUERIES, cfg.vocab, seed + 1, dev)
    outs, lat = {}, {}
    for b in ENCODE_BATCHES:
        model.encode(tokens[:b], mask[:b])  # warm-up
        parts, times = [], []
        for lo in range(0, ENCODE_QUERIES, b):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts.append(model.encode(tokens[lo: lo + b], mask[lo: lo + b]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        outs[b] = torch.cat(parts)
        lat[b] = percentiles_ms(times)
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(5):
                model.encode(tokens[i: i + 1], mask[i: i + 1])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        busy = sum(getattr(e, "self_device_time_total", 0) for e in events
                   if str(e.device_type).endswith("CUDA"))
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        top = sorted(((getattr(e, "self_device_time_total", 0), e.key) for e in events
                      if str(e.device_type).endswith("CUDA")), reverse=True)[:5]
        log(f"[encode profile] batch 1: {wall_us / 5:.1f} us wall per encode, device kernels "
            f"{busy / 5:.1f} us ({busy / wall_us:.1%} busy), {launches / 5:.0f} kernel launches; "
            "top kernels: " + "; ".join(f"{k[:40]} {t / 5:.1f}us" for t, k in top))
    emb = outs[ENCODE_BATCHES[0]]
    if emb.shape != (ENCODE_QUERIES, cfg.query_maxlen, cfg.out_dim) or emb.dtype != torch.float32:
        fail(f"encode: output {tuple(emb.shape)} {emb.dtype}")
    norms = emb[mask].norm(dim=-1)
    pad_max = float(emb[~mask].abs().max()) if (~mask).any() else 0.0
    if not bool(torch.isfinite(emb).all()) or float((norms - 1).abs().max()) > 1e-5 or pad_max != 0.0:
        fail(f"encode: rows not unit-norm ({float((norms - 1).abs().max()):.3g}) or padding not 0 "
             f"({pad_max})")
    diff = float((outs[ENCODE_BATCHES[0]] - outs[ENCODE_BATCHES[-1]]).abs().max())
    if diff > ENCODE_TOL:
        fail(f"encode: batch {ENCODE_BATCHES[0]} and {ENCODE_BATCHES[-1]} differ by {diff}")
    log(f"[encode] TokenEncoder ({cfg.n_layers} layers, d {cfg.d_model}, {cfg.param_count()} params, "
        f"float32) over {ENCODE_QUERIES} queries of 8-32 tokens padded to {cfg.query_maxlen}: "
        + "; ".join(f"batch {b} p50 / p95 {lat[b]['p50']:.4f} / {lat[b]['p95']:.4f} ms "
                    f"({b / lat[b]['p50'] * 1e3:.1f} queries/s at p50)" for b in ENCODE_BATCHES)
        + f"; rows unit-norm within {float((norms - 1).abs().max()):.3g}, padding rows 0, batchings "
        f"within {diff:.3g}; {smi}")

    from repro_torch.core import WarpSearchConfig

    qcfg = WarpSearchConfig(nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
                            gather="fused", layout="ragged", executor="kernel")
    got = {}
    for which in ("rs", "single"):
        plan = sh[which].plan(qcfg)
        got[which], times = run_timed(torch, plan, emb, mask)
        lat[which] = percentiles_ms(times)
    swaps = sum(
        topk_swaps(f"encoded query {i}: sharded vs single", *got["rs"][i], *got["single"][i],
                   kernel_err)
        for i in range(ENCODE_QUERIES)
    )
    log(f"[encode] at batch 1: encode p50 {lat[1]['p50']:.4f} ms beside retrieve p50 "
        f"{lat['rs']['p50']:.4f} ms ({SHARDS} shards) / {lat['single']['p50']:.4f} ms (single "
        f"index), fused/ragged/kernel; encode share of encode + retrieve "
        f"{lat[1]['p50'] / (lat[1]['p50'] + lat['rs']['p50']):.3f} (sharded), "
        f"{lat[1]['p50'] / (lat[1]['p50'] + lat['single']['p50']):.3f} (single); the encoded "
        f"queries' doc ids equal across the two up to {swaps} tie swaps; {smi}")


def phase_profile(torch, retriever, queries, qmask, n: int = 5, tag: str = "profile"):
    """Where a retrieve's time goes, per kernel config: ``torch.profiler``
    over ``n`` retrieves — wall time, device-busy share (summed device
    kernel time over wall), the top device kernels and the top host ops
    by self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import WarpSearchConfig

    for gather, layout in CONFIGS:
        plan = retriever.plan(WarpSearchConfig(
            nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
            gather=gather, layout=layout, executor="kernel",
        ))
        plan.retrieve(queries[0], qmask[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                plan.retrieve(queries[i], qmask[i])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        kernels = sorted(
            ((getattr(e, "self_device_time_total", 0), e.key) for e in events
             if str(e.device_type).endswith("CUDA")),
            reverse=True,
        )
        host = sorted(
            ((e.self_cpu_time_total, e.key) for e in events
             if str(e.device_type).endswith("CPU")),
            reverse=True,
        )
        busy = sum(t for t, _ in kernels)
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        top_k = "; ".join(f"{k[:40]} {t / n:.1f}us" for t, k in kernels[:6])
        top_h = "; ".join(f"{k[:32]} {t / n:.1f}us" for t, k in host[:6])
        scoring = KERNEL_OF[(gather, layout)]
        score_us = sum(t for t, k in kernels if f"::{scoring}_kernel<" in k)
        log(
            f"[{tag}] {gather}/{layout}/kernel: {wall_us / n:.1f} us wall per retrieve, "
            f"device kernels {busy / n:.1f} us ({busy / wall_us:.1%} busy), "
            f"{launches / n:.0f} kernel launches; {scoring} {score_us / n:.1f} us; top kernels "
            f"per retrieve: {top_k} | top host ops (self CPU): {top_h}"
        )


def phase_fixture(torch, dev):
    from repro_torch.core import Retriever, WarpSearchConfig

    fdir = os.path.join(ROOT, "tests", "data", "torch_fixture")
    with open(os.path.join(fdir, "expected.json")) as f:
        expected = json.load(f)
    qz = np.load(os.path.join(fdir, "queries.npz"))
    r = Retriever.from_store(os.path.join(fdir, "store"), device=dev)
    n = 0
    for case in expected["cases"]:
        for executor in ("kernel", "reference"):
            cfg = WarpSearchConfig(**case["config"], executor=executor)
            res = r.plan(cfg).retrieve_batch(qz["q"], qz["qmask"])
            ids, sc = res.doc_ids.cpu().numpy(), res.scores.cpu().numpy()
            for i in range(len(ids)):
                if not np.array_equal(ids[i], np.asarray(case["doc_ids"][i])):
                    fail(f"fixture {case['name']}/{executor} query {i}: doc ids differ from JAX")
                np.testing.assert_allclose(sc[i], case["scores"][i], rtol=TOL, atol=TOL)
                n += 1
    log(f"[fixture] {n} (query, config, executor) results match the JAX expected ids")


@contextlib.contextmanager
def timed_passes(torch, times: dict):
    """Time the build's passes (each ended by a synchronize) into ``times``
    while the block runs, by wrapping the functions the builder calls."""
    from repro_torch.core import kmeans, quantization
    from repro_torch.store import builder

    targets = (
        (builder, "sample_indices", "sample"), (builder, "gather_sample", "sample"),
        (kmeans, "spherical_kmeans", "kmeans"), (builder, "assign_pass", "assign"),
        (quantization, "compute_buckets", "buckets"), (builder, "scatter_pass", "scatter"),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def timed(fn, label):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[label] = times.get(label, 0.0) + time.perf_counter() - t0
            return out

        return run

    try:
        for (mod, name, label), (_, _, fn) in zip(targets, saved):
            setattr(mod, name, timed(fn, label))
        yield times
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_build_determinism(torch, corpus, index, cfg, dev) -> None:
    """Passes 2-3 again from the same centroids at another chunk_size give
    the same arrays; one Lloyd step run twice gives the same bits."""
    from repro_torch.core import kmeans
    from repro_torch.store import array_chunks, builder

    n = corpus.n_tokens
    normed = builder.normalized_chunks(
        array_chunks(corpus.emb, corpus.token_doc_ids, BUILD_CHUNK_AGAIN), dev
    )
    packed = np.empty(tuple(index.packed_codes.shape), np.uint8)
    docs = np.empty(n, np.int32)
    got = builder.encode_corpus(
        normed, index.centroids, cfg.nbits, n,
        assign_out=np.empty(n, np.int32), packed_out=packed, docs_out=docs,
    )
    got.update(packed_codes=packed, token_doc_ids=docs)
    for name, arr in got.items():
        if not np.array_equal(arr, getattr(index, name).cpu().numpy()):
            fail(f"build: {name} at chunk_size {BUILD_CHUNK_AGAIN} differs from the build's")
    gen = torch.Generator().manual_seed(cfg.seed)
    idx = builder.sample_indices(n, index.n_centroids, cfg, gen)
    pts = kmeans.l2_normalize(torch.from_numpy(corpus.emb[idx]).to(dev))
    reseed = torch.randint(0, pts.shape[0], (index.n_centroids,), generator=gen)
    first = kmeans.lloyd_step(pts, index.centroids, reseed)
    if not torch.equal(first, kmeans.lloyd_step(pts, index.centroids, reseed)):
        fail("build: one Lloyd step run twice on the card gave other centroids")
    log(
        f"[build] passes 2-3 at chunk_size {BUILD_CHUNK_AGAIN} give the same centroids, CSR, "
        f"cutoffs, weights, codes and doc ids; a Lloyd step over {pts.shape[0]} points x "
        f"{index.n_centroids} centroids gives the same bits twice"
    )


def check_index_invariants(torch, index, path) -> None:
    from repro_torch.store import verify_store

    offs = index.cluster_offsets.long()
    sizes = index.cluster_sizes.long()
    if not torch.equal(offs[1:] - offs[:-1], sizes) or int(offs[0]) != 0:
        fail("build: cluster_offsets do not step by cluster_sizes")
    if int(offs[-1]) != index.n_tokens or index.cap != int(sizes.max()):
        fail("build: the CSR does not cover the tokens, or cap is not the largest cluster")
    err = float((index.centroids.norm(dim=1) - 1).abs().max())
    if not err <= 1e-4:
        fail(f"build: a centroid's norm is {err} off 1")
    report = verify_store(path, full=True)
    log(
        f"[build] invariants hold: offsets step by sizes, cap {index.cap} = largest cluster, "
        f"centroid norms within {err:.3g} of 1; verify_store(full=True) {json.dumps(report)}"
    )


def n_recall(got, gold, k: int = 100, gold_k: int = 10) -> float:
    """nRecall@k (benchmarks/bench_quality.py): the share of the exact
    MaxSim top-``gold_k`` found in the top-``k``."""
    return len(set(got[:k].tolist()) & set(gold[:gold_k].tolist())) / gold_k


def profile_build(torch, label: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler``: wall time, device busy
    share, the top device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev_k = sorted(
        ((getattr(e, "self_device_time_total", 0), e.count, e.key) for e in events
         if str(e.device_type).endswith("CUDA")),
        reverse=True,
    )
    host = sorted(
        ((e.self_cpu_time_total, e.key) for e in events if str(e.device_type).endswith("CPU")),
        reverse=True,
    )
    busy = sum(t for t, _, _ in dev_k)
    log(
        f"[profile] build {label}: {wall_us:.1f} us wall, device kernels {busy:.1f} us "
        f"({busy / wall_us:.1%} busy); top kernels: "
        + "; ".join(f"{k[:48]} x{c} {t:.1f}us" for t, c, k in dev_k[:6])
        + " | top host ops (self CPU): " + "; ".join(f"{k[:32]} {t:.1f}us" for t, k in host[:6])
    )


def phase_build(torch, dev, seed: int, kernel_err: float, profile: bool = False) -> None:
    """Build a store on the card from a synthetic corpus at Lifestyle's
    document length (``build_index_to_store``, IndexBuildConfig(nbits=4)
    defaults), check its invariants and determinism, retrieve from it at
    the four configs x both executors, hold WARP to ``plaid_style_search``
    (implicit = explicit decompression), print nRecall@100 and success@5
    of WARP, XTR and PLAID against exact MaxSim, and time one assignment
    chunk at Lifestyle's 2^17 centroids."""
    from repro_torch.core import (
        IndexBuildConfig, Retriever, WarpSearchConfig, kmeans, maxsim_bruteforce,
        plaid_style_search, xtr_reference,
    )
    from repro_torch.data import make_corpus
    from repro_torch.data import make_queries as corpus_queries
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.store import array_chunks, build_index_to_store

    t0 = time.perf_counter()
    corpus = make_corpus(
        BUILD_DOCS, ARCH["dim"], mean_doc_len=BUILD_DOC_LEN, seed=seed, **BUILD_TOPICS
    )
    cfg = IndexBuildConfig(nbits=ARCH["nbits"])
    n, d = corpus.n_tokens, ARCH["dim"]
    c = cfg.resolved_n_centroids(n)
    log(
        f"[build] corpus: {corpus.n_docs} docs, {n} tokens (mean {n / corpus.n_docs:.1f}), "
        f"D {d}, made in {time.perf_counter() - t0:.1f}s; {c} centroids"
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "store")
        times: dict = {}
        with timed_passes(torch, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            index = build_index_to_store(
                array_chunks(corpus.emb, corpus.token_doc_ids, cfg.chunk_size), path,
                corpus.n_docs, cfg, n_tokens=n, dim=d, device=dev,
            )
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        sample_n = int(min(n, max(4 * c, cfg.sample_factor * 4 * n ** 0.5)))
        ops = {"kmeans": cfg.kmeans_iters * 2 * sample_n * c * d, "assign": 2 * n * c * d}
        rows = []
        for name in ("sample", "kmeans", "assign", "buckets", "scatter"):
            row = f"{name} {times[name] * 1e3:.3f} ms"
            if name in ops:
                row += (f" ({ops[name]:.4g} FLOP, fp32 bound {ops[name] / F32_OPS_PER_S * 1e3:.3f} ms, "
                        f"{ops[name] / times[name] / 1e12:.3f} TFLOP/s)")
            if name in ("assign", "scatter"):
                row += f" {n / times[name]:.1f} tokens/s"
            rows.append(row)
        log(
            f"[build] build_index_to_store in {total * 1e3:.3f} ms ({n / total:.1f} tokens/s; "
            f"store writes and the reload {(total - sum(times.values())) * 1e3:.3f} ms): "
            + "; ".join(rows)
        )
        sizes = index.cluster_sizes.float()
        log(
            f"[build] index: {index.n_centroids} clusters, mean {float(sizes.mean()):.1f}, "
            f"max {index.cap}, {int((sizes == 0).sum())} empty; {index.nbytes() / 1e6:.3f} MB"
        )
        check_index_invariants(torch, index, path)
        check_build_determinism(torch, corpus, index, cfg, dev)
        if profile:
            from repro_torch.store import builder

            gen = torch.Generator().manual_seed(cfg.seed)
            pts = kmeans.l2_normalize(
                torch.from_numpy(corpus.emb[builder.sample_indices(n, c, cfg, gen)]).to(dev)
            )
            reseed = torch.randint(0, pts.shape[0], (c,), generator=gen)
            profile_build(torch, "one Lloyd step", lambda: kmeans.lloyd_step(
                pts, index.centroids, reseed))
            normed = builder.normalized_chunks(
                array_chunks(corpus.emb, corpus.token_doc_ids, cfg.chunk_size), dev
            )
            profile_build(torch, "assign pass", lambda: builder.assign_pass(
                normed, index.centroids, np.empty(n, np.int32), n))
            del pts
        retriever = Retriever.from_store(path, device=dev)
    del index

    q, qmask, rel = corpus_queries(
        corpus, n_queries=BUILD_QUERIES, query_maxlen=ARCH["query_maxlen"],
        tokens_per_query=(8, 32), seed=seed + 1,
    )
    base = dict(nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"])
    results, swaps = {}, 0
    reset_launches()
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            plan = retriever.plan(WarpSearchConfig(
                gather=gather, layout=layout, executor=executor, **base
            ))
            before = dict(LAUNCHES)
            out = [plan.retrieve(q[i], qmask[i]) for i in range(BUILD_QUERIES)]
            results[(gather, layout, executor)] = [
                (r.doc_ids.cpu().numpy(), r.scores.cpu().numpy()) for r in out
            ]
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            kname = KERNEL_OF[(gather, layout)]
            if executor == "kernel" and launched[kname] <= 0:
                fail(f"build: {gather}/{layout} on the built index never launched {kname}")
            if executor == "reference" and any(launched.values()):
                fail(f"build: {gather}/{layout}/reference launched a kernel")
            log(f"[build] retrieve {gather}/{layout}/{executor}: {BUILD_QUERIES} queries, "
                f"launches {launched}")
    for gather, layout in CONFIGS:
        for i in range(BUILD_QUERIES):
            swaps += topk_swaps(
                f"build {gather}/{layout} kernel vs reference, query {i}",
                *results[(gather, layout, "kernel")][i],
                *results[(gather, layout, "reference")][i], kernel_err,
            )

    emb = torch.from_numpy(corpus.emb).to(dev)
    tdi = torch.from_numpy(corpus.token_doc_ids).to(dev)
    k_prime = min(n, XTR_K_PRIME)
    scores = {"warp": [], "xtr": [], "plaid": []}
    golds, plaid_swaps = [], 0
    cfg_plaid = WarpSearchConfig(**base)
    for i in range(BUILD_QUERIES):
        gold = maxsim_bruteforce(q[i], qmask[i], emb, tdi, n_docs=corpus.n_docs, k=10, device=dev)
        plaid = plaid_style_search(retriever.index, q[i], qmask[i], cfg_plaid, device=dev)
        p_ids, p_sc = plaid.doc_ids.cpu().numpy(), plaid.scores.cpu().numpy()
        for gather, layout in CONFIGS:
            plaid_swaps += topk_swaps(
                f"build {gather}/{layout} kernel vs plaid_style_search, query {i}",
                *results[(gather, layout, "kernel")][i], p_ids, p_sc, kernel_err,
            )
        xtr = xtr_reference(q[i], qmask[i], emb, tdi, k_prime=k_prime, k=ARCH["k"], device=dev)
        gold_ids = gold.doc_ids.cpu().numpy()
        golds.append(gold_ids)
        for name, ids in (
            ("warp", results[("fused", "ragged", "kernel")][i][0]),
            ("xtr", xtr.doc_ids.cpu().numpy()), ("plaid", p_ids),
        ):
            scores[name].append((n_recall(ids, gold_ids), float(rel[i] in ids[:5].tolist())))
    wide = retriever.plan(WarpSearchConfig(
        nprobe=WIDE_NPROBE, k=ARCH["k"], k_impute=WIDE_NPROBE, gather="fused", layout="ragged",
        executor="kernel",
    ))
    scores["warp_nprobe256"] = []
    for i in range(BUILD_QUERIES):
        ids = wide.retrieve(q[i], qmask[i]).doc_ids.cpu().numpy()
        scores["warp_nprobe256"].append((n_recall(ids, golds[i]), float(rel[i] in ids[:5].tolist())))
    quality = {
        name: {"nRecall@100": float(np.mean([r for r, _ in v])),
               "success@5": float(np.mean([s for _, s in v]))}
        for name, v in scores.items()
    }
    log(
        f"[build] kernel vs reference on the built index: {swaps} places swapped within a tie "
        f"over {BUILD_QUERIES * len(CONFIGS)} (query, config) pairs; WARP (kernel) vs "
        f"plaid_style_search: {plaid_swaps} places swapped, scores within {TOL}"
    )
    log(
        f"[build] quality over {BUILD_QUERIES} queries (8-32 tokens) against exact MaxSim's "
        f"top 10 (nRecall@100) and each query's relevant doc (success@5), nprobe "
        f"{ARCH['nprobe']} (and WARP at {WIDE_NPROBE}), xtr k' {k_prime}: {json.dumps(quality)}"
    )
    del retriever, emb, tdi

    # The document-sharded build of the same corpus (each shard its own
    # k-means and codec): kernel = reference executor, and its recall.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sharded = Retriever.build(
        corpus.emb, corpus.token_doc_ids, corpus.n_docs, cfg, n_shards=SHARDS, device=dev
    )
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    sidx = sharded.index
    sh_results, sh_swaps = {}, 0
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            plan = sharded.plan(WarpSearchConfig(gather=gather, layout=layout, executor=executor, **base))
            before = dict(LAUNCHES)
            out = [plan.retrieve(q[i], qmask[i]) for i in range(BUILD_QUERIES)]
            sh_results[(gather, layout, executor)] = [
                (r.doc_ids.cpu().numpy(), r.scores.cpu().numpy()) for r in out
            ]
            launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            want = SHARDS * BUILD_QUERIES if executor == "kernel" else 0
            if launched[KERNEL_OF[(gather, layout)]] != want or sum(launched.values()) != want:
                fail(f"build: sharded {gather}/{layout}/{executor} launches {launched}, expected {want}")
    for gather, layout in CONFIGS:
        for i in range(BUILD_QUERIES):
            sh_swaps += topk_swaps(
                f"build sharded {gather}/{layout} kernel vs reference, query {i}",
                *sh_results[(gather, layout, "kernel")][i],
                *sh_results[(gather, layout, "reference")][i], kernel_err,
            )
    sh_quality = {
        "nRecall@100": float(np.mean([
            n_recall(sh_results[("fused", "ragged", "kernel")][i][0], golds[i])
            for i in range(BUILD_QUERIES)
        ])),
        "success@5": float(np.mean([
            float(rel[i] in sh_results[("fused", "ragged", "kernel")][i][0][:5].tolist())
            for i in range(BUILD_QUERIES)
        ])),
    }
    log(
        f"[build] Retriever.build(n_shards={SHARDS}) in {t_build * 1e3:.3f} ms: doc_start "
        f"{sidx.doc_start.tolist()}, {sidx.n_centroids} centroids per shard, tokens "
        f"{sidx.cluster_sizes.sum(dim=1).tolist()}; kernel vs reference at 4 configs: {sh_swaps} "
        f"places swapped within a tie; one launch per shard per retrieve; quality "
        f"{json.dumps(sh_quality)} beside the single build's {json.dumps(quality['warp'])} "
        f"(no limit set); {card()}"
    )
    del sharded, sidx, sh_results

    g = torch.Generator(device=dev).manual_seed(seed)
    lc = _LIFESTYLE.n_centroids
    cent = kmeans.l2_normalize(torch.randn(lc, d, generator=g, device=dev))
    pts = kmeans.l2_normalize(torch.randn(LIFESTYLE_CHUNK, d, generator=g, device=dev))
    times = []
    for _ in range(6):
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        kmeans.assign_clusters(pts, cent)
        e_ev.record()
        e_ev.synchronize()
        times.append(s_ev.elapsed_time(e_ev) / 1e3)
    t = float(np.median(times[1:]))
    flop = 2 * LIFESTYLE_CHUNK * lc * d
    ls_n = _LIFESTYLE.n_tokens
    ls_sample = int(min(ls_n, max(4 * lc, cfg.sample_factor * 4 * ls_n ** 0.5)))
    rate = flop / t
    log(
        f"[build] Lifestyle cost: assign_clusters of {LIFESTYLE_CHUNK} tokens x {lc} centroids "
        f"(block {kmeans.assign_block(lc)}) {t * 1e3:.3f} ms median of 5, {flop:.4g} FLOP, "
        f"{rate / 1e12:.3f} TFLOP/s (fp32 bound {flop / F32_OPS_PER_S * 1e3:.3f} ms); at that rate "
        f"the {ls_n}-token assignment takes {2 * ls_n * lc * d / rate:.1f} s and k-means "
        f"({cfg.kmeans_iters} x {ls_sample} sampled tokens) "
        f"{cfg.kmeans_iters * 2 * ls_sample * lc * d / rate:.1f} s"
    )


def bf16_ulp(torch, x):
    """One bf16 ulp at each |x| (x float32): 2^(e - 8) for |x| = m * 2^e,
    m in [0.5, 1); 0 at 0."""
    _, e = torch.frexp(x)
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8), torch.zeros_like(x))


def bf16_excess(torch, got, want):
    """(max |got - want|, max over elements of |got - want| less one bf16
    ulp of the larger of |got|, |want|): the bf16 rule is excess <=
    ``FLASH_BF16_ATOL``."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ulp = bf16_ulp(torch, torch.maximum(got.abs(), want.abs()))
    return float(diff.max()), float((diff - ulp).max())


def attention_p_bf16(torch, q, k, v, window=None):
    """Causal (optionally windowed) attention over [B, S, H(kv), Dh] with
    float32 scores and sums but the probabilities rounded to bf16 before
    the product with v: what the flash kernel would compute if it dropped
    its p_lo term. One (batch row, kv head) at a time, so the [rep, S, S]
    scores fit at S 8192."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    pos = torch.arange(sq, device=q.device)
    rel = pos.unsqueeze(1) - pos
    hidden = rel < 0
    if window is not None:
        hidden |= rel >= window
    out = torch.empty_like(q)
    for bi in range(b):
        for g in range(hkv):
            qg = q[bi, :, g * rep:(g + 1) * rep].float().transpose(0, 1)  # [rep, S, Dh]
            s = (qg @ k[bi, :, g].float().T / dh ** 0.5).masked_fill(hidden, -1e30)
            p = torch.exp(s - s.amax(-1, keepdim=True))
            o = (p.to(torch.bfloat16).float() @ v[bi, :, g].float()) / p.sum(-1, keepdim=True)
            out[bi, :, g * rep:(g + 1) * rep] = o.transpose(0, 1).to(q.dtype)
            del s, p
    return out


def flash_ops(b, h, s, dh, window=None) -> float:
    """Multiply-adds x 2 of q.k and p.v over the (query, key) pairs the
    causal mask (and window) keeps: row i sees min(i + 1, window) keys."""
    w = s if window is None else min(window, s)
    pairs = w * (w + 1) // 2 + (s - w) * w
    return 4.0 * b * h * pairs * dh


def phase_flash(torch, dev, flush):
    """The flash kernel against its plain version at every ``FLASH_CASES``
    shape in float32 and bf16 (through ``ops.flash_attention``, which pads
    S to the tile), element by element; then the bf16 rule is shown to
    reject two planted faults (one kv tile's values zeroed; p rounded to
    bf16) at each ``FLASH_TIMED`` shape, and the kernel is timed there
    beside ``scaled_dot_product_attention`` (at qwen2's and qwen3's shapes
    also in the model's transposed layout; at mixtral's window, SDPA gets
    the window as a dense mask over repeated kv heads) and its operations
    bound, and at the prefill's shape beside the plain version. Returns the
    kernels row (qwen2's shape) with the zoo's shapes under ``zoo``."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    errs, excess, rejected = {}, {}, {}
    for name, b, h, hkv, s, dh, causal, window in FLASH_CASES:
        for dtype in ("float32", "bfloat16"):
            q, k, v = (
                torch.randn(b, s, n, dh, generator=g, device=dev).to(getattr(torch, dtype))
                for n in (h, hkv, hkv)
            )
            kw = dict(causal=causal, window=window)
            got = ops.flash_attention(q, k, v, **kw)
            want = ops.flash_attention(q, k, v, **kw, use_kernel=False)
            torch.cuda.synchronize()
            if got.dtype != q.dtype or got.shape != q.shape:
                fail(f"flash {name}/{dtype}: output {got.dtype} {tuple(got.shape)}")
            key = f"{name}/{dtype}"
            if dtype == "float32":
                errs[key] = float((got - want).abs().max())
                if not errs[key] <= FLASH_F32_TOL:
                    fail(f"flash {key}: max abs err {errs[key]} vs its plain version > {FLASH_F32_TOL}")
                continue
            errs[key], excess[key] = bf16_excess(torch, got, want)
            if name in FLASH_TIMED:
                # The bf16 rule must reject planted faults at this shape: the
                # last kv tile's values lost, and p rounded to bf16 before p.v.
                v_bad = v.clone()
                v_bad[:, -64:] = 0
                faults = {
                    "last kv tile zeroed": ops.flash_attention(q, k, v_bad, **kw, use_kernel=False),
                    "p rounded to bf16": attention_p_bf16(torch, q, k, v, window),
                }
                for what, bad in faults.items():
                    bad_err, bad_excess = bf16_excess(torch, bad, want)
                    if not bad_excess > FLASH_BF16_ATOL:
                        fail(f"flash: the bf16 rule does not reject a planted fault ({what}) at {name}")
                    rejected[f"{name}: {what}"] = [bad_err, bad_excess]
                del v_bad, faults
            if name == "qwen2":
                log(f"[flash] qwen2/bfloat16 outputs: median |out| "
                    f"{float(want.float().abs().median())}, max {float(want.float().abs().max())}")
            del q, k, v, got, want
    log(f"[flash] max abs err vs the plain version: {json.dumps(errs)}; bf16, the most an element "
        f"differs beyond one ulp of the larger output: {json.dumps(excess)}")
    for key, x in excess.items():
        if not x <= FLASH_BF16_ATOL:
            fail(f"flash {key}: an element differs from its plain version by {x} more than "
                 f"one bf16 ulp of the larger output (> {FLASH_BF16_ATOL})")
    log(f"[flash] planted faults, max abs err and excess beyond one ulp (all rejected): "
        f"{json.dumps(rejected)}")

    # Timed beside SDPA at each FLASH_TIMED shape, bf16: in the contiguous
    # [B, H, S, Dh] layout, and at qwen2's and qwen3's shapes also in the
    # model's own (the transposed views of [B, S, H, Dh] that
    # ops.flash_attention passes).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed, zoo = {}, {}
    for name, b, h, hkv, s, dh, _, window in FLASH_CASES:
        if name not in FLASH_TIMED:
            continue
        ops_ = flash_ops(b, h, s, dh, window)
        for layout in ("contiguous", "model") if name in ("qwen2", "qwen3") else ("contiguous",):
            if layout == "contiguous":
                q, k, v = (
                    torch.randn(b, n, s, dh, generator=g, device=dev).to(torch.bfloat16)
                    for n in (h, hkv, hkv)
                )
            else:
                q, k, v = (
                    torch.randn(b, s, n, dh, generator=g, device=dev).to(torch.bfloat16).transpose(1, 2)
                    for n in (h, hkv, hkv)
                )
            if window is None:
                def library(q=q, k=k, v=v):
                    return sdpa(q, k, v, is_causal=True, enable_gqa=True)
            else:
                pos = torch.arange(s, device=dev)
                rel = pos.unsqueeze(1) - pos
                mask = (rel >= 0) & (rel < window)
                kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))

                def library(q=q, kr=kr, vr=vr, mask=mask):
                    return sdpa(q, kr, vr, attn_mask=mask)
            t = {
                "ms": time_cuda(torch, lambda: flash_attention_cuda(q, k, v, causal=True, window=window), flush),
                "sdpa_ms": time_cuda(torch, library, flush),
                "bound_ms": ops_ / BF16_OPS_PER_S * 1e3,
            }
            t["ratio_to_sdpa"] = t["ms"] / t["sdpa_ms"]
            t["share_of_bound"] = t["bound_ms"] / t["ms"]
            timed[f"{name}/{layout}"] = t
            if name == "qwen2" and layout == "contiguous":
                main = (q, k, v, t)
            elif layout == "contiguous":
                nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
                zoo[name] = {
                    "shape": [b, h, hkv, s, dh], "window": window, "ms": t["ms"],
                    "library_ms": t["sdpa_ms"],
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops_ / BF16_OPS_PER_S) * 1e3,
                    "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops_ / BF16_OPS_PER_S else "operations",
                    "max_abs_err": errs[f"{name}/bfloat16"], "launches": 0,
                }
            del q, k, v
    log(f"[flash] bf16, kernel beside SDPA (ms, ratio, share of the operations bound): "
        f"{json.dumps(timed)}")

    q, k, v, t = main
    b, h, s, dh = q.shape
    plain_ms = time_cuda(torch, lambda: ref.flash_attention(q, k, v, causal=True), flush, iters=5)
    ms, library_ms = t["ms"], t["sdpa_ms"]
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())  # q, k, v read; out written
    ops_ = flash_ops(b, h, s, dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / BF16_OPS_PER_S
    row = {
        "name": "flash_attention",
        "route": "cuda",
        "source": KERNEL_INFO["flash_attention"][0],
        "replaces": KERNEL_INFO["flash_attention"][1],
        "launches": 0,
        "max_abs_err": errs["qwen2/bfloat16"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "bytes": int(nbytes),
        "zoo": zoo,
    }
    log(
        f"[flash] timed at B={b} H={h} Hkv={k.shape[1]} S={s} Dh={dh} bf16 causal: "
        f"{json.dumps(row)}"
    )
    return row


def routing_flips(top_a, top_b, probs_ref, k: int):
    """Rows whose expert sets differ between two routings (top-k expert
    ids [T, k]) and, for each, the reference's gap between its k-th and
    (k+1)-th router probabilities."""
    rows = (top_a.sort(-1).values != top_b.sort(-1).values).any(-1).nonzero().flatten()
    p = probs_ref[rows].sort(-1, descending=True).values
    return rows, (p[:, k - 1] - p[:, k]) if p.shape[1] > k else p[:, k - 1]


def capture_routes(torch, sink):
    """A stand-in for ``moe.route`` that appends each call's (top_e, probs)
    to ``sink`` (read by the zoo's checks, not by the model)."""
    from repro_torch.models import moe

    route = moe.route

    def wrapped(x, w, cfg):
        probs, top_p, top_e = route(x, w, cfg)
        sink.append((top_e, probs))
        return probs, top_p, top_e

    return wrapped


def lm_parity(torch, models, prompt, want, cfg) -> dict:
    """Both executors fed the same tokens: the prompt, then the reference
    executor's greedy tokens ``want`` [B, N] (teacher forcing). With MoE
    layers the kernel executor is also fed the reference's routing: each
    router call takes the reference's expert set for that call and weighs
    it with the kernel run's own probabilities, so the comparison measures
    the kernel's numerics, not a flipped choice; the expert sets the kernel
    run would have chosen are recorded (``would_flip``). Returns the
    measurements the lm checks read: for each layer, the flash kernel on
    the reference prefill's own attention inputs against the reference's
    output there (the most an element differs beyond one bf16 ulp); the
    prefill KV cache of the two executors per layer (max abs diff, and the
    norm of the difference relative to the reference's); the max abs
    logits diff at every step (0: the prefill); and the reference's logits'
    argmax and top-2 at every step."""
    from unittest import mock

    from repro_torch.kernels import ops
    from repro_torch.models import KVCache, moe

    b, s = prompt.shape
    n_new = want.shape[1]
    flash, route, captured = ops.flash_attention, moe.route, []
    ref_routes, own_routes = [], []
    ref_route = capture_routes(torch, ref_routes)

    def capture(q, k, v, **kw):
        out = flash(q, k, v, **kw)
        captured.append((q, k, v, kw, out))
        return out

    def forced_route(x, w, c):
        probs, _, top_e = route(x, w, c)
        forced = ref_routes[len(own_routes)][0]
        own_routes.append((top_e, probs))
        p = torch.gather(probs, 1, forced)
        return probs, p / p.sum(-1, keepdim=True), forced

    def run(ex, fn, first=False):
        attn = capture if ex == "reference" and first else flash
        with mock.patch.object(ops, "flash_attention", attn), \
                mock.patch.object(moe, "route", ref_route if ex == "reference" else forced_route):
            return fn()

    logits, caches = {}, {}
    for ex in ("reference", "kernel"):
        cache = KVCache.empty(cfg, b, s + n_new, device=prompt.device)
        logits[ex], caches[ex] = run(ex, lambda: models[ex].prefill(prompt, cache), first=True)
    if len(captured) != cfg.n_layers:
        fail(f"lm: the reference prefill ran attention {len(captured)} times, not once per layer")
    layer_excess = []
    for q, k, v, kw, out in captured:
        got = flash(q, k, v, **{**kw, "use_kernel": True})
        layer_excess.append(bf16_excess(torch, got, out)[1])
    del captured
    kv = []
    for layer in range(cfg.n_layers):
        row = {}
        for name in ("k", "v"):
            got = getattr(caches["kernel"], name)[layer, :, :s].float()
            ref = getattr(caches["reference"], name)[layer, :, :s].float()
            diff = got - ref
            row[name] = (float(diff.abs().max()), float(diff.norm() / ref.norm()))
        kv.append(row)
    steps, argmax, top2, lmax = [], [], [], 0.0
    for t in range(n_new):
        if t:
            for ex in ("reference", "kernel"):
                logits[ex], caches[ex] = run(
                    ex, lambda: models[ex].decode_step(want[:, t - 1].long(), caches[ex]))
        lk, lr = logits["kernel"].float(), logits["reference"].float()
        if not bool(torch.isfinite(lk).all()) or tuple(lk.shape) != (b, cfg.vocab):
            fail(f"lm: step {t} logits are not finite values of shape [B, vocab]")
        steps.append(float((lk - lr).abs().max()))
        lmax = max(lmax, float(lr.abs().max()))
        argmax.append(lr.argmax(-1))
        top2.append(torch.topk(lr, 2).values)
    would_flip = []  # per router call (layer, step): the gaps of the rows that would flip
    for i, ((ref_e, ref_p), (own_e, _)) in enumerate(zip(ref_routes, own_routes)):
        _, gaps = routing_flips(own_e, ref_e, ref_p, cfg.moe.top_k)
        would_flip.append((i % cfg.n_layers, i // cfg.n_layers, gaps.tolist()))
    return {
        "layer_excess": layer_excess, "kv": kv, "logits": steps,
        "argmax": torch.stack(argmax, 1), "top2": torch.stack(top2, 1),
        "logit_max": lmax, "would_flip": would_flip,
    }


def lm_rates(torch, model, prompt, runs: int = 3) -> dict:
    """p50 over ``runs`` of prefill tokens/s (the whole prompt) and greedy
    decode tokens/s (``LM_NEW - 1`` steps of the batch)."""
    from repro_torch.models import KVCache

    pre, dec = [], []
    b, s = prompt.shape
    for _ in range(runs):
        cache = KVCache.empty(model.cfg, b, s + LM_NEW, device=prompt.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompt, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(LM_NEW - 1):
            logits, cache = model.decode_step(logits.argmax(-1), cache)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pre.append(b * s / (t1 - t0))
        dec.append(b * (LM_NEW - 1) / (t2 - t1))
    return {"prefill_tokens_per_s_p50": float(np.median(pre)),
            "decode_tokens_per_s_p50": float(np.median(dec))}


def prefill_attention_share(torch, model, prompt) -> dict:
    """One prefill under ``torch.profiler`` with every ``ops.flash_attention``
    call inside a ``record_function`` range: the summed time of the device
    kernels, and the device time of attention with its share of it (the
    ranges slow the host, so no wall time or busy share is read here:
    ``--profile`` gives those). Attention's time is the kernels the
    profiler ties to the range (the plain version's at executor
    "reference"; the padding copies at "kernel") plus the flash kernel,
    taken by name: it launches through its library's own CUDA runtime,
    which the profiler does not tie to the range."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops
    from repro_torch.models import KVCache

    flash, span = ops.flash_attention, "prefill_attention"

    def ranged(*a, **kw):
        with record_function(span):
            return flash(*a, **kw)

    b, s = prompt.shape
    cache = KVCache.empty(model.cfg, b, s + LM_NEW, device=prompt.device)
    with mock.patch.object(ops, "flash_attention", ranged):
        model.prefill(prompt, cache)  # warm; the returned cache is dropped
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.prefill(prompt, cache)
            torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(getattr(e, "self_device_time_total", 0) for e in events
                 if str(e.device_type).endswith("CUDA") and e.key != span)
    ranged_us = sum(e.device_time_total for e in events
                    if e.key == span and not str(e.device_type).endswith("CUDA"))
    kernel_us = sum(getattr(e, "self_device_time_total", 0) for e in events
                    if str(e.device_type).endswith("CUDA") and "flash_fwd" in e.key)
    attn = ranged_us + kernel_us
    return {"device_us": device, "flash_kernel_us": kernel_us, "attention_device_us": attn,
            "attention_share": attn / device if device else None}


def check_lm(par: dict, got, want, what, explained=None) -> None:
    """Raises unless the measurements of ``lm_parity`` hold: the flash
    kernel within the bf16 rule at every layer's own inputs, layer 0's
    cache identical (no attention has run before it), every later layer's
    within ``LM_KV_TOL``, logits within ``LM_LOGITS_TOL`` at every step,
    the reference's teacher-forced argmax its own greedy tokens, every
    routing the kernel run would have chosen apart from the reference's
    only at a gap within ``MOE_FLIP_GAP``, and every row where the kernel's
    tokens ``got`` part from ``want`` first doing so at a near-tie of the
    reference's top-2 logits, or (MoE) where ``explained[row]`` names the
    free run's routing flips before that step (each reported)."""
    for layer, x in enumerate(par["layer_excess"]):
        if not x <= FLASH_BF16_ATOL:
            fail(f"lm {what}: at layer {layer}'s own inputs the flash kernel differs from the "
                 f"reference by {x} more than one bf16 ulp (> {FLASH_BF16_ATOL})")
    for layer, row in enumerate(par["kv"]):
        for name, (err, rel) in row.items():
            if layer == 0 and err != 0:
                fail(f"lm {what}: layer 0 {name} cache differs ({err}) before any attention ran")
            if not rel <= LM_KV_TOL:
                fail(f"lm {what}: layer {layer} {name} cache, kernel vs reference, relative "
                     f"norm of the difference {rel} > {LM_KV_TOL}")
    worst = max(par["logits"])
    if not worst <= LM_LOGITS_TOL:
        step = par["logits"].index(worst)
        fail(f"lm {what}: teacher-forced logits at step {step} differ by {worst} > {LM_LOGITS_TOL}")
    if not bool((par["argmax"] == want).all()):
        fail(f"lm {what}: the reference's teacher-forced argmax is not its own greedy output")
    for layer, step, gaps in par["would_flip"]:
        if gaps and not max(gaps) <= MOE_FLIP_GAP:
            fail(f"lm {what}: at layer {layer} step {step} the kernel run's router would pick "
                 f"other experts than the reference's where they are {max(gaps)} apart "
                 f"(> {MOE_FLIP_GAP})")
    for row in range(want.shape[0]):
        diff = (got[row] != want[row]).nonzero().flatten()
        if diff.numel() == 0:
            continue
        step = int(diff[0])
        top2 = par["top2"][row, step].tolist()
        gap = top2[0] - top2[1]
        why = (explained or {}).get(row, {}).get(step)
        if not gap <= LM_LOGITS_TOL and not why:
            fail(f"lm {what}: row {row} first differs at step {step}, where the reference's "
                 f"top-2 logits {top2} are {gap} apart > {LM_LOGITS_TOL}")
        log(f"[ties] lm {what} row {row}: tokens first differ at step {step}, reference "
            f"top-2 logits {top2} (gap {gap})" + (f"; after {why}" if why else ""))


def phase_lm(torch, dev, seeds, profile: bool) -> int:
    """qwen2-0.5b generation at full width and depth, kernel executor vs
    reference executor, for weights and prompt drawn from each of
    ``seeds``. The first seed is the main path: its kernel ``generate``'s
    flash launches are returned, and its tokens/s (and, with ``profile``,
    its breakdown) are measured."""
    from repro_torch.configs.qwen2_0_5b import CONFIG
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.serving import generate

    for seed in seeds:
        first = seed == seeds[0]
        t0 = time.perf_counter()
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = init_params(CONFIG, g, device=dev, dtype=torch.bfloat16)
        models = {ex: TransformerLM.from_params(CONFIG, params, executor=ex) for ex in ("kernel", "reference")}
        prompt = torch.randint(0, CONFIG.vocab, (LM_BATCH, LM_PROMPT), generator=g, device=dev)
        torch.cuda.synchronize()
        if first:
            log(
                f"[lm] qwen2-0.5b: {CONFIG.n_layers} layers, d {CONFIG.d_model}, {CONFIG.n_heads} "
                f"heads ({CONFIG.n_kv_heads} kv, head_dim {CONFIG.resolved_head_dim}), vocab "
                f"{CONFIG.vocab}; {sum(p.numel() for p in params.values())} bf16 parameters made "
                f"in {time.perf_counter() - t0:.1f}s; prompt {LM_BATCH} x {LM_PROMPT}, {LM_NEW} "
                f"new tokens, greedy, bf16 cache; weight seeds {list(seeds)}"
            )

        tokens, launches = {}, {}
        for ex, model in models.items():
            reset_launches()
            tokens[ex] = generate(model, prompt, max_new_tokens=LM_NEW)
            torch.cuda.synchronize()
            launches[ex] = dict(LAUNCHES)  # read right after the path's run
        if launches["kernel"]["flash_attention"] != CONFIG.n_layers:
            fail(f"lm: {launches['kernel']['flash_attention']} flash launches per kernel generate, "
                 f"expected one per layer ({CONFIG.n_layers})")
        if any(launches["reference"].values()):
            fail(f"lm: the reference executor launched a kernel: {launches['reference']}")
        if first:
            main = launches["kernel"]["flash_attention"]
        got, want = tokens["kernel"], tokens["reference"]
        if tuple(got.shape) != (LM_BATCH, LM_NEW) or int(got.min()) < 0 or int(got.max()) >= CONFIG.vocab:
            fail(f"lm: generated tokens of shape {tuple(got.shape)} outside the vocabulary")

        par = lm_parity(torch, models, prompt, want, CONFIG)
        kv_rel = [max(r["k"][1], r["v"][1]) for r in par["kv"]]
        log(
            f"[lm] seed {seed}: flash kernel at each layer's own inputs, the most an element "
            f"differs from the reference beyond one bf16 ulp: {max(par['layer_excess'])} (limit "
            f"{FLASH_BF16_ATOL}); prefill cache kernel vs reference, relative norm of the "
            f"difference per layer (larger of k, v) {json.dumps(kv_rel)} (limit {LM_KV_TOL}), max "
            f"abs {max(r[n][0] for r in par['kv'] for n in r)}; teacher-forced logits max abs diff "
            f"per step (0 = prefill) {json.dumps(par['logits'])} (limit {LM_LOGITS_TOL}, logits up "
            f"to {par['logit_max']}); tokens identical in {int((got == want).all(dim=1).sum())} "
            f"of {LM_BATCH} rows"
        )
        check_lm(par, got, want, f"seed {seed}")
        if first:
            for ex, model in models.items():
                log(f"[lm] {ex} executor: {json.dumps(lm_rates(torch, model, prompt))}; profiled "
                    f"prefill: {json.dumps(prefill_attention_share(torch, model, prompt))}")
            if profile:
                profile_lm(torch, models["kernel"], prompt)
        del params, models, par
    log(f"[lm] flash launches per kernel generate {main}, per reference generate 0")
    return main


def moe_report(torch, cfg, routes: dict, b: int, s: int, got, want) -> tuple[dict, dict]:
    """The zoo's free-run routing (``routes[executor]``: one (top_e, probs)
    per router call of ``generate``): the pairs dropped at prefill and at
    decode (the reference's), the kernel run's expert sets apart from the
    reference's at prefill per layer with the reference's gaps (over each
    token's first such layer), and for every row whose tokens part, the
    flips in that row before the step where they do. Returns (report,
    explained rows for ``check_lm``)."""
    n_layers, k = cfg.n_layers, cfg.moe.top_k

    def drops(top_e):
        counts = torch.bincount(top_e.flatten(), minlength=cfg.moe.n_experts)
        return int((counts - cfg.moe.capacity(top_e.shape[0])).clamp(min=0).sum())

    ref, ker = routes["reference"], routes["kernel"]
    rep = {
        "prefill_pairs": b * s * k, "prefill_dropped_per_layer": [drops(e) for e, _ in ref[:n_layers]],
        "decode_pairs": b * k * (len(ref) - n_layers),  # over every decode call of every layer
        "decode_dropped": sum(drops(e) for e, _ in ref[n_layers:]),
    }
    first = torch.full((b * s,), -1, dtype=torch.long, device=got.device)
    flips, first_gaps = [], []
    for layer in range(n_layers):
        rows, gaps = routing_flips(ker[layer][0], ref[layer][0], ref[layer][1], k)
        flips.append(int(rows.numel()))
        new = rows[first[rows] < 0]
        first[new] = layer
        first_gaps += gaps[first[rows] == layer].tolist()
    rep["prefill_flips_per_layer"] = flips
    rep["prefill_tokens_flipped"] = int((first >= 0).sum())
    rep["first_flip_max_gap"] = max(first_gaps) if first_gaps else None
    explained = {}
    for row in range(b):
        diff = (got[row] != want[row]).nonzero().flatten()
        if diff.numel() == 0:
            continue
        step = int(diff[0])
        n_pre = int((first[row * s:(row + 1) * s] >= 0).sum())
        n_dec = 0
        for i in range(n_layers, min(len(ref), len(ker), n_layers * (step + 1))):
            n_dec += int(routing_flips(ker[i][0][row:row + 1], ref[i][0][row:row + 1],
                                       ref[i][1][row:row + 1], k)[0].numel())
        if n_pre or n_dec:
            explained[row] = {step: f"{n_pre} of its prompt tokens and {n_dec} decode steps' "
                                    f"(token, layer) routings flipped before it"}
    return rep, explained


def phase_zoo(torch, dev, seed: int, profile: bool) -> dict:
    """The registry's other LMs (``ZOO``) through ``generate`` at both
    executors, one arch at a time, each checked as the qwen2 step is
    (``lm_parity`` / ``check_lm``, with MoE routing teacher-forced in the
    parity run), plus for MoE: two identical prefills bit for bit, the
    dropped (token, slot) pairs at prefill and decode, and the free run's
    routing flips. Returns {arch: flash launches per kernel generate}."""
    from unittest import mock

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import KVCache, TransformerLM, init_params, moe
    from repro_torch.serving import generate

    out = {}
    for i, (arch, layers, b, s) in enumerate(ZOO):
        t0 = time.perf_counter()
        cfg = get_arch(arch).config
        full = cfg
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        params = init_params(cfg, g, device=dev, dtype=torch.bfloat16)
        models = {ex: TransformerLM.from_params(cfg, params, executor=ex) for ex in ("kernel", "reference")}
        prompt = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
        torch.cuda.synchronize()
        n = sum(p.numel() for p in params.values())
        log(f"[zoo] {arch}: {cfg.n_layers} of {full.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv, head_dim {cfg.resolved_head_dim}), d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, window {cfg.sliding_window}, moe "
            f"{dataclasses.asdict(cfg.moe) if cfg.moe else None}; {n} bf16 parameters "
            f"({2 * n / 1e9:.2f} GB; the full model {full.param_count()}) made in "
            f"{time.perf_counter() - t0:.1f}s; prompt {b} x {s}, {LM_NEW} greedy tokens, bf16 cache")

        tokens, launches, routes = {}, {}, {}
        for ex, model in models.items():
            routes[ex] = []
            reset_launches()
            with mock.patch.object(moe, "route", capture_routes(torch, routes[ex])):
                tokens[ex] = generate(model, prompt, max_new_tokens=LM_NEW)
            torch.cuda.synchronize()
            launches[ex] = dict(LAUNCHES)  # read right after the path's run
        if launches["kernel"]["flash_attention"] != cfg.n_layers:
            fail(f"zoo {arch}: {launches['kernel']['flash_attention']} flash launches per kernel "
                 f"generate, expected one per layer ({cfg.n_layers})")
        if any(launches["reference"].values()):
            fail(f"zoo {arch}: the reference executor launched a kernel: {launches['reference']}")
        out[arch] = launches["kernel"]["flash_attention"]
        got, want = tokens["kernel"], tokens["reference"]
        if tuple(got.shape) != (b, LM_NEW) or int(got.min()) < 0 or int(got.max()) >= cfg.vocab:
            fail(f"zoo {arch}: generated tokens of shape {tuple(got.shape)} outside the vocabulary")

        explained = None
        if cfg.moe is not None:
            again = []
            for _ in range(2):
                cache = KVCache.empty(cfg, b, s + 1, device=dev)
                again.append(models["kernel"].prefill(prompt, cache)[0])
            if not torch.equal(again[0], again[1]):
                fail(f"zoo {arch}: two identical prefills gave logits "
                     f"{float((again[0] - again[1]).abs().max())} apart")
            rep, explained = moe_report(torch, cfg, routes, b, s, got, want)
            log(f"[zoo] {arch} routing (free run): two identical prefills bit for bit; "
                f"{json.dumps(rep)}")
            del again
        del routes

        par = lm_parity(torch, models, prompt, want, cfg)
        kv_rel = [max(r["k"][1], r["v"][1]) for r in par["kv"]]
        flips = {}
        for layer, step, gaps in par["would_flip"]:
            key = "prefill" if step == 0 else "decode"
            f = flips.setdefault(f"layer {layer} {key}", [0, 0.0])
            f[0] += len(gaps)
            f[1] = max([f[1], *gaps])
        log(
            f"[zoo] {arch}: flash kernel at each layer's own inputs, the most an element differs "
            f"from the reference beyond one bf16 ulp: {max(par['layer_excess'])} (limit "
            f"{FLASH_BF16_ATOL}); prefill cache kernel vs reference, relative norm of the "
            f"difference per layer {json.dumps(kv_rel)} (limit {LM_KV_TOL}); teacher-forced "
            f"logits max abs diff per step {json.dumps(par['logits'])} (limit {LM_LOGITS_TOL}, "
            f"logits up to {par['logit_max']}); tokens identical in "
            f"{int((got == want).all(dim=1).sum())} of {b} rows"
            + (f"; routing teacher-forced, the kernel run's own choice apart from the reference's "
               f"(count, largest gap; limit {MOE_FLIP_GAP}): {json.dumps(flips)}" if cfg.moe else "")
        )
        check_lm(par, got, want, arch, explained)
        del par
        for ex, model in models.items():
            log(f"[zoo] {arch} {ex} executor: {json.dumps(lm_rates(torch, model, prompt))}; profiled "
                f"prefill: {json.dumps(prefill_attention_share(torch, model, prompt))}; {card()}")
        if profile:
            profile_lm(torch, models["kernel"], prompt)
        del params, models, prompt, got, want, tokens
        torch.cuda.empty_cache()
        log(f"[zoo] {arch} done in {time.perf_counter() - t0:.1f}s")
    log(f"[zoo] flash launches per kernel generate {json.dumps(out)}, per reference generate 0")
    return out


def profile_lm(torch, model, prompt, steps: int = 4):
    """One kernel-executor prefill, then ``steps`` decode steps, each under
    ``torch.profiler``: wall time, summed device kernel time and busy
    share, the flash kernel's time and launches, the top device kernels
    and (decode) the top host ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import KVCache

    def traced(fn):
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        dev_k = sorted(
            ((getattr(e, "self_device_time_total", 0), e.count, e.key) for e in events
             if str(e.device_type).endswith("CUDA")),
            reverse=True,
        )
        host = sorted(
            ((e.self_cpu_time_total, e.key) for e in events if str(e.device_type).endswith("CPU")),
            reverse=True,
        )
        busy = sum(t for t, _, _ in dev_k)
        flash = [(t, c) for t, c, k in dev_k if "flash_fwd" in k]
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        return (
            f"{wall_us:.1f} us wall, device kernels {busy:.1f} us ({busy / wall_us:.1%} busy), "
            f"{launches} kernel launches; flash kernel {sum(t for t, _ in flash):.1f} us in "
            f"{sum(c for _, c in flash)} launches; top kernels: "
            + "; ".join(f"{k[:48]} x{c} {t:.1f}us" for t, c, k in dev_k[:5])
            + " | top host ops (self CPU): "
            + "; ".join(f"{k[:32]} {t:.1f}us" for t, k in host[:5])
        )

    b, s = prompt.shape
    cache = KVCache.empty(model.cfg, b, s + LM_NEW, device=prompt.device)
    prefill = traced(lambda: model.prefill(prompt, cache))  # the returned cache is dropped
    log(f"[profile] lm prefill of {b} x {s} (kernel executor): {prefill}")
    logits, filled = model.prefill(prompt, cache)
    nxt = logits.argmax(-1)

    def decode():
        c = filled
        for _ in range(steps):
            _, c = model.decode_step(nxt, c)

    log(f"[profile] lm decode, {steps} steps of batch {b} from position {s}: {traced(decode)}")


# ---------------------------------------------------------------------------
# recsys: the embedding-bag kernel and the four recsys models
# ---------------------------------------------------------------------------


def recsys_batch(torch, cfg, shape, g, dev) -> dict:
    """The batch ``RecsysFamily.input_specs`` names for ``cfg`` at
    ``shape``, on the card: ids uniform over the vocabulary (as hashed ids
    are), masks with 1..width valid slots (a prefix; SASRec's a suffix, so
    its last position is real)."""
    from repro_torch.models import DINConfig, SASRecConfig, TwoTowerConfig

    b, nc, retrieval = shape.batch, shape.n_candidates, shape.kind == "retrieval"

    def ids(vocab, *dims):
        return torch.randint(0, vocab, dims, generator=g, device=dev)

    def mask(rows, width, suffix=False):
        n = torch.randint(1, width + 1, (rows, 1), generator=g, device=dev)
        pos = torch.arange(width, device=dev)
        return (pos >= width - n if suffix else pos < n).float()

    if isinstance(cfg, TwoTowerConfig):
        out = {"user_ids": ids(cfg.user_vocab, b, cfg.user_fields),
               "user_mask": mask(b, cfg.user_fields)}
        if not retrieval:
            out["item_ids"] = ids(cfg.item_vocab, b, cfg.item_fields)
            out["item_mask"] = mask(b, cfg.item_fields)
        return out
    if isinstance(cfg, SASRecConfig):
        out = {"seq_ids": ids(cfg.item_vocab, b, cfg.seq_len),
               "seq_mask": mask(b, cfg.seq_len, suffix=True)}
        out["cand_ids" if retrieval else "target_ids"] = ids(cfg.item_vocab, nc if retrieval else b)
        return out
    if isinstance(cfg, DINConfig):
        rows = 1 if retrieval else b
        return {"target_ids": ids(cfg.item_vocab, nc if retrieval else b),
                "hist_ids": ids(cfg.item_vocab, rows, cfg.seq_len),
                "hist_mask": mask(rows, cfg.seq_len)}
    return {"field_ids": ids(cfg.vocab, nc if retrieval else b, cfg.n_fields)}


def bag_check(torch, what, table, idx, w) -> dict:
    """The embedding-bag kernel against its plain version on the same
    inputs, element by element within ``ref.embedding_bag_error_bound``;
    returns max abs err and the largest share of its limit an element
    used."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    got = embedding_bag_cuda(table, idx, w)
    want = ref.embedding_bag_bags(table, idx, w)
    limit = ref.embedding_bag_error_bound(table, idx, w)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        fail(f"embedding_bag {what}: output {tuple(got.shape)} is not finite of shape {tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= limit).all()):
        fail(f"embedding_bag {what}: an element differs from the plain version by "
             f"{float((diff - limit).max())} beyond its limit")
    return {"max_abs_err": float(diff.max()), "share_of_limit": float((diff / limit).max())}


def phase_bag(torch, dev, tt_params, din_table, xdeepfm_linear, flush) -> dict:
    """The embedding-bag kernel against its plain version at the recsys
    path's shapes (the two-tower towers at serve_bulk and serve_p99 on the
    full-size tables, DIN's interest and xDeepFM's linear term at
    serve_p99), with int32 and int64 ids, zero weights, ids outside [0, V)
    (which must give exactly the in-range-only sum) and a table view whose
    rows are not on 16 bytes; then two planted faults the limit must
    reject (on the user tower's shape with weights in [0, 1), since the
    path's 0/1 mask hides a squared weight), and the kernel timed at the user tower's serve_bulk shape
    beside its plain version and ``F.embedding_bag``. Returns the kernels
    row."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.configs.two_tower_retrieval import CONFIG as TT
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    g = torch.Generator(device=dev)
    g.manual_seed(11)
    bulk, p99 = RECSYS_SHAPES["serve_bulk"].batch, RECSYS_SHAPES["serve_p99"].batch
    user, item = tt_params["user_table"], tt_params["item_table"]

    def bags(table, s, l, dtype=torch.int64, zeros=0.2):
        idx = torch.randint(0, table.shape[0], (s, l), generator=g, device=dev).to(dtype)
        w = torch.rand(s, l, generator=g, device=dev)
        return idx, torch.where(torch.rand(s, l, generator=g, device=dev) < zeros, 0.0, w)

    checks = {}
    # The timed case is the main path's own input: the user tower at
    # serve_bulk, its mask as the weights.
    main = recsys_batch(torch, TT, RECSYS_SHAPES["serve_bulk"], g, dev)
    uidx, uw = main["user_ids"], main["user_mask"]
    checks["user tower serve_bulk (path's ids and mask)"] = bag_check(torch, "user bulk", user, uidx, uw)
    cases = {
        "user tower serve_bulk int32": (user, *bags(user, bulk, TT.user_fields, torch.int32)),
        "item tower serve_bulk": (item, *bags(item, bulk, TT.item_fields)),
        "user tower serve_p99": (user, *bags(user, p99, TT.user_fields)),
        "din interest serve_p99": (din_table, *bags(din_table, p99, 100)),
        "xdeepfm linear serve_p99": (xdeepfm_linear, *bags(xdeepfm_linear, p99, 39, torch.int32)),
        "zero weights": (user, bags(user, p99, 8)[0], torch.zeros(p99, 8, device=dev)),
    }
    wide = torch.empty(min(100_000, user.shape[0]), 257, device=dev)
    wide[:, 1:] = user[: wide.shape[0]]
    cases["unaligned rows (stride 257, +4 bytes)"] = (wide[:, 1:], *bags(wide, p99, 8))
    for what, (table, idx, w) in cases.items():
        checks[what] = bag_check(torch, what, table, idx, w)
    if bool(embedding_bag_cuda(user, *cases["zero weights"][1:]).any()):
        fail("embedding_bag: zero weights did not give exactly 0")
    _, fidx, fw = cases["user tower serve_bulk int32"]
    del wide, cases

    for dtype in (torch.int32, torch.int64):
        idx, w = bags(user, p99, 8, dtype)
        far = torch.randint(user.shape[0], 2**31 - 1, (p99, 8), generator=g, device=dev)
        bad = torch.rand(p99, 8, generator=g, device=dev) < 0.25
        idx = torch.where(bad, torch.where(far % 2 == 0, far, -far), idx.long())
        if dtype == torch.int64:
            idx[0, :3] = torch.tensor([2**32 + 7, -(2**32) + 7, 2**62], device=dev)
        idx = idx.to(dtype)
        valid = (idx >= 0) & (idx < user.shape[0])
        got = embedding_bag_cuda(user, idx, w)
        in_range = embedding_bag_cuda(user, torch.where(valid, idx, 0), torch.where(valid, w, 0.0))
        if not torch.equal(got, in_range):
            fail(f"embedding_bag: {dtype} ids outside [0, V) do not give exactly the in-range sum")
        checks[f"ids outside [0, V), {dtype}"] = bag_check(torch, f"outside {dtype}", user, idx, w)
    log(f"[bag] kernel vs plain version per element: {json.dumps(checks)}")

    # The limit must reject planted faults, written as perturbations of
    # the plain version's output.
    want = ref.embedding_bag_bags(user, fidx, fw)
    limit = ref.embedding_bag_error_bound(user, fidx, fw)
    faults = {
        "last index of each bag dropped": ref.embedding_bag_bags(user, fidx[:, :-1], fw[:, :-1]),
        "weight applied twice": ref.embedding_bag_bags(user, fidx, fw * fw),
    }
    for what, bad in faults.items():
        excess = float(((bad - want).abs() - limit).max())
        if not excess > 0:
            fail(f"embedding_bag: the per-element limit does not reject a planted fault ({what})")
        log(f"[bag] planted fault, {what}: max abs err {float((bad - want).abs().max())}, "
            f"{excess} beyond the limit: rejected")
    del faults, want, limit, fidx, fw

    s, l, d = uidx.shape[0], uidx.shape[1], user.shape[1]
    lib = torch.nn.functional.embedding_bag
    lib_err = float((lib(uidx, user, per_sample_weights=uw, mode="sum")
                     - ref.embedding_bag_bags(user, uidx, uw)).abs().max())
    ms = time_cuda(torch, lambda: embedding_bag_cuda(user, uidx, uw), flush)
    plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags(user, uidx, uw), flush, iters=5)
    library_ms = time_cuda(torch, lambda: lib(uidx, user, per_sample_weights=uw, mode="sum"), flush)
    needed = int((uw != 0).sum())  # rows a sum of the nonzero terms reads
    nbytes = needed * d * 4 + s * l * (uidx.element_size() + 4) + s * d * 4
    all_rows = s * l * d * 4 + s * l * (uidx.element_size() + 4) + s * d * 4
    ops_ = 2 * needed * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    row = {
        "name": "embedding_bag",
        "route": "cuda",
        "source": KERNEL_INFO["embedding_bag"][0],
        "replaces": KERNEL_INFO["embedding_bag"][1],
        "launches": 0,
        "max_abs_err": checks["user tower serve_bulk (path's ids and mask)"]["max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "bytes": int(nbytes),
    }
    log(
        f"[bag] timed at the user tower's serve_bulk input: S={s} L={l} D={d} V={user.shape[0]} "
        f"int64 ids, {needed} of {s * l} weights nonzero (the mask); every row read: "
        f"{all_rows} bytes, {all_rows / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 TB/s; "
        f"F.embedding_bag vs plain max abs err {lib_err}; {json.dumps(row)}"
    )
    return row


def phase_recsys(torch, dev, seed: int, flush, profile: bool) -> dict:
    """Recsys serving at full width: the embedding-bag kernel checks
    (``phase_bag``), then two-tower-retrieval through ``serve_step`` at
    serve_p99, serve_bulk and retrieval_cand at executor "kernel" (the
    main path: the launch counts are read just after it) and "reference",
    held element by element; DIN, xDeepFM and SASRec at serve_p99. Returns
    the kernels row with the main path's launches."""
    from repro_torch.configs import RECSYS_SHAPES, RecsysShape, din, sasrec, xdeepfm
    from repro_torch.configs.two_tower_retrieval import CONFIG as TT
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import TwoTower, init_params, serve_step
    from repro_torch.models.recsys import RECSYS_MODELS

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tt_params = init_params(TT, g, device=dev)
    others = {name: (mod.CONFIG, init_params(mod.CONFIG, g, device=dev))
              for name, mod in (("din", din), ("xdeepfm", xdeepfm), ("sasrec", sasrec))}
    torch.cuda.synchronize()
    log(
        f"[recsys] two-tower-retrieval: user table {tuple(tt_params['user_table'].shape)}, item "
        f"table {tuple(tt_params['item_table'].shape)} f32, tower MLP {TT.tower_mlp}; "
        f"{sum(p.numel() for p in tt_params.values())} parameters; din, xdeepfm, sasrec "
        f"{[sum(p.numel() for p in ps.values()) for _, ps in others.values()]}; all made on the "
        f"card in {time.perf_counter() - t0:.3f}s; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated"
    )
    row = phase_bag(torch, dev, tt_params, others["din"][1]["table"],
                    others["xdeepfm"][1]["linear"], flush)

    models = {ex: TwoTower.from_params(TT, tt_params, executor=ex) for ex in ("kernel", "reference")}
    batches = {
        name: recsys_batch(torch, TT, RECSYS_SHAPES[name], g, dev) for name in ("serve_p99", "serve_bulk")
    }
    n_cand = RECSYS_SHAPES["retrieval_cand"].n_candidates
    cand = recsys_batch(torch, TT, RecsysShape("serve", n_cand), g, dev)  # the candidates' items
    query = recsys_batch(torch, TT, RECSYS_SHAPES["retrieval_cand"], g, dev)

    def serve(model, name):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = serve_step(model, RECSYS_SHAPES[name])(batches[name])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def candidates(model):
        """Candidate embeddings [1M, 256], item_embed in chunks."""
        return torch.cat([
            model.item_embed(cand["item_ids"][i:i + RECSYS_CAND_CHUNK],
                             cand["item_mask"][i:i + RECSYS_CAND_CHUNK])
            for i in range(0, n_cand, RECSYS_CAND_CHUNK)
        ])

    def retrieve(model, cand_emb):
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = serve_step(model, RECSYS_SHAPES["retrieval_cand"])(query | {"cand_emb": cand_emb})
        top = torch.topk(scores[0], RECSYS_TOPK)
        torch.cuda.synchronize()
        return scores, top, time.perf_counter() - t

    n_calls = -(-n_cand // RECSYS_CAND_CHUNK)
    # Bag launches of one executor's drive below: a serve step launches
    # one per tower, an item_embed and a retrieval one each.
    path_launches = 2 * (1 + RECSYS_P99_STEPS + 1 + 3) + n_calls + 1 + 10
    stats, outs, counts = {}, {}, {}
    for ex, model in models.items():
        serve(model, "serve_p99")  # warm
        retrieve(model, torch.zeros(RECSYS_TOPK, TT.tower_mlp[-1], device=dev))
        reset_launches()  # the path starts here
        out_p99, _ = serve(model, "serve_p99")
        step_launches = LAUNCHES["embedding_bag"]
        p99_times = [serve(model, "serve_p99")[1] for _ in range(RECSYS_P99_STEPS)]
        out_bulk, _ = serve(model, "serve_bulk")
        bulk_times = [serve(model, "serve_bulk")[1] for _ in range(3)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        cand_emb = candidates(model)
        torch.cuda.synchronize()
        cand_s = time.perf_counter() - t
        scores, top, _ = retrieve(model, cand_emb)
        ret_times = [retrieve(model, cand_emb)[2] for _ in range(10)]
        counts[ex] = dict(LAUNCHES)  # read right after the path's run
        u, v = {}, {}
        for name, batch in batches.items():
            u[name] = model.user_embed(batch["user_ids"], batch["user_mask"])
            v[name] = model.item_embed(batch["item_ids"], batch["item_mask"])
        outs[ex] = {"serve_p99": out_p99, "serve_bulk": out_bulk, "u": u, "v": v,
                    "cand_emb": cand_emb, "scores": scores, "top": top}
        stats[ex] = {
            "serve_p99_ms": percentiles_ms(p99_times),
            "serve_bulk_users_per_s": float(RECSYS_SHAPES["serve_bulk"].batch / np.median(bulk_times)),
            "candidates_1m_ms": cand_s * 1e3,
            "retrieval_cand_ms": percentiles_ms(ret_times),
            "bag_launches_per_serve_step": step_launches,
            "bag_launches": counts[ex]["embedding_bag"],
        }
        log(f"[recsys] two-tower {ex} executor: {json.dumps(stats[ex])}")
    if stats["kernel"]["bag_launches_per_serve_step"] != 2 or counts["kernel"]["embedding_bag"] != path_launches:
        fail(f"recsys: {stats['kernel']['bag_launches_per_serve_step']} bag launches per kernel serve "
             f"step (expected 2, one per tower), {counts['kernel']['embedding_bag']} over the path "
             f"(expected {path_launches})")
    if any(counts["reference"].values()):
        fail(f"recsys: the reference executor launched a kernel: {counts['reference']}")

    kern, refr = outs["kernel"], outs["reference"]
    errs = {}
    for key in ("serve_p99", "serve_bulk"):
        errs[f"scores {key}"] = float((kern[key] - refr[key]).abs().max())
        errs[f"u {key}"] = float((kern["u"][key] - refr["u"][key]).abs().max())
        errs[f"v {key}"] = float((kern["v"][key] - refr["v"][key]).abs().max())
        for t in (kern[key], kern["u"][key], kern["v"][key]):
            if not bool(torch.isfinite(t).all()):
                fail(f"recsys: two-tower {key} outputs are not finite")
    errs["candidate embeddings"] = float((kern["cand_emb"] - refr["cand_emb"]).abs().max())
    errs["retrieval scores"] = float((kern["scores"] - refr["scores"]).abs().max())
    log(f"[recsys] two-tower kernel vs reference, max abs diff: {json.dumps(errs)} (limit {RECSYS_TT_TOL})")
    for key, err in errs.items():
        if not err <= RECSYS_TT_TOL:
            fail(f"recsys: two-tower {key} differ across executors by {err} > {RECSYS_TT_TOL}")
    norms = kern["u"]["serve_bulk"].norm(dim=-1)
    if not bool(((norms - 1).abs() < 1e-4).all()):
        fail("recsys: two-tower user embeddings are not unit vectors")
    if tuple(kern["scores"].shape) != (1, RECSYS_SHAPES["retrieval_cand"].n_candidates):
        fail(f"recsys: retrieval scores of shape {tuple(kern['scores'].shape)}")
    swaps = topk_swaps(
        "two-tower retrieval_cand top-100, kernel vs reference",
        kern["top"].indices.cpu().numpy(), kern["top"].values.cpu().numpy(),
        refr["top"].indices.cpu().numpy(), refr["top"].values.cpu().numpy(),
        0.0, tol=RECSYS_TT_TOL, tie=2 * RECSYS_TT_TOL,
    )
    log(f"[recsys] retrieval_cand top-{RECSYS_TOPK} of {RECSYS_SHAPES['retrieval_cand'].n_candidates} "
        f"candidates: {swaps} places swapped within a tie of {2 * RECSYS_TT_TOL}; scores "
        f"{float(kern['top'].values[-1])}..{float(kern['top'].values[0])}")
    if profile:
        profile_recsys(torch, models["kernel"], batches)
    del models, outs, kern, refr, batches, cand, tt_params

    # DIN, xDeepFM, SASRec at full width, serve_p99 only (retrieval_cand does
    # not fit: DIN's 1M broadcast histories are a [1M, 100, 72] f32 feature
    # tensor, 28.8 GB, before the attention MLP; xDeepFM's CIN at 1M rows is
    # hundreds of GB).
    shape = RECSYS_SHAPES["serve_p99"]
    for name, (cfg, params) in others.items():
        batch = recsys_batch(torch, cfg, shape, g, dev)
        res, launched, lat = {}, {}, {}
        for ex in ("kernel", "reference"):
            model = RECSYS_MODELS[type(cfg)].from_params(cfg, params, executor=ex)
            step = serve_step(model, shape)
            step(batch)  # warm
            reset_launches()  # this model's path
            res[ex] = step(batch)
            torch.cuda.synchronize()
            launched[ex] = LAUNCHES["embedding_bag"]
            times = []
            for _ in range(20):
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            lat[ex] = percentiles_ms(times)
        got, want = res["kernel"], res["reference"]
        if tuple(got.shape) != (shape.batch,) or not bool(torch.isfinite(got).all()):
            fail(f"recsys {name}: outputs of shape {tuple(got.shape)} are not finite of shape [{shape.batch}]")
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        expect = 0 if name == "sasrec" else 1
        if launched != {"kernel": expect, "reference": 0}:
            fail(f"recsys {name}: bag launches per serve step {launched}, expected {expect} at the kernel executor")
        if name != "sasrec" and not err <= RECSYS_LOGIT_TOL:
            fail(f"recsys {name}: logits differ across executors by {err} of max(1, |ref|) > {RECSYS_LOGIT_TOL}")
        log(f"[recsys] {name} serve_p99: kernel vs reference max |diff| / max(1, |ref|) {err}, "
            f"outputs {float(want.abs().max())} at most; bag launches per step {launched}; step "
            f"latency (ms) kernel {json.dumps(lat['kernel'])} reference {json.dumps(lat['reference'])}")
    row["launches"] = counts["kernel"]["embedding_bag"]
    log(f"[recsys] phase took {time.perf_counter() - t0:.1f}s")
    return row


def profile_recsys(torch, model, batches):
    """One kernel-executor two-tower serve step per shape under
    ``torch.profiler``: wall time, device busy share, the bag kernel's time
    and launches, the top device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.models import serve_step

    step = serve_step(model, RECSYS_SHAPES["serve_p99"])
    for name, batch in batches.items():
        step(batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        dev_k = sorted(
            ((getattr(e, "self_device_time_total", 0), e.count, e.key) for e in events
             if str(e.device_type).endswith("CUDA")),
            reverse=True,
        )
        host = sorted(
            ((e.self_cpu_time_total, e.key) for e in events if str(e.device_type).endswith("CPU")),
            reverse=True,
        )
        busy = sum(t for t, _, _ in dev_k)
        bag = [(t, c) for t, c, k in dev_k if "embedding_bag_kernel" in k]
        launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
        log(
            f"[profile] two-tower {name} serve step (kernel executor): {wall_us:.1f} us wall, device "
            f"kernels {busy:.1f} us ({busy / wall_us:.1%} busy), {launches} kernel launches; bag "
            f"kernel {sum(t for t, _ in bag):.1f} us in {sum(c for _, c in bag)} launches; top kernels: "
            + "; ".join(f"{k[:48]} x{c} {t:.1f}us" for t, c, k in dev_k[:5])
            + " | top host ops (self CPU): "
            + "; ".join(f"{k[:32]} {t:.1f}us" for t, k in host[:5])
        )


def attention_step_ms(torch, cfg, b: int, s: int, dev, flush) -> float:
    """Device ms of attention in one train step: one layer's
    ``layers.gqa_attention`` at the step's shape, timed forward (the remat
    pass, no grad) and forward + backward (the recompute and its backward),
    times the layers."""
    from repro_torch.models import layers as L

    dh = cfg.resolved_head_dim
    q, k, v = (torch.randn(b, s, n, dh, device=dev, dtype=cfg.dtype, requires_grad=True)
               for n in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    go = torch.randn(b, s, cfg.n_heads, dh, device=dev, dtype=cfg.dtype)
    kw = dict(causal=True, window=cfg.sliding_window, chunk_size=cfg.attn_chunk)
    with torch.no_grad():
        fwd = time_cuda(torch, lambda: L.gqa_attention(q, k, v, **kw), flush, iters=5)

    def fwd_bwd():
        torch.autograd.grad(L.gqa_attention(q, k, v, **kw), (q, k, v), go)

    return cfg.n_layers * (fwd + time_cuda(torch, fwd_bwd, flush, iters=5))


def train_launcher(torch, out_dir: str) -> None:
    """``repro_torch.launch.train`` on the card (its reduced qwen2-0.5b):
    4 steps with a checkpoint every 2, then a rerun to 6 that resumes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-0.5b",
           "--ckpt-dir", out_dir, "--ckpt-every", "2"]
    for steps, expect in (("4", "done"), ("6", "[resume] step 4")):
        t0 = time.perf_counter()
        r = subprocess.run(cmd + ["--steps", steps], capture_output=True, text=True, env=env,
                           timeout=600)
        if r.returncode != 0 or expect not in r.stdout:
            fail(f"train: launch.train --steps {steps} exited {r.returncode}: "
                 f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
        log(f"[train] launch.train --steps {steps} on the card: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s; {r.stdout.strip().splitlines()[-2:]}")


def phase_train(torch, dev, seed: int, flush) -> None:
    """LM training on the card (``TRAIN_RUNS``): for each, the no-grad loss
    against the step-1 loss, a gradient for every parameter tensor (none
    all zero or non-finite), ``TRAIN_STEPS`` timed steps on one repeated
    batch (the loss must fall; tokens/s, step p50, peak memory, the share
    of attention), and one step at the other microbatch count; for qwen2
    also a run through ``train_loop`` that dies at step 7, resumes from
    its step-5 checkpoint and must end bit for bit where the uninterrupted
    run ended; then the train launcher. Every measurement is printed
    before any failed check raises."""
    from repro_torch.configs.families import lm_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import ShardedBatcher, synthetic_lm_fetch
    from repro_torch.models import init_params
    from repro_torch.train import (
        AdamWConfig, FailureInjector, TrainState, latest_step, make_train_step, train_loop,
    )
    from repro_torch.train.checkpoint import flatten

    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            log(f"[train] FAILED: {msg}")

    opt = AdamWConfig(**TRAIN_OPT)
    tmp = tempfile.mkdtemp(prefix="train_phase_")
    try:
        for i, (arch, layers, b, mb) in enumerate(TRAIN_RUNS):
            t_arch = time.perf_counter()
            cfg = full = get_arch(arch).config
            if layers is not None:
                cfg = dataclasses.replace(cfg, n_layers=layers)
            batcher = ShardedBatcher(global_batch=b, n_shards=1, seed=seed)
            fetched = synthetic_lm_fetch(cfg.vocab, TRAIN_SEQ)(batcher.shard_ids(0, 0))
            batch = {k: torch.as_tensor(v, device=dev) for k, v in fetched.items()}

            def fresh():
                g = torch.Generator(device=dev)
                g.manual_seed(seed + 100 + i)
                return init_params(cfg, g, device=dev)

            state = TrainState.create(fresh())
            n = sum(p.numel() for p in state.params.values())
            loss_fn = lm_loss_fn(cfg)
            halves = [{k: v[j * b // mb:(j + 1) * b // mb] for k, v in batch.items()} for j in range(mb)]
            with torch.no_grad():
                nograd = sum(float(loss_fn(state.params, h)[0]) for h in halves) / mb
            loss, _ = loss_fn(state.params, halves[0])
            grads = torch.autograd.grad(loss, list(state.params.values()))
            zero = [k for k, g in zip(state.params, grads) if not bool(g.any())]
            bad = [k for k, g in zip(state.params, grads) if not bool(torch.isfinite(g).all())]
            del loss, grads
            check(not zero and not bad, f"{arch}: parameters with an all-zero gradient {zero}, "
                                        f"non-finite {bad}")
            log(f"[train] {arch}: {cfg.n_layers} of {full.n_layers} layers, {n} float32 "
                f"parameters ({16 * n / 1e9:.2f} GB with gradients, m and v), batch {b} x "
                f"{TRAIN_SEQ} in {mb} microbatch(es), compute {cfg.compute_dtype}, remat "
                f"{cfg.remat}; autograd took a gradient for all {len(state.params)} parameter "
                f"tensors, none all zero or non-finite")

            step = make_train_step(loss_fn, opt, microbatches=mb)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            losses, times, metrics = [], [], []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                metrics.append({k: float(v) for k, v in m.items()})
                losses.append(metrics[-1]["loss"])
            peak = torch.cuda.max_memory_allocated()
            p50 = float(np.median(times[1:]))
            rel = abs(losses[0] - nograd) / abs(nograd)
            check(rel <= TRAIN_LOSS_TOL, f"{arch}: step-1 loss {losses[0]} vs the no-grad loss "
                                         f"{nograd}: {rel} relative > {TRAIN_LOSS_TOL}")
            check(losses[-1] < losses[0], f"{arch}: the loss did not fall over {TRAIN_STEPS} "
                                          f"steps: {losses}")
            attn = attention_step_ms(torch, cfg, b // mb, TRAIN_SEQ, dev, flush) * mb
            log(f"[train] {arch}: step-1 loss {losses[0]} (no-grad {nograd}, {rel} relative; "
                f"limit {TRAIN_LOSS_TOL}); losses over {TRAIN_STEPS} steps at lr {opt.lr} "
                f"{json.dumps(losses)}; step 1 {json.dumps(metrics[0])}; step p50 "
                f"{p50 * 1e3:.3f} ms (first {times[0] * 1e3:.1f} ms), "
                f"{b * TRAIN_SEQ / p50:.1f} train tokens/s; peak memory {peak / 2**30:.2f} GiB; "
                f"attention (plain chunked, forward + recompute + backward) {attn:.3f} ms a step, "
                f"{attn / (p50 * 1e3):.3f} of the step; {card()}")

            final = None
            if i == 0:
                final = [(k, v.detach().cpu()) for k, v in flatten(state)]
            del state, step
            loss_fn = lm_loss_fn(cfg)
            torch.cuda.empty_cache()

            other = 2 if mb == 1 else 1
            state = TrainState.create(fresh())
            state, m = make_train_step(loss_fn, opt, microbatches=other)(state, batch)
            m = {k: float(v) for k, v in m.items()}
            d_loss = abs(m["loss"] - metrics[0]["loss"]) / abs(metrics[0]["loss"])
            d_gn = abs(m["grad_norm"] - metrics[0]["grad_norm"]) / metrics[0]["grad_norm"]
            if cfg.moe is None:
                check(d_loss <= TRAIN_MB_LOSS_TOL and d_gn <= TRAIN_MB_GNORM_TOL,
                      f"{arch}: microbatches {other} vs {mb}: loss {d_loss}, grad_norm {d_gn} "
                      f"relative (limits {TRAIN_MB_LOSS_TOL}, {TRAIN_MB_GNORM_TOL})")
            log(f"[train] {arch}: one step at microbatches {other}: {json.dumps(m)}; vs {mb}: "
                f"loss {d_loss}, grad_norm {d_gn} relative"
                + (f" (limits {TRAIN_MB_LOSS_TOL}, {TRAIN_MB_GNORM_TOL})" if cfg.moe is None
                   else " (MoE: capacity and aux per microbatch by design; no limit)"))
            del state, loss_fn
            torch.cuda.empty_cache()

            if final is not None:
                every, dies = TRAIN_RESUME_AT
                ckdir = os.path.join(tmp, arch)
                kw = dict(init_params_fn=fresh, loss_fn=lm_loss_fn(cfg), batch_iter=lambda _: batch,
                          opt_cfg=opt, n_steps=TRAIN_STEPS, ckpt_dir=ckdir, ckpt_every=every,
                          keep=2, log_every=TRAIN_STEPS, log_fn=log, device=dev)
                t0 = time.perf_counter()
                try:
                    train_loop(failure=FailureInjector(fail_at=(dies,)), **kw)
                    check(False, f"{arch}: the injected failure at step {dies} did not fire")
                except RuntimeError as e:
                    if "injected failure" not in str(e):
                        raise
                check(latest_step(ckdir) == every, f"{arch}: newest committed step "
                                                   f"{latest_step(ckdir)}, not {every}")
                torch.cuda.empty_cache()
                resumed, _ = train_loop(**kw)
                diffs = {k: float((v.detach().cpu() - want).abs().max())
                         for (k, v), (_, want) in zip(flatten(resumed), final)}
                worst = max(diffs, key=diffs.get)
                check(diffs[worst] == 0, f"{arch}: the run resumed from step {every} ends "
                                         f"{diffs[worst]} from the uninterrupted run at {worst}")
                log(f"[train] {arch}: train_loop died at step {dies}, resumed from its step-{every} "
                    f"checkpoint and ended at step {TRAIN_STEPS} with every parameter and Adam "
                    f"moment {'bit for bit' if diffs[worst] == 0 else 'apart'} (largest diff "
                    f"{diffs[worst]} at {worst}); {time.perf_counter() - t0:.1f} s with "
                    f"checkpoint writes")
                del resumed, final, kw
                shutil.rmtree(ckdir, ignore_errors=True)
                torch.cuda.empty_cache()
                train_launcher(torch, os.path.join(tmp, "launcher"))
            del batch, halves
            torch.cuda.empty_cache()
            log(f"[train] {arch} done in {time.perf_counter() - t_arch:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        fail("train: " + "; ".join(failures))


def run(torch, dev, args) -> list:
    """All phases on ``dev``; returns the kernels rows (raises on any
    failed check)."""
    from repro_torch.core import Retriever, WarpSearchConfig

    t0 = time.perf_counter()
    index = make_index(torch, args.seed, dev)
    torch.cuda.synchronize()
    sizes = index.cluster_sizes.float()
    log(
        f"[index] built in {time.perf_counter() - t0:.1f}s: {index.n_tokens} tokens, "
        f"{index.n_docs} docs, {index.n_centroids} clusters (mean {float(sizes.mean()):.1f}, "
        f"max {int(sizes.max())}), {index.nbytes() / 1e9:.3f} GB on the card"
    )
    retriever = Retriever.from_index(index, device=dev)
    plan_ragged = retriever.plan(WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    ))
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = phase_kernels(torch, index, plan_ragged, flush)
    kernel_err = max(row["max_abs_err"] for row in kernels)  # the scoring kernels
    queries, qmask = make_queries(torch, index, 128, args.seed + 1)
    counts, lat = phase_retrieve(torch, retriever, queries, qmask, 4, kernel_err)
    for row in kernels:
        row["launches"] = counts[row["name"]]
    if args.profile:
        phase_profile(torch, retriever, queries, qmask)
    phase_serve(torch, retriever, 256, args.seed + 2, kernel_err)
    phase_fixture(torch, dev)
    serve_dir = tempfile.mkdtemp(prefix="serving_phase_")
    try:
        store = os.path.join(serve_dir, "store")
        seg_launches = phase_segments(torch, index, dev, args.seed + 6, kernel_err, lat, store)
        for row in kernels:
            if row["name"] == "segmented_ragged_fused_gather_score":
                row["launches"] = seg_launches
        phase_serving(torch, index, dev, args.seed + 7, kernel_err, store)
        shutil.rmtree(serve_dir, ignore_errors=True)
        os.makedirs(serve_dir)
        sh = phase_sharded(torch, index, dev, args.seed + 8, kernel_err,
                           os.path.join(serve_dir, "sharded"), args.profile)
        for row in kernels:
            if row["name"] in sh["counts"] and row["name"] != "segmented_ragged_fused_gather_score":
                row["sharded_launches"] = sh["counts"][row["name"]]
        phase_encode(torch, dev, args.seed + 9, kernel_err, sh, args.profile)
        del sh
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    del retriever, index, plan_ragged, queries, qmask
    torch.cuda.empty_cache()

    phase_build(torch, dev, args.seed + 5, kernel_err, args.profile)
    torch.cuda.empty_cache()

    flash = phase_flash(torch, dev, flush)
    seeds = [args.seed + 3 + i for i in range(args.lm_seeds)]
    flash["launches"] = phase_lm(torch, dev, seeds, args.profile)
    torch.cuda.empty_cache()  # the LM's weights and caches are gone
    for arch, n in phase_zoo(torch, dev, args.seed + 10, args.profile).items():
        flash["zoo"][arch.split("-")[0]]["launches"] = n

    bag = phase_recsys(torch, dev, args.seed + 4, flush, args.profile)
    torch.cuda.empty_cache()
    phase_train(torch, dev, args.seed + 11, flush)
    return kernels + [flash, bag]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--profile", action="store_true",
        help="profile where a retrieve's time goes (after the retrieve phase, and a "
        "sharded retrieve's and a batch-1 encode's in the sharded phase), "
        "where an LM prefill's time goes (after the lm phase) and where a two-tower "
        "serve step's time goes (in the recsys phase)",
    )
    ap.add_argument(
        "--lm-seeds", type=int, default=1,
        help="hold the lm phase's kernel and reference executors to each other on this "
        "many weight seeds (the first is the main path)",
    )
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    log(f"[setup] torch {torch.__version__} cuda {torch.version.cuda}; {smi}")
    t0 = time.perf_counter()
    kernels = run(torch, torch.device("cuda"), args)
    log(f"[done] all phases in {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
