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
  2b. the autotune table (``autotune``): the sweep of
     ``repro_torch/kernels/autotune_sweep.py`` on this index (one query of
     32 tokens, nprobe 32; the ragged kernel at tile_c 16, 32, 64 and 128,
     the dense one once; each at its ``probe`` carve-outs "full", "dma" and
     "compute", L2 flushed), every point's times and overlap printed;
     ``probe="full"`` bit-identical to the product call and "dma" to its
     plain twin (the probe scores plus each staged row's XOR fold) at
     every point, "compute" longer than the kernel over no rows, and full
     no longer than dma + compute;
     the table through a save and load at a temporary path; with it
     installed, auto / ragged / dense plans resolve the winner's tile from
     "autotune" and give the heuristic plans' doc ids over 128 queries up
     to reported tie swaps; the same entries measured on "cpu" or
     "interpret" leave plans "heuristic"; traced retrieves with
     ``obs.set_kernel_probes(True)`` carry the staging/scoring split
     (full no longer than dma + compute), bit-identical to untraced ones
     (see ``phase_autotune``). Every other
     phase plans without a table (``REPRO_AUTOTUNE_TABLE`` is set to
     ``os.devnull`` at start-up). The kernels line's rows 2 and 3 carry
     their carve-outs at the kernel phase's shape (``dma_ms``,
     ``compute_ms``, ``overlap_frac``);
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
     its centroids and codec (``shard_index``), stacked on the card; 64
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
  6c. one process per shard (``ranks``, after ``sharded``, on its store):
     a gloo world of 4 ranks sharing the first card and an NCCL world of
     min(cards, 4) ranks, one card each (on one card, a world of 1 over a
     1-shard cut of the index), spawned by ``repro_torch.launch.ranks``;
     the sharded step's 64 queries single and batched at the four
     configs x both executors, ids equal to the one-process stack's up to
     reported tie swaps, one scoring launch per rank per retrieve, each
     rank holding its shard's bytes on its card and no more than
     RANK_MEM_SLACK beside them; a burst, a 50% allowlist and a 1%
     delete served from rank 0, every
     reply equal to the stack's ``plan.retrieve``; rank 0's p50 / p95 /
     p99 beside the stack's and its collectives timed alone; then
     ``launch.serve --ranks`` (see ``phase_ranks``). Rows 1-3 of the
     kernels line carry the launches per rank as ``ranks_launches``;
  6c'. the encoder trained (``encoder_train``, after ``encode``): the XTR
     token encoder at ``EncoderConfig()`` trained with
     ``examples/train_encoder_torch.py``'s in-batch objective and AdamW on
     its ``make_batch`` batches (128 queries of 32 tokens, documents of
     192): step-1 loss = no-grad loss, every gradient finite and not all
     zero (the embedding's on exactly the rows the batch names), two
     step-1 gradients bit for bit, the loss falling over 10 steps, a
     ``train_loop`` killed at step 7 resumed from step 5 to the same bits;
     step p50, tokens/s, peak memory and the step's parts printed; then
     4,096 documents encoded with the untrained and the trained encoder,
     each indexed by ``Retriever.build`` and searched by 128 sub-sequence
     queries at the three scoring kernels' configs x both executors (ids
     up to reported tie swaps, each kernel launched; the kernels line's
     rows 1-3 carry the launches as ``encoder_train_launches``), success@5
     no lower after training; and ``examples/train_encoder_torch.py`` run
     on the card at its defaults (see ``phase_encoder_train``);
  6d. the cell layer (``dryrun``, after ``encode``): ``launch/dryrun.py``
     runs ``DRYRUN_CELLS`` (warp-xtr search_lifestyle, qwen2-0.5b
     long_500k, din serve_p99, gin-tu molecule) whole at full width, each
     held to ``roofline.model_flops``, its kernels' launches to the step
     counter's calls and their ``work(...)``, 0 < MFU <= 1.05 and a peak
     below the card's memory; the warp cell's ``step_fn`` held to the
     reference executor (see ``phase_dryrun``). Every kernels row's
     ``bound_ms`` reads its kernel's ``work(...)`` function;
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
     Then the ``zoo`` step: qwen3-4b (4 of its 36 layers) and yi-6b (4
     of 32) on a 4 x 2048 prompt, mixtral-8x7b (2 of 32) and dbrx-132b
     (2 of 40) at full width on 2 x 8192 (mixtral's 4096-token window
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
 10. LM training (``train``): qwen2-0.5b at full width, 2 of its 24
     layers (4 x 4096, train_4k's sequence) and one mixtral-8x7b layer at full width
     (2 x 4096 in its 2 microbatches), float32 parameters and Adam state,
     bf16 compute, remat, batches from ``ShardedBatcher`` +
     ``synthetic_lm_fetch``: the step-1 loss equals the no-grad loss,
     every parameter gets a gradient, the loss falls over 10 steps on one
     repeated batch, microbatches 2 equal 1 (qwen2), a ``train_loop``
     killed at step 7 resumes from its step-5 checkpoint to the same bits;
     train tokens/s, step p50, peak memory and attention's share of the
     step printed. Then recsys training (``recsys_train``): the embedding
     bag's backward kernels (the table's dense gradient, the weights')
     against their plain version per element at the training shapes (int32
     and int64 ids, duplicates, zero weights, ids outside [0, V), one row
     named 100,000 times), two calls bit-identical, the table entry's sort
     and row offsets equal to ``ref.bag_sort`` / ``ref.bag_csr``, two
     planted faults rejected, timed beside ``F.embedding_bag``'s autograd
     (the user tower; DIN's history per gradient and both; xDeepFM's linear
     term), and the forward kernel at DIN's history (its kernels row's
     ``din_history``); two-tower (B 32,768), xDeepFM (65,536
     in 4 microbatches), DIN and SASRec (65,536) at full width: the step-1
     loss equals the no-grad loss, every gradient finite and non-zero, the
     tables' only on rows the batch names, kernel vs reference executor
     (loss; gradients teacher-forced), the loss falls over 10 steps,
     xDeepFM's microbatches 4 vs 1, DIN's resume to the same bits; samples/s,
     step p50, peak memory. Then ``gnn``: gin-tu at its four full shapes
     (ogb_products the whole 61.86M-edge graph; minibatch_lg one
     ``neighbor_sample`` draw): two step-1 gradients bit-identical, the same
     loss checks; edges/s, step p50, peak memory, the gather + segment sum
     share. Last, ``launch.train`` trains and resumes qwen2-0.5b, din and
     gin-tu on the card.
 11. the LM and recsys families over a (data, model) mesh of ranks
     (``mesh``, last): one gloo world of 4 ranks sharing the card runs
     mixtral-8x7b at full width at (1, 4) (2 layers, 2 x 8192 prompt, 16
     steps), at (2, 2) (1 layer, 2 x 2048, 4 steps; the FSDP gathers)
     and a batch-1 decode of 2 steps at (4, 1) (1 layer) over a 16,384-position
     cache split by sequence, each teacher-forced in tokens and routing
     against the one-process port at the same weights (logits, KV blocks
     per rank, argmax, would-be routing flips; every rank against rank
     0), then two-tower at serve_bulk and DIN at serve_p99 with tables
     row-sharded over the 4 ranks; the flash kernel at a rank's heads
     (the flash row's ``mesh``, row 4e) and the bag on a rank's row range
     (the bag row's ``rank``, row 5-rank) against their plain versions,
     timed; an NCCL world of min(cards, 4) ranks (one card: a free (1, 1)
     run, bit for bit); and ``dryrun.run_cell`` of mixtral's decode_32k
     (1 layer) over 4 gloo ranks, its collectives counted per op.
 12. the LM, recsys and GNN families trained over meshes of ranks
     (``mesh_train``, last): one gloo world of 4 ranks sharing the card
     trains qwen2-0.5b at 2 of its 24 layers at 2,048 tokens a row
     (batch 4 in 2 microbatches) and one mixtral-8x7b layer at full width (batch 2;
     fsdp experts, then tp_only with local dispatch and ZeRO-1 moments) at
     (2, 2), two-tower at 16,384 rows at (1, 4) and DIN at 65,536 at
     (2, 2), and gin-tu at its CONFIG (full_graph_sm and molecule at
     (2, 2), minibatch_lg at (4, 1), inside MESH_TRAIN_GNN_BUDGET_S), 3
     steps each (mixtral's batch of 2 in one microbatch), held to the
     one-process port on the same state and batch (run first); every
     rank's metrics, gradient blocks, replicated blocks and collective
     counts (each run's recorded in MESH_TRAIN_COUNTS) checked; gin-tu's
     step-1 gradients against the reference's and computed twice bit for
     bit; qwen2's, DIN's and gin-tu molecule's resumes after a failure
     injected at step 3 bit for bit; the bag kernels at DIN's rank
     0 block (rows 5-rank-train and 5b-rank: the bag row's ``rank_train``,
     the backward row's ``rank``) against their plain versions, timed; and
     ``dryrun.run_cell`` of qwen2-0.5b's train_4k at (2, 2), 2 layers.

The depths above are cut (and the segments and sharded steps run 64
queries, not 128) so that the script ends inside its 1200 s on a slower
host: ``[done] phase walls (s)`` prints each phase's time.

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
from repro_torch.launch.roofline import BF16_FLOPS as BF16_OPS_PER_S  # noqa: E402
from repro_torch.launch.roofline import F32_FLOPS as F32_OPS_PER_S  # noqa: E402
from repro_torch.launch.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402

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
# bf16 weights from --seed, one arch at a time. Depth is cut to keep the
# script inside its 1200 s on a slower host (at qwen3-4b's 36 layers,
# yi-6b's 32, mixtral's 8 and dbrx's 4 the zoo took 143.6 s on an H100).
# Whole, mixtral's 32 layers (2.90 GB each) and dbrx's 40 (6.52 GB each)
# would not fit one 80 GB card. The MoE prompts are longer than mixtral's
# 4096-token window, so it binds in prefill and in decode.
ZOO = (  # arch, layers run (None: all), batch, prompt length
    ("qwen3-4b", 4, 4, 2048),
    ("yi-6b", 4, 4, 2048),
    ("mixtral-8x7b", 2, 2, 8192),
    ("dbrx-132b", 2, 2, 8192),
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
# of 256 is cut to what one card holds beside float32 logits. qwen2 runs 2
# of its 24 layers: at 24 its run took 84.9 s of the script's 1200, at 4
# 23.2 s, and the encoder_train phase needs the time.
TRAIN_SEQ = 4096
TRAIN_RUNS = (  # arch, layers run (None: all), batch, microbatches
    ("qwen2-0.5b", 2, 4, 1),
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

# Recsys training (train phase): each model at its full CONFIG, train_batch's
# 65,536 rows, random weights and batches from --seed, float32 state, the
# LM's TRAIN_OPT and TRAIN_STEPS. two-tower is cut to 32,768: its in-batch
# [B, B] float32 logits are 17.2 GB at 65,536 and the softmax holds 2-3 of
# them beside 29 GB of parameters, AdamW moments and dense table gradients;
# microbatches would change its in-batch negatives. xDeepFM runs its rows
# in 4 microbatches: CIN's [B, 7800, 10] products are 20.4 GB each at
# 65,536, and equal chunks of a mean BCE give the same gradient.
RECSYS_TRAIN = (  # arch, batch, microbatches
    ("two-tower-retrieval", 32_768, 1),
    ("xdeepfm", 65_536, 4),
    ("din", 65_536, 1),
    ("sasrec", 65_536, 1),
)
# Kernel vs reference executor on one (micro)batch: the loss within
# TRAIN_LOSS_TOL relative (the bag sums in another order: float32
# round-off). The gradients are held teacher-forced: the kernel model's bags
# give the reference's forward values and take the kernel's backward
# (``forced_bags``), each gradient tensor within RECSYS_GRAD_TOL of its
# norm. Run free, the bags' ~1e-6 forward differences flip ReLUs whose
# inputs sit that near 0 (a few in the millions of units of a 65,536-row
# batch), each moving one row's gradient wholesale, ~1e-3 of a tensor's
# norm: those free-run differences are printed, with no limit.
RECSYS_GRAD_TOL = 1e-5
# xDeepFM microbatches 4 vs 1 at a batch one pass holds: float32 sums of the
# same terms in another grouping, loss and grad_norm within this, relative.
XDEEPFM_MB_BATCH = 16_384
XDEEPFM_MB_TOL = 1e-5
# The bag backward's kernels against their plain version per element within
# ref.embedding_bag_backward_error_bound (float32 sums in another order),
# two calls bit-identical; bound: the bytes it must move.
# GNN (train phase): gin-tu at its CONFIG on the four GNN_SHAPES at full
# size, ogb_products as the whole graph (its 61.86M edges in one pass; no
# chunking). minibatch_lg's batch is one neighbor_sample draw, fanouts
# GNN_FANOUTS (JAX names none; GraphSAGE's two-hop setting), over a seeded
# synthetic CSR graph of Reddit's node count and GNN_AVG_DEGREE, padded to
# the shape's nodes and edges with its masks.
GNN_FANOUTS = (10, 10)
GNN_GRAPH_NODES = 232_965
GNN_AVG_DEGREE = 50

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
DIN_HISTORY_ROWS = RECSYS_TRAIN[2][1]  # DIN's history checked at its training batch

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
SEG_QUERIES = 64  # half the retrieve phase's 128, for the script's time
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
SHARD_QUERIES = 64  # half the retrieve phase's 128, for the script's time
SHARD_BATCHES = 4
SHARD_SERVE_REQUESTS = 256
SHARD_FILTERED = 32
SHARD_ALLOW_FRAC = 0.5
SHARD_DELETE_FRAC = 0.01
# Ranks step: the sharded step's store served by one process per shard
# (``repro_torch.launch.ranks``): a gloo world of SHARDS ranks sharing
# cuda:0, and an NCCL world of min(cards, SHARDS) ranks, one card each
# (over a store cut into as many shards when that is fewer than SHARDS),
# each on all of the sharded step's queries. After its load a rank may
# hold RANK_MEM_SLACK bytes on its card beyond its shard's arrays.
RANK_SERVE_BURST = 64
RANK_SERVE_FILTERED = 16
RANK_MEM_SLACK = 4 << 20
RANK_JOIN_S = 600
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


def make_index(torch, seed: int, dev):
    """The Lifestyle-geometry index (``GEOMETRY``) drawn on ``dev`` from
    ``seed`` by ``warp_family.synth_index``."""
    from repro_torch.configs.warp_family import WarpShape, synth_index

    shape = WarpShape("serve", GEOMETRY["n_tokens"], GEOMETRY["n_docs"],
                      GEOMETRY["n_centroids"], GEOMETRY["cap"], 1)
    return synth_index(warp_xtr.CONFIG, shape, seed, dev)


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
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs
    after 3 untimed ones, with the 50 MB L2 flushed (a 256 MB write) and
    then the card spun before each run, so that the events bracket the
    card's work and not the host's launch path
    (``autotune_sweep.event_ms``)."""
    from repro_torch.kernels.autotune_sweep import event_ms

    return event_ms(fn, warmup=3, iters=iters, flush=flush)


def check_carve_outs(torch, tag, launch, dma_want, empty, flush, full_ms, times=None,
                     invalid=None) -> dict:
    """A fused kernel's carve-outs at one shape. ``launch(probe)`` runs the
    CUDA wrapper (None: the product call), ``dma_want`` is the plain twin
    of its "dma" output (``ref.*_dma``) and ``empty()`` the product kernel
    over no rows. Probe "full" must equal the product call bit for bit;
    "dma" its twin bit for bit, so every row was staged; "compute" float32
    finite values of the product's shape, 0 at ``invalid``; "compute" must
    take longer than the launch over no rows (it scored something) and
    full no longer than dma + compute, before any clamping. ``times``:
    the dma and compute times measured already, else timed here. Returns
    {"dma_ms", "compute_ms", "empty_ms", "overlap_frac"}."""
    from repro_torch.kernels.autotune import overlap_frac

    product = launch(None)
    if not torch.equal(launch("full"), product):
        fail(f"{tag}: probe='full' is not the product call bit for bit")
    dma = launch("dma")
    if not torch.equal(dma, dma_want):
        fail(f"{tag}: probe='dma' differs from the probe scores plus each staged row's XOR "
             f"fold at {int((dma != dma_want).sum())} of {dma.numel()} slots")
    x = launch("compute")
    if x.shape != product.shape or x.dtype != torch.float32 or not bool(torch.isfinite(x).all()) or (
        invalid is not None and bool((x[invalid] != 0).any())
    ):
        fail(f"{tag}: probe='compute' gives no finite float32 scores of the product's shape "
             "with its invalid slots 0")
    if times is None:
        times = {f"{p}_ms": time_cuda(torch, lambda p=p: launch(p), flush) for p in ("dma", "compute")}
    t = {"dma_ms": times["dma_ms"], "compute_ms": times["compute_ms"],
         "empty_ms": time_cuda(torch, empty, flush)}
    if not t["compute_ms"] > t["empty_ms"]:
        fail(f"{tag}: probe='compute' took {t['compute_ms']} ms, no longer than the kernel over "
             f"no rows ({t['empty_ms']} ms)")
    if full_ms > t["dma_ms"] + t["compute_ms"]:
        fail(f"{tag}: full {full_ms} ms > dma {t['dma_ms']} + compute {t['compute_ms']} ms: "
             "the carve-outs do not account for the kernel")
    t["overlap_frac"] = overlap_frac(full_ms, t["dma_ms"], t["compute_ms"])
    return t


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
    from repro_torch.kernels import _build, decompress_score, ref
    from repro_torch.kernels import fused_gather_score as fused
    from repro_torch.kernels.decompress_score import selective_sum_cuda
    from repro_torch.kernels.flash_attention import TILE_K, bf16_smem_bytes
    from repro_torch.kernels.fused_gather_score import (
        dense_dims_per_chunk,
        fused_gather_score_cuda,
        ragged_dims_per_chunk,
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
    rows = int(sizes.clamp(max=cap).sum())
    out = []

    def record(name, got, want, k_fn, p_fn, work, invalid=None, lookups=None):
        """``work``: the kernel's (flops, bytes) from its ``work`` function."""
        err, broken = check_scores(got, want, invalid)
        if broken:
            fail(f"{name}: {broken}")
        ms = time_cuda(torch, k_fn, flush)
        plain_ms = time_cuda(torch, p_fn, flush, iters=5)
        ops, nbytes = work
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

    def carve(launch, dma_want, empty, invalid):
        """The last row beside its kernel's carve-outs at this shape
        (``check_carve_outs``): ``dma_ms``, ``compute_ms`` and
        ``overlap_frac`` against ``ms``."""
        row = out[-1]
        t = check_carve_outs(torch, row["name"], launch, dma_want, empty, flush, row["ms"],
                             invalid=invalid)
        row.update(dma_ms=t["dma_ms"], compute_ms=t["compute_ms"], overlap_frac=t["overlap_frac"])
        log(f"[kernels] {row['name']} carve-outs: full {row['ms']:.5f} ms, dma "
            f"{row['dma_ms']:.5f} ms, compute {row['compute_ms']:.5f} ms, overlap "
            f"{row['overlap_frac']:.4f}; over no rows {t['empty_ms']:.5f} ms; dma equal to its "
            "plain twin bit for bit")

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
        decompress_score.work(q=qm, n=p * cap, pb=pb, dim=d, nbits=nbits),
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
        fused.work(q=qm, p=p, cap=cap, rows=rows, pb=pb, dim=d, nbits=nbits),
        invalid=invalid, lookups=rows * d,
    )
    report_plan("fused_gather_score", index.packed_codes.data_ptr(), qm, p, cap, pb, d, nbits)
    carve(
        lambda probe: fused_gather_score_cuda(*args2, **kw2, probe=probe),
        ref.fused_gather_score_dma(index.packed_codes, starts, sizes, pscore, nbits=nbits, dim=d,
                                   cap=cap, dims_per_chunk=dense_dims_per_chunk(d, nbits, p)),
        lambda: fused_gather_score_cuda(index.packed_codes, starts, torch.zeros_like(sizes),
                                        pscore, v, **kw2, probe="full"),
        invalid,
    )

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
        _, nbytes = decompress_score.work(q=qm, n=p * cap, pb=pbb, dim=d, nbits=b)
        log(
            f"[kernels] selective_sum, nbits {b}: {ms:.5f} ms; bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms, "
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
        fused.ragged_work(w=w, tile_c=tile, q=qm, rows=valid_rows, pb=pb, dim=d, nbits=nbits),
        invalid=slot_invalid, lookups=valid_rows * d,
    )
    report_plan("ragged_fused_gather_score", index.packed_codes.data_ptr(), w, pb, d, nbits)
    carve(
        lambda probe: ragged_fused_gather_score_cuda(*args3, **kw3, probe=probe),
        ref.ragged_fused_gather_score_dma(index.packed_codes, *work, nbits=nbits, dim=d,
                                          tile_c=tile, n_q=qm,
                                          dims_per_chunk=ragged_dims_per_chunk(d, nbits)),
        lambda: ragged_fused_gather_score_cuda(
            index.packed_codes, *work._replace(nvalid=torch.zeros_like(work.nvalid)), v, **kw3,
            probe="full"),
        slot_invalid,
    )
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
    from repro_torch.kernels.fused_gather_score import segmented_work as kernel_work

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
    record(
        "segmented_ragged_fused_gather_score", got, want,
        lambda: segmented_ragged_fused_gather_score_cuda(*args, **kw),
        lambda: ref.segmented_ragged_fused_gather_score(*args, **kw),
        kernel_work(w=w, tile_c=tile, q=qm, rows=valid_rows, n_segments=len(codes), pb=pb,
                    dim=d, nbits=nbits),
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


def phase_autotune(torch, retriever, queries, qmask, seed: int, kernel_err: float) -> None:
    """The autotune sweep on the Lifestyle index (``kernels/autotune_sweep.py``:
    one query of 32 tokens, nprobe 32; the ragged kernel at tile_c 16, 32,
    64, 128, the dense one once) with every point's full, dma and compute
    times and overlap; at every point the carve-outs held as
    ``check_carve_outs`` holds them (dma equal to its plain twin bit for
    bit, full <= dma + compute); the table through a save and load at a temporary
    path; with it installed, auto / ragged / dense plans from
    ``tile_source == "autotune"`` at the winner's tile, their doc ids over
    ``queries`` equal to the heuristic plans' up to reported tie swaps,
    scores within TOL; the same entries measured on "cpu" or "interpret"
    leave plans "heuristic"; then, with ``obs.set_kernel_probes(True)``,
    traced retrieves of the heuristic (fused, dense) and (fused, ragged)
    plans carry the split on their gather_score span (full <= dma +
    compute), bit-identical to the untraced retrieve, one product launch
    each. Resets the table and the
    probes."""
    from repro_torch import obs
    from repro_torch.core import Retriever, WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, autotune, autotune_sweep, ref
    from repro_torch.kernels.fused_gather_score import (
        dense_dims_per_chunk,
        fused_gather_score_cuda,
        ragged_dims_per_chunk,
        ragged_fused_gather_score_cuda,
    )

    index = retriever.index
    flush = torch.empty(autotune_sweep.FLUSH_BYTES, dtype=torch.uint8, device=index.device)
    dev = index.device
    t0 = time.perf_counter()
    q1, m1 = make_queries(torch, index, 1, seed, lo=32, hi=32)
    tmp = tempfile.mkdtemp(prefix="autotune_phase_")
    try:
        path = os.path.join(tmp, "table.json")
        table, rows = autotune_sweep.run(
            index, q1[0], m1[0], nprobe=ARCH["nprobe"], qtokens=32, out_path=path,
            install=False, log=log,
        )
        if autotune.AutotuneTable.load(path).to_json() != table.to_json():
            fail("autotune: the table does not come back equal from its file")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for row in rows:
        if not (min(row["full_ms"], row["dma_ms"], row["compute_ms"]) > 0
                and 0.0 <= row["overlap_frac"] <= 1.0):
            fail(f"autotune: point {row} has a time <= 0 or an overlap outside [0, 1]")

    # The carve-outs at every swept point (check_carve_outs), against the
    # sweep's own times: "full" the product call, "dma" its plain twin.
    starts, sizes, pscores, v = autotune_sweep.sweep_probe_set(
        index, q1[0], m1[0], nprobe=ARCH["nprobe"], qtokens=32
    )
    kw = dict(nbits=index.nbits, dim=index.dim)
    nbits, d, qm = index.nbits, index.dim, starts.shape[0]
    for row in rows:
        layout, tile = row["layout"], row["tile_c"]
        if layout == "dense":
            args = (index.packed_codes, starts, sizes, pscores)
            launch = functools.partial(fused_gather_score_cuda, *args, v, cap=index.cap, **kw)
            want = ref.fused_gather_score_dma(
                *args, cap=index.cap, dims_per_chunk=dense_dims_per_chunk(d, nbits, sizes.shape[1]),
                **kw)
            empty = functools.partial(fused_gather_score_cuda, index.packed_codes, starts,
                                      torch.zeros_like(sizes), pscores, v, cap=index.cap,
                                      probe="full", **kw)
        else:
            work = autotune_sweep.ragged_worklist(index, starts, sizes, pscores, tile)
            launch = functools.partial(ragged_fused_gather_score_cuda, index.packed_codes, *work, v,
                                       tile_c=tile, **kw)
            want = ref.ragged_fused_gather_score_dma(
                index.packed_codes, *work, tile_c=tile, n_q=qm,
                dims_per_chunk=ragged_dims_per_chunk(d, nbits), **kw)
            empty = functools.partial(
                ragged_fused_gather_score_cuda, index.packed_codes,
                *work._replace(nvalid=torch.zeros_like(work.nvalid)), v, tile_c=tile,
                probe="full", **kw)
        t = check_carve_outs(torch, f"autotune: {layout} tile_c {tile}",
                             lambda probe, launch=launch: launch(probe=probe), want, empty, flush,
                             row["full_ms"], times=row)
        log(f"[autotune] {layout} tile_c {tile}: over no rows {t['empty_ms']:.5f} ms")
    log(f"[autotune] at all {len(rows)} points: probe='full' bit-identical to the product call, "
        "'dma' to its plain twin; compute longer than a launch over no rows; full <= dma + compute")

    # The plans the table steers, and those it must not.
    base = dict(nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
                gather="fused", executor="kernel")
    geo = dict(nbits=index.nbits, dim=index.dim, cap=index.cap, n_tokens=index.n_tokens)
    winner = {
        layout: table.lookup(layout, backend="cuda", **geo).tile_c for layout in ("dense", "ragged")
    }

    def plans(tbl):
        autotune.set_default_table(tbl)
        try:
            r = Retriever.from_index(index, device=dev)
            return {layout: r.plan(WarpSearchConfig(**base, layout=layout))
                    for layout in ("auto", "ragged", "dense")}
        finally:
            autotune.set_default_table(None)

    heuristic = plans(autotune.AutotuneTable())
    tuned = plans(table)
    swaps = 0
    for layout, plan in tuned.items():
        d, h = plan.describe(), heuristic[layout].describe()
        if h["tile_source"] != "heuristic":
            fail(f"autotune: the {layout} plan without a table is from {h['tile_source']!r}")
        if d["tile_source"] != "autotune" or d["tile_c"] != winner[d["layout"]]:
            fail(f"autotune: the {layout} plan resolved tile_c {d['tile_c']} from "
                 f"{d['tile_source']!r}, not the winner {winner[d['layout']]} from 'autotune'")
        got, _ = run_timed(torch, plan, queries, qmask)
        want, _ = run_timed(torch, heuristic[layout], queries, qmask)
        for i, (g_, w_) in enumerate(zip(got, want)):
            swaps += topk_swaps(f"autotune: tuned {layout} plan vs heuristic, query {i}",
                                *g_, *w_, kernel_err)
        log(f"[autotune] {layout} plan: tuned {json.dumps({k: d[k] for k in ('layout', 'tile_c', 'tile_source', 'worklist_tiles')})}"
            f" vs heuristic {json.dumps({k: h[k] for k in ('layout', 'tile_c', 'tile_source', 'worklist_tiles')})}")
    for other in ("cpu", "interpret"):
        foreign = autotune.AutotuneTable({
            k: dataclasses.replace(t, measured_on=other) for k, t in table.entries.items()
        })
        for layout, plan in plans(foreign).items():
            if plan.describe()["tile_source"] != "heuristic":
                fail(f"autotune: an entry measured on {other!r} steered the {layout} plan on the card")
    log(f"[autotune] tuned vs heuristic plans: {swaps} places swapped within a tie over "
        f"{3 * queries.shape[0]} (query, plan) pairs; entries measured on 'cpu' / 'interpret' "
        "left every plan heuristic")

    # The split on traced retrieves, probes armed.
    n_traced = 8
    for layout in ("dense", "ragged"):
        plan = heuristic[layout]
        name = KERNEL_OF[("fused", layout)]
        untraced = [plan.retrieve(queries[i], qmask[i]) for i in range(n_traced)]
        tracer = obs.set_tracer(obs.Tracer())
        obs.set_kernel_probes(True)
        before = dict(LAUNCHES)
        try:
            traced = [plan.retrieve(queries[i], qmask[i]) for i in range(n_traced)]
            torch.cuda.synchronize()
        finally:
            obs.disable_all()
        if LAUNCHES[name] - before[name] != n_traced:
            fail(f"autotune: {n_traced} traced {layout} retrieves launched {name} "
                 f"{LAUNCHES[name] - before[name]} times")
        for a, b in zip(traced, untraced):
            if not (torch.equal(a.doc_ids, b.doc_ids) and torch.equal(a.scores, b.scores)):
                fail(f"autotune: a traced {layout} retrieve with probes armed differs from the untraced one")
        splits = [e.args for e in tracer.events() if e.name == "gather_score"]
        keys = ("kernel_full_ms", "dma_ms", "compute_ms", "overlap_frac", "probe_tile_c",
                "probe_buffering")
        if len(splits) != n_traced or any(
            not set(keys) <= set(a) or not 0.0 <= a["overlap_frac"] <= 1.0 for a in splits
        ):
            fail(f"autotune: a traced {layout} gather_score span lacks the split or its overlap "
                 "lies outside [0, 1]")
        for a in splits:
            if a["kernel_full_ms"] > a["dma_ms"] + a["compute_ms"]:
                fail(f"autotune: a traced {layout} split reads full {a['kernel_full_ms']} ms > "
                     f"dma {a['dma_ms']} + compute {a['compute_ms']} ms")
        med = {k: float(np.median([a[k] for a in splits])) for k in keys[:4]}
        log(f"[autotune] traced {layout} retrieves with kernel probes (median of {n_traced}): "
            f"{json.dumps(med)}, tile_c {splits[0]['probe_tile_c']}; one {name} launch each, "
            "ids bit-identical to untraced")
    autotune.set_default_table(None)
    log(f"[autotune] phase took {time.perf_counter() - t0:.1f}s")


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
    stack = {}  # the stack's replies, for the ranks phase
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            name = "/".join(key)
            res, bres = results[key]
            stack[key] = (res, [(b.doc_ids.cpu().numpy(), b.scores.cpu().numpy()) for b in bres])
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
    out = dict(counts=counts, lat=lat, swaps=swaps, sidx=sidx, single=single, rs=rs,
               queries=(qh, mh), stack=stack, store=store)
    log(f"[sharded] phase done in {time.perf_counter() - t_phase:.3f} s; {smi}")
    return out


def arch_config(gather: str, layout: str, executor: str = "kernel"):
    from repro_torch.core import WarpSearchConfig

    return WarpSearchConfig(
        nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"],
        gather=gather, layout=layout, executor=executor,
    )


def stack_run(torch, retriever, qh, mh, n_batches: int):
    """The one-process stack over host queries at the four configs x both
    executors: ``{key: (single [(ids, scores)], batches [(ids, scores)])}``
    and ``{key: per-query latency percentiles}``."""
    q, m = torch.from_numpy(qh).cuda(), torch.from_numpy(mh).cuda()
    out, lat = {}, {}
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            plan = retriever.plan(arch_config(gather, layout, executor))
            plan.warmup()
            plan.retrieve(q[0], m[0])
            res, times = run_timed(torch, plan, q, m)
            bres = [plan.retrieve_batch(q[4 * b: 4 * b + 4], m[4 * b: 4 * b + 4])
                    for b in range(n_batches)]
            key = (gather, layout, executor)
            out[key] = (res, [(b.doc_ids.cpu().numpy(), b.scores.cpu().numpy()) for b in bres])
            lat[key] = percentiles_ms(times)
    return out, lat


class CollectiveTimer:
    """A numbered object made on every rank of a ``ranks`` world before
    its follower loop, so that rank 0 can time a retrieve's collectives
    alone: the command broadcast (``noop``) and the two all-gathers at a
    retrieve's shapes (``gathers``)."""

    def __init__(self, group):
        self.group = group
        self.oid = group.register(self)

    def noop(self) -> None:
        if self.group.rank == 0:
            self.group.lead("call", self.oid, "noop", (), {})

    def gathers(self, n: int, b: int, qm: int, kk: int, k: int) -> float:
        """``n`` rounds of the two gathers; seconds per round on rank 0."""
        import torch

        g = self.group
        if g.rank == 0:
            g.lead("call", self.oid, "gathers", (n, b, qm, kk, k), {})
        dev = g.device
        first = [(torch.zeros((b, qm, kk), device=dev),
                  torch.zeros((b, qm, kk), dtype=torch.int32, device=dev))]
        second = [(torch.zeros((b, k), device=dev),
                   torch.zeros((b, k), dtype=torch.int32, device=dev))]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            g.gather("warp_select", None, first, [1])
            g.gather("score_and_reduce", None, second, [0])
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / n


def rank_world(group, store: str, spec_path: str, out_path: str) -> None:
    """One rank of a ``ranks`` world. Rank 0 loads ``store`` over the group
    (each rank its own shard), plans the four configs x both executors,
    retrieves the spec's queries one by one (timed on the host clock
    between two synchronizes of its card) and in batches of 4, reading
    every rank's launch counts around each plan's run (``rank_info``), then
    serves a burst, an allowlist and a delete through a
    ``RetrievalServer``, and writes what it saw to ``out_path`` (.npz and
    .json). Ranks 1..S-1 follow."""
    import torch

    from repro_torch.core import DocFilter, Retriever
    from repro_torch.serving import BatchPolicy, RetrievalServer, follow

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = CollectiveTimer(group)
    if group.rank:
        follow(group)
        return
    try:
        spec = np.load(spec_path)
        qh, mh, nb = spec["q"], spec["qmask"], int(spec["n_batches"])
        r = Retriever.from_store(store, group=group)
        meta = {"load": r.rank_info(), "card": card()}
        plans = {}
        for gather, layout in CONFIGS:
            for executor in ("kernel", "reference"):
                plan = r.plan(arch_config(gather, layout, executor))
                plan.warmup()
                plan.retrieve(qh[0], mh[0])
                plans[(gather, layout, executor)] = plan
        arrays = {}
        for key, plan in plans.items():
            name = "/".join(key)
            before = r.rank_info()
            res, times = run_timed(torch, plan, qh, mh)
            bres = [plan.retrieve_batch(qh[4 * b: 4 * b + 4], mh[4 * b: 4 * b + 4])
                    for b in range(nb)]
            after = r.rank_info()
            arrays[name + "/ids"] = np.stack([i for i, _ in res])
            arrays[name + "/scores"] = np.stack([s for _, s in res])
            arrays[name + "/batch_ids"] = np.stack([b.doc_ids.cpu().numpy() for b in bres])
            arrays[name + "/batch_scores"] = np.stack([b.scores.cpu().numpy() for b in bres])
            meta[name] = {
                "lat": percentiles_ms(times),
                "launches": [{k: a["launches"][k] - b["launches"][k] for k in a["launches"]}
                             for a, b in zip(after, before)],
            }
        server = RetrievalServer(r, arch_config("fused", "ragged"),
                                 BatchPolicy(max_batch=8, max_wait_s=0.002))
        n, nf = qh.shape[0], int(spec["filtered"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [server.submit(qh[i % n], mh[i % n]) for i in range(int(spec["burst"]))]
        server.drain()
        meta["burst_s"] = time.perf_counter() - t0
        allow = DocFilter.from_bitmap(spec["allow"])
        rids += [server.submit(qh[i], mh[i], dfilter=allow) for i in range(nf)]
        server.drain()
        server.delete_documents(spec["deleted"].tolist())
        rids += [server.submit(qh[i], mh[i]) for i in range(nf)]
        server.drain()
        replies = [server.poll(rid) for rid in rids]
        arrays["serve/ids"] = np.stack([d for _, d in replies])
        arrays["serve/scores"] = np.stack([s for s, _ in replies])
        meta["summary"] = server.summary()
        rounds = 64
        t0 = time.perf_counter()
        for _ in range(rounds):
            timer.noop()
        meta["broadcast_ms"] = (time.perf_counter() - t0) / rounds * 1e3
        kk = max(ARCH["nprobe"], ARCH["k_impute"])
        meta["gathers_ms"] = timer.gathers(rounds, 1, qh.shape[1], kk, ARCH["k"]) * 1e3
        np.savez(out_path + ".npz", **arrays)
        with open(out_path + ".json", "w") as f:
            json.dump(meta, f)
    finally:
        group.stop()


def check_world(torch, label: str, n_ranks: int, got: dict, meta: dict, stack, lat,
                served, kernel_err: float, smi: str) -> dict:
    """Hold one world's results to the one-process stack's; returns each
    scoring kernel's per-rank launches over the retrieve loop."""
    n_q, n_b = got["materialize/dense/kernel/ids"].shape[0], got["materialize/dense/kernel/batch_ids"].shape[0]
    for info in meta["load"]:
        held, alloc = info["index_bytes"], info["allocated_bytes"]
        if not held <= alloc <= held + RANK_MEM_SLACK:
            fail(f"ranks {label}: rank {info['rank']} holds {alloc} bytes on {info['device']} after "
                 f"its load, its shard is {held} bytes (slack {RANK_MEM_SLACK})")
        log(f"[ranks] {label} rank {info['rank']}: shard loaded in {info['load_s']:.3f} s on "
            f"{info['device']}, index {held} bytes, {alloc} bytes allocated on its card; {meta['card']}")
    per_rank = {}
    for gather, layout in CONFIGS:
        for executor in ("kernel", "reference"):
            key = (gather, layout, executor)
            name = "/".join(key)
            kname = KERNEL_OF[(gather, layout)]
            want = n_q + n_b if executor == "kernel" else 0
            launches = meta[name]["launches"]
            for r, used in enumerate(launches):
                scoring = {k: v for k, v in used.items() if v}
                if used[kname] != want or sum(scoring.values()) != want:
                    fail(f"ranks {label} {name}: rank {r} launched {scoring} over {n_q} retrieves and "
                         f"{n_b} batches, expected {kname} once per retrieve ({want})")
                per_rank.setdefault(kname, [0] * n_ranks)[r] += used[kname]
            res, bres = stack[key]
            exact = swaps = 0
            for i in range(n_q):
                ids, scores = got[name + "/ids"][i], got[name + "/scores"][i]
                exact += int(np.array_equal(ids, res[i][0]) and np.array_equal(scores, res[i][1]))
                swaps += topk_swaps(f"ranks {label} {name} vs the stack, query {i}", ids, scores,
                                    *res[i], kernel_err)
            for b in range(n_b):
                for j in range(4):
                    ids, scores = got[name + "/batch_ids"][b][j], got[name + "/batch_scores"][b][j]
                    exact += int(np.array_equal(ids, bres[b][0][j])
                                 and np.array_equal(scores, bres[b][1][j]))
                    swaps += topk_swaps(f"ranks {label} {name} batch {b} vs the stack", ids, scores,
                                        bres[b][0][j], bres[b][1][j], kernel_err)
            log(f"[ranks] {label} {name}: {n_ranks} ranks = the stack on {n_q} queries and {n_b} "
                f"batches ({exact} of {n_q + 4 * n_b} bit for bit, {swaps} places swapped within a "
                f"tie); rank 0's per-query latency (ms) {json.dumps(meta[name]['lat'])} beside the "
                f"one-process stack's {json.dumps(lat[key])}; {kname} launches per rank "
                f"{[u[kname] for u in launches]}; {smi}")
    exact = swaps = 0
    for j, (ids, scores) in enumerate(served):
        gi, gs = got["serve/ids"][j], got["serve/scores"][j]
        exact += int(np.array_equal(gi, ids) and np.array_equal(gs, scores))
        swaps += topk_swaps(f"ranks {label} served reply {j} vs the stack's plan.retrieve",
                            gi, gs, ids, scores, kernel_err)
    log(f"[ranks] {label} rank 0's collectives alone, per retrieve: the command broadcast "
        f"{meta['broadcast_ms']:.4f} ms, the two all-gathers {meta['gathers_ms']:.4f} ms "
        f"(64 rounds each); {smi}")
    log(f"[ranks] {label} served from rank 0: a burst of {RANK_SERVE_BURST} in "
        f"{meta['burst_s'] * 1e3:.3f} ms, {RANK_SERVE_FILTERED} under a 50% allowlist, "
        f"{RANK_SERVE_FILTERED} after the deletes: {len(served)} replies equal the stack's "
        f"plan.retrieve ({exact} bit for bit, {swaps} places swapped within a tie); summary "
        f"{json.dumps(meta['summary'])}; {smi}")
    return per_rank


def phase_ranks(torch, index, sh: dict, seed: int, kernel_err: float, work: str) -> dict:
    """The sharded step's store with one process per shard
    (``repro_torch.launch.ranks``; the world body is ``rank_world``): a gloo
    world of SHARDS ranks sharing cuda:0, then an NCCL world of
    min(cards, SHARDS) ranks, one card each (on one card, a world of 1 over
    a 1-shard store cut from the same index). In each, the four configs x
    both executors single and batched, ids equal to the one-process
    stack's up to reported tie swaps and scores within TOL, exactly one
    scoring launch per rank per retrieve, each rank holding its shard's
    bytes on its card (within RANK_MEM_SLACK) and not the stack's, and a
    burst, a 50% allowlist and a 1% delete served from rank 0, every reply
    equal to the stack's ``plan.retrieve``; then ``launch.serve --ranks``.
    Returns ``{kernel: {world: launches per rank}}``."""
    from repro_torch.core import DocFilter, Retriever, shard_index
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch.ranks import run_world
    from repro_torch.store import save_index

    smi = card()
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    qh, mh = sh["queries"]
    nd = index.n_docs
    rng = np.random.default_rng(seed)
    allow = np.zeros(nd, bool)
    allow[rng.choice(nd, int(SHARD_ALLOW_FRAC * nd), replace=False)] = True
    deleted = rng.choice(nd, int(round(SHARD_DELETE_FRAC * nd)), replace=False)
    n_nccl = min(n_cards, SHARDS)
    stack = sh["stack"]
    worlds = [("gloo", SHARDS, sh["store"], sh["rs"], stack, sh["lat"])]  # all on cuda:0
    if n_nccl == SHARDS:
        worlds.append(("nccl", SHARDS, sh["store"], sh["rs"], stack, sh["lat"]))
    else:
        few = shard_index(index, n_nccl)
        store = save_index(few, os.path.join(work, f"sharded_{n_nccl}"))
        rs = Retriever.from_index(few, device="cuda")
        worlds.append(("nccl", n_nccl, store, rs, *stack_run(torch, rs, qh, mh, SHARD_BATCHES)))
        del few
    counts = {}
    main = arch_config("fused", "ragged")
    views = [None] * RANK_SERVE_BURST + [DocFilter.from_bitmap(allow)] * RANK_SERVE_FILTERED
    views += [DocFilter.tombstones(deleted.tolist(), nd)] * RANK_SERVE_FILTERED
    served_q = [j % SHARD_QUERIES for j in range(RANK_SERVE_BURST)]
    served_q += list(range(RANK_SERVE_FILTERED)) * 2
    for backend, n, store, rs, stack, lat in worlds:
        tag = f"{backend}{n}"
        device = "cuda:0" if backend == "gloo" else "cuda"
        label = f"{backend} ({n} ranks on {'cuda:0' if backend == 'gloo' else f'{n} card(s)'})"
        spec_path = os.path.join(work, f"ranks_{tag}_spec.npz")
        np.savez(spec_path, q=qh, qmask=mh, n_batches=SHARD_BATCHES, burst=RANK_SERVE_BURST,
                 filtered=RANK_SERVE_FILTERED, allow=allow, deleted=deleted)
        served = []
        for j, view in zip(served_q, views):
            want = rs.plan(main, dfilter=view).retrieve(qh[j], mh[j])
            served.append((want.doc_ids.cpu().numpy(), want.scores.cpu().numpy()))
        out = os.path.join(work, f"ranks_{tag}")
        t0 = time.perf_counter()
        run_world(rank_world, n, backend=backend, device=device, args=(store, spec_path, out),
                  join_timeout_s=RANK_JOIN_S)
        log(f"[ranks] {label}: world of {n} spawned, ran and exited in "
            f"{time.perf_counter() - t0:.3f} s; {smi}")
        with open(out + ".json") as f:
            meta = json.load(f)
        got = dict(np.load(out + ".npz"))
        for kname, per in check_world(torch, label, n, got, meta, stack, lat, served,
                                      kernel_err, smi).items():
            counts.setdefault(kname, {})[tag] = per
    # The serve launcher with one process per shard; its ranks inherit this
    # process's file descriptors, so fd 1 points at stderr meanwhile.
    backend = "nccl" if n_cards >= SHARDS else "gloo"
    t0 = time.perf_counter()
    sys.stdout.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = serve_cli.main(["--n-shards", str(SHARDS), "--ranks", "--backend", backend,
                                 "--queries", "16", "--layout", "ragged", "--gather", "fused",
                                 "--executor", "kernel"])
    finally:
        os.dup2(saved, 1)
        os.close(saved)
    if rc != 0:
        fail(f"ranks: launch.serve --n-shards {SHARDS} --ranks --backend {backend} exited {rc}")
    log(f"[ranks] launch.serve --n-shards {SHARDS} --ranks --backend {backend} on the card: "
        f"exit 0 in {time.perf_counter() - t0:.3f} s")
    log(f"[ranks] phase done in {time.perf_counter() - t_phase:.3f} s; launches per rank "
        f"{json.dumps(counts)}; {smi}")
    return counts


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


# The encoder_train phase: the XTR token encoder at EncoderConfig() (12
# layers, d 768, float32) trained with examples/train_encoder_torch.py's
# in-batch objective and AdamW (lr 3e-3 after 20 warmup steps), on batches
# drawn by its make_batch: ENC_BATCH queries of query_maxlen (32) tokens,
# each a noisy sub-sequence of its own document of ENC_DOC_LEN tokens
# (Lifestyle's documents hold 198.5 tokens on average), so 127 in-batch
# negatives per query. Then a corpus of ENC_CORPUS_DOCS such documents is
# encoded, indexed and searched by ENC_QUERIES of their sub-sequences, with
# the untrained and the trained encoder.
ENC_BATCH = 128
ENC_DOC_LEN = 192
ENC_STEPS = 10  # the loss must fall over them
ENC_CORPUS_DOCS = 4096
ENC_QUERIES = 128
ENC_ENCODE_CHUNK = 256  # documents per serving encode call
ENC_RETRIEVE_BATCH = 32  # queries per retrieve_batch call
ENC_CORPUS_SEED = 10_000  # make_batch's step for the corpus: no training batch's
ENC_EXAMPLE_TIMEOUT_S = 300


def load_example(name: str):
    """``examples/<name>.py`` as a module (examples/ is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def encoder_step_parts(torch, cfg, params, batch, dev, flush) -> dict:
    """Device ms of the parts of one encoder train step, each timed alone
    at the step's shapes: attention (``layers.chunked_attention`` forward +
    backward at the query and the document shape, times the layers), the
    FFN (``layers.swiglu`` likewise), the embedding's dense gradient (what
    autograd runs for the two ``embed[tokens]`` lookups: an ``index_put_``
    with accumulation into [vocab, d] zeros each, then their sum) and
    AdamW (one ``adamw_update`` of copies of every parameter)."""
    from repro_torch.models import layers as L
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update

    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    parts = {"attention": 0.0, "ffn": 0.0}
    for s in (cfg.query_maxlen, ENC_DOC_LEN):
        pos = torch.arange(s, device=dev).expand(ENC_BATCH, s)
        q, k, v = (torch.randn(ENC_BATCH, s, h, dh, device=dev, requires_grad=True)
                   for _ in range(3))
        go = torch.randn(ENC_BATCH, s, h, dh, device=dev)

        def attention():
            out = L.chunked_attention(q, k, v, causal=False, q_positions=pos, kv_positions=pos,
                                      chunk_size=s)
            torch.autograd.grad(out, (q, k, v), go)

        x = torch.randn(ENC_BATCH, s, cfg.d_model, device=dev, requires_grad=True)
        gx = torch.randn_like(x)
        ws = [params[f"layers.0.ffn.{n}.weight"].detach().clone().requires_grad_(True)
              for n in ("gate", "up", "down")]

        def ffn():
            y = L.swiglu(x, (ws[0], None), (ws[1], None), (ws[2], None))
            torch.autograd.grad(y, (x, *ws), gx)

        parts["attention"] += cfg.n_layers * time_cuda(torch, attention, flush, iters=5)
        parts["ffn"] += cfg.n_layers * time_cuda(torch, ffn, flush, iters=5)
        del q, k, v, go, x, gx, ws
    embed = params["embed"].detach()
    ids = [batch[k].reshape(-1).long() for k in ("q_tok", "d_tok")]
    gs = [torch.randn(i.numel(), cfg.d_model, device=dev) for i in ids]
    parts["embedding_grad"] = time_cuda(torch, lambda: sum(
        torch.zeros_like(embed).index_put_((i,), g, accumulate=True) for i, g in zip(ids, gs)
    ), flush, iters=5)
    copies = {k: p.detach().clone() for k, p in params.items()}
    grads = {k: torch.randn_like(p) for k, p in copies.items()}
    moments = adamw_init(copies)
    parts["adamw"] = time_cuda(torch, lambda: adamw_update(AdamWConfig(), copies, grads, moments),
                               flush, iters=5)
    return parts


def encoder_flops(cfg, n_params: int) -> float:
    """Float32 operations of one encoder train step (forward + backward):
    6 x the dense parameters (all but the embedding table, a lookup) x the
    tokens, attention's two [S, S] products per layer, and the in-batch
    MaxSim einsum."""
    dense = n_params - cfg.vocab * cfg.d_model
    q, d = cfg.query_maxlen, ENC_DOC_LEN
    tokens = ENC_BATCH * (q + d)
    attention = 3 * cfg.n_layers * ENC_BATCH * 4 * (q * q + d * d) * cfg.d_model
    maxsim = 3 * 2 * ENC_BATCH * ENC_BATCH * q * d * cfg.out_dim
    return 6.0 * dense * tokens + attention + maxsim


def resume_check(torch, phase: str, name: str, kw: dict, final: list, check) -> None:
    """``train_loop(**kw)`` with a checkpoint every TRAIN_RESUME_AT[0] steps
    dies at step TRAIN_RESUME_AT[1], resumes from its newest checkpoint and
    must end with every parameter and Adam moment of ``final`` (the
    uninterrupted run's ``flatten(state)``) bit for bit."""
    from repro_torch.train import FailureInjector, latest_step, train_loop
    from repro_torch.train.checkpoint import flatten

    every, dies = TRAIN_RESUME_AT
    ckdir = tempfile.mkdtemp(prefix="resume_")
    kw = dict(kw, ckpt_dir=ckdir, ckpt_every=every, keep=2)
    t0 = time.perf_counter()
    try:
        try:
            train_loop(failure=FailureInjector(fail_at=(dies,)), **kw)
            check(False, f"{name}: the injected failure at step {dies} did not fire")
        except RuntimeError as e:
            if "injected failure" not in str(e):
                raise
        check(latest_step(ckdir) == every, f"{name}: newest committed step {latest_step(ckdir)}, "
                                           f"not {every}")
        torch.cuda.empty_cache()
        resumed, _ = train_loop(**kw)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    diffs = {k: float((v.detach().cpu() - want).abs().max())
             for (k, v), (_, want) in zip(flatten(resumed), final)}
    worst = max(diffs, key=diffs.get)
    check(diffs[worst] == 0, f"{name}: the run resumed from step {every} ends {diffs[worst]} "
                             f"from the uninterrupted run at {worst}")
    log(f"[{phase}] {name}: train_loop died at step {dies}, resumed from its step-{every} "
        f"checkpoint and ended at step {kw['n_steps']} with every parameter and Adam moment "
        f"{'bit for bit' if diffs[worst] == 0 else 'apart'} (largest diff {diffs[worst]} at "
        f"{worst}); {time.perf_counter() - t0:.1f} s with checkpoint writes")


def encoder_end_to_end(torch, dev, cfg, corpus: dict, encoders: dict, kernel_err: float,
                       check) -> dict:
    """For each of ``encoders`` (tag -> a function giving its parameters,
    untrained first): the corpus's documents and its first ENC_QUERIES
    queries encoded (query i's document is doc i), an index built by
    ``Retriever.build`` on the card, the queries retrieved in batches of
    ENC_RETRIEVE_BATCH at the three scoring kernels' configs, kernel and
    reference executor: doc ids equal up to reported tie swaps, scores
    within TOL, each kernel launched, the reference launching none;
    success@5 printed, and the last encoder's no lower than the first's.
    Returns the launch counts of the run."""
    from repro_torch.core import IndexBuildConfig, Retriever, WarpSearchConfig
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import TokenEncoder

    d_tok, q_tok = corpus["d_tok"], corpus["q_tok"][:ENC_QUERIES]
    n_docs = d_tok.shape[0]
    d_mask = torch.ones(ENC_ENCODE_CHUNK, ENC_DOC_LEN, dtype=torch.bool, device=dev)
    qmask = torch.ones(ENC_QUERIES, cfg.query_maxlen, dtype=torch.bool, device=dev)
    doc_ids = torch.arange(n_docs, dtype=torch.int32, device=dev).repeat_interleave(ENC_DOC_LEN)
    base = dict(nprobe=ARCH["nprobe"], k=ARCH["k"], k_impute=ARCH["k_impute"])
    success, swaps = {}, 0
    reset_launches()  # the end-to-end path starts here
    for tag, params in encoders.items():
        model = TokenEncoder.from_params(cfg, params())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb = torch.cat([model.encode(d_tok[lo: lo + ENC_ENCODE_CHUNK], d_mask)
                         for lo in range(0, n_docs, ENC_ENCODE_CHUNK)])
        q = model.encode(q_tok, qmask)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        retriever = Retriever.build(emb.reshape(-1, cfg.out_dim), doc_ids, n_docs,
                                    IndexBuildConfig(nbits=ARCH["nbits"]), device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0 - t_enc
        del emb, model
        res = {}
        for gather, layout in CONFIGS[:3]:
            for executor in ("kernel", "reference"):
                plan = retriever.plan(WarpSearchConfig(gather=gather, layout=layout,
                                                       executor=executor, **base))
                before = dict(LAUNCHES)
                out = [plan.retrieve_batch(q[lo: lo + ENC_RETRIEVE_BATCH],
                                           qmask[lo: lo + ENC_RETRIEVE_BATCH])
                       for lo in range(0, ENC_QUERIES, ENC_RETRIEVE_BATCH)]
                used = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                kname = KERNEL_OF[(gather, layout)]
                if executor == "kernel":
                    check(used[kname] > 0, f"{tag} {gather}/{layout}: {kname} never launched")
                else:
                    check(not any(used.values()), f"{tag} {gather}/{layout}/reference launched "
                                                  f"{used}")
                res[(gather, layout, executor)] = (
                    np.concatenate([r.doc_ids.cpu().numpy() for r in out]),
                    np.concatenate([r.scores.cpu().numpy() for r in out]))
        for gather, layout in CONFIGS[:3]:
            ki, ks = res[(gather, layout, "kernel")]
            ri, rs = res[(gather, layout, "reference")]
            for i in range(ENC_QUERIES):
                swaps += topk_swaps(f"encoder_train {tag} {gather}/{layout} kernel vs reference, "
                                    f"query {i}", ki[i], ks[i], ri[i], rs[i], kernel_err)
        success[tag] = {"/".join(key): float(np.mean([i in ids[i, :5] for i in range(ENC_QUERIES)]))
                        for key, (ids, _) in res.items()}
        log(f"[encoder_train] {tag} encoder: {n_docs} documents of {ENC_DOC_LEN} tokens and "
            f"{ENC_QUERIES} queries encoded in {t_enc:.3f} s "
            f"({(n_docs * ENC_DOC_LEN + ENC_QUERIES * cfg.query_maxlen) / t_enc:.1f} tokens/s), "
            f"indexed by Retriever.build in {t_build:.3f} s ({retriever.index.n_centroids} "
            f"centroids); success@5 {json.dumps(success[tag])}")
        del retriever, q, res
    counts = dict(LAUNCHES)  # read right after the end-to-end path's run
    first, last = (success[t] for t in (next(iter(encoders)), list(encoders)[-1]))
    lower = {k: (first[k], v) for k, v in last.items() if v < first[k]}
    check(not lower, f"success@5 fell with training: {lower}")
    log(f"[encoder_train] end to end: kernel and reference doc ids equal up to {swaps} tie swaps "
        f"over {ENC_QUERIES} queries x 3 configs x {len(encoders)} encoders; launches "
        f"{json.dumps(counts)}; success@5 {' -> '.join(encoders)} "
        + ", ".join(f"{k} {first[k]:.4f} -> {v:.4f}" for k, v in last.items()))
    return counts


def phase_encoder_train(torch, dev, seed: int, kernel_err: float, flush) -> dict:
    """The XTR token encoder trained on the card at ``EncoderConfig()``
    with ``examples/train_encoder_torch.py``'s ``xtr_inbatch_loss`` and
    AdamW, on its ``make_batch`` batches at ENC_BATCH x (32 + ENC_DOC_LEN)
    tokens (see ENC_BATCH): the step-1 loss equals the no-grad loss within
    TRAIN_LOSS_TOL; every parameter gets a finite gradient, none all zero,
    the embedding's non-zero on exactly the rows the batch names; two
    step-1 gradient computations bit for bit; the loss falls over
    ENC_STEPS steps (step p50, tokens/s, FLOP rate, peak memory and the
    parts of a step printed); a ``train_loop`` that dies at step 7 resumes
    from its step-5 checkpoint and ends bit for bit where the uninterrupted
    run ended. Then ENC_CORPUS_DOCS documents are encoded with the
    untrained and the trained encoder, each indexed on the card by
    ``Retriever.build`` and searched by ENC_QUERIES sub-sequence queries at
    (materialize, dense), (fused, dense) and (fused, ragged) through
    ``retrieve_batch`` at both executors: kernel and reference doc ids
    equal up to reported tie swaps, scores within TOL, each scoring kernel
    launched, the reference executor launching none, success@5 after
    training no lower than before. ``python examples/train_encoder_torch.py``
    runs at its defaults on the card beside the resume and must exit 0.
    Returns the scoring kernels' launches in the end-to-end run."""
    from repro_torch.configs.families import encoder_loss_fn
    from repro_torch.models import EncoderConfig, init_params
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.checkpoint import flatten

    t_phase = time.perf_counter()
    ex = load_example("train_encoder_torch")
    cfg = EncoderConfig()
    smi = card()
    failures = []

    def check(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            log(f"[encoder_train] FAILED: {msg}")

    def draw(step: int, batch: int) -> dict:
        b = ex.make_batch(step, cfg=cfg, doc_len=ENC_DOC_LEN, q_len=cfg.query_maxlen, batch=batch)
        return {k: v.to(dev) for k, v in b.items()}

    def fresh():
        return init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)

    batches = [draw(s, ENC_BATCH) for s in range(ENC_STEPS)]
    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=ENC_STEPS)  # the example's
    state = TrainState.create(fresh())
    names = list(state.params)
    n = sum(p.numel() for p in state.params.values())
    loss_fn = encoder_loss_fn(cfg, ex.xtr_inbatch_loss)
    b0 = batches[0]
    with torch.no_grad():
        nograd = float(loss_fn(state.params, b0)[0])
    grads = []
    for _ in range(2):
        loss, _ = loss_fn(state.params, b0)
        grads.append(torch.autograd.grad(loss, list(state.params.values())))
        del loss
    apart = [k for k, a, b in zip(names, *grads) if not torch.equal(a, b)]
    check(not apart, f"two step-1 gradient computations differ at {apart}")
    zero = [k for k, g in zip(names, grads[0]) if not bool(g.any())]
    bad = [k for k, g in zip(names, grads[0]) if not bool(torch.isfinite(g).all())]
    check(not zero and not bad, f"parameters with an all-zero gradient {zero}, non-finite {bad}")
    rows = grads[0][names.index("embed")].abs().sum(-1) > 0
    named = torch.zeros(cfg.vocab, dtype=torch.bool, device=dev)
    for tok, mask in (("q_tok", "q_mask"), ("d_tok", "d_mask")):
        named[b0[tok][b0[mask] > 0].long()] = True
    stray, missing = int((rows & ~named).sum()), int((named & ~rows).sum())
    check(stray == 0 and missing == 0, f"the embedding's gradient is non-zero on {stray} rows "
                                       f"the batch does not name and zero on {missing} it names")
    del grads
    log(f"[encoder_train] TokenEncoder {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}, out {cfg.out_dim}: {n} float32 parameters "
        f"({16 * n / 1e9:.2f} GB with gradients, m and v); batch {ENC_BATCH} queries of "
        f"{cfg.query_maxlen} tokens and their documents of {ENC_DOC_LEN}; autograd took a "
        f"gradient for all {len(names)} parameter tensors, none all zero or non-finite; the "
        f"embedding's on the {int(named.sum())} rows the batch names and no other; two step-1 "
        f"gradient computations {'bit for bit' if not apart else 'apart'}")

    step = make_train_step(loss_fn, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, metrics = [], [], []
    for s in range(ENC_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batches[s])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        losses.append(metrics[-1]["loss"])
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.median(times[1:]))
    rel = abs(losses[0] - nograd) / abs(nograd)
    check(rel <= TRAIN_LOSS_TOL, f"step-1 loss {losses[0]} vs the no-grad loss {nograd}: {rel} "
                                 f"relative > {TRAIN_LOSS_TOL}")
    check(losses[-1] < losses[0], f"the loss did not fall over {ENC_STEPS} steps: {losses}")
    tokens = ENC_BATCH * (cfg.query_maxlen + ENC_DOC_LEN)
    flops = encoder_flops(cfg, n)
    parts = encoder_step_parts(torch, cfg, state.params, b0, dev, flush)
    log(f"[encoder_train] step-1 loss {losses[0]} (no-grad {nograd}, {rel} relative; limit "
        f"{TRAIN_LOSS_TOL}); losses over {ENC_STEPS} steps at lr {opt.lr} after "
        f"{opt.warmup_steps} warmup steps {json.dumps(losses)}; step 1 {json.dumps(metrics[0])}; "
        f"step p50 {p50 * 1e3:.3f} ms (first {times[0] * 1e3:.1f} ms), {tokens / p50:.1f} "
        f"tokens/s, {flops / 1e12:.4f} TFLOP a step, {flops / p50 / 1e12:.3f} TFLOP/s (float32 "
        f"bound {flops / F32_OPS_PER_S * 1e3:.3f} ms); peak memory {peak / 2**30:.2f} GiB; parts "
        f"timed alone (ms, share of the step p50): "
        + ", ".join(f"{k} {v:.3f} ({v / (p50 * 1e3):.3f})" for k, v in parts.items())
        + f"; {smi}")

    final = [(k, v.detach().cpu()) for k, v in flatten(state)]
    trained = {k: p.detach() for k, p in state.params.items()}
    del state, step, loss_fn
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t_ex = time.perf_counter()
    proc = subprocess.Popen([sys.executable, os.path.join(ROOT, "examples", "train_encoder_torch.py")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        resume_check(torch, "encoder_train", "TokenEncoder", dict(
            init_params_fn=fresh, loss_fn=encoder_loss_fn(cfg, ex.xtr_inbatch_loss),
            batch_iter=lambda s: batches[s], opt_cfg=opt, n_steps=ENC_STEPS, log_every=ENC_STEPS,
            log_fn=log, device=dev), final, check)
        del final, batches
        torch.cuda.empty_cache()
        corpus = draw(ENC_CORPUS_SEED + seed, ENC_CORPUS_DOCS)
        counts = encoder_end_to_end(torch, dev, cfg, corpus, {"untrained": fresh, "trained":
                                    lambda: trained}, kernel_err, check)
        del trained, corpus
        torch.cuda.empty_cache()
        out, err = proc.communicate(timeout=ENC_EXAMPLE_TIMEOUT_S)
    finally:
        proc.kill()
    lines = out.strip().splitlines()
    check(proc.returncode == 0 and any("trained encoder success@5" in x for x in lines),
          f"examples/train_encoder_torch.py exited {proc.returncode}: {out[-2000:]} {err[-2000:]}")
    log(f"[encoder_train] python examples/train_encoder_torch.py (its defaults, on the card): exit "
        f"{proc.returncode} after {time.perf_counter() - t_ex:.1f} s; "
        + " | ".join(x for x in lines if "success@5" in x))
    log(f"[encoder_train] phase took {time.perf_counter() - t_phase:.1f} s; {smi}")
    if failures:
        fail("encoder_train: " + "; ".join(failures))
    return {k: counts[k] for k in ("selective_sum", "fused_gather_score", "ragged_fused_gather_score")}


# The dry-run phase's time budget (the whole script must end in 1200 s).
DRYRUN_BUDGET_S = 90.0
DRYRUN_QUERIES = 16


# The dry-run phase's cells: warp-xtr's Lifestyle search, and for the LM,
# recsys and GNN families the cell of the fewest reckoned bytes (state and
# inputs) that runs whole on one card (qwen2's train_4k reckons fewer, but
# its activations at batch 256 do not fit).
DRYRUN_CELLS = (
    ("warp-xtr", "search_lifestyle"), ("qwen2-0.5b", "long_500k"), ("din", "serve_p99"),
    ("gin-tu", "molecule"),
)


def phase_dryrun(torch, index, dev, seed: int, kernel_err: float) -> None:
    """``launch/dryrun.py::run_cell`` on ``DRYRUN_CELLS`` at full width,
    each checked: whole (no cut); ``model_flops`` equal to
    ``roofline.model_flops``; each
    kernel's launches in the counted step (``_build.LAUNCHES``) equal to
    its calls the counter saw, and its counted work equal to the sum of
    its ``work(...)`` over those calls; the warp and recsys cells launch a
    kernel; 0 < mfu <= 1.05; the peak below the card's memory. Then the
    warp cell's ``step_fn`` at its ``search_config`` on this index (the
    cell's own, drawn from the same seed) against ``plan.retrieve`` at the
    reference executor over ``DRYRUN_QUERIES`` queries: doc ids equal up
    to reported tie swaps, scores within TOL. At most ``DRYRUN_BUDGET_S``."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import Retriever
    from repro_torch.launch import dryrun, roofline

    t0 = time.perf_counter()
    total = torch.cuda.get_device_properties(dev).total_memory
    for name, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(name, shape, device=dev, seed=seed, verbose=False)
        what = f"dryrun {name}/{shape}"
        if not rec["ok"] or rec["model_flops"] != roofline.model_flops(get_arch(name), shape):
            fail(f"{what}: ok {rec['ok']}, model_flops {rec['model_flops']}")
        if rec["reduced"]:
            fail(f"{what}: cut ({'; '.join(rec['reduced'])}), where it runs whole")
        for kname, k in rec["kernels"].items():
            works = [dryrun.resolve_work(w)(**sh) for n, w, sh in rec["kernel_calls"] if n == kname]
            summed = tuple(float(sum(x)) for x in zip(*works)) if works else (0.0, 0.0)
            if not k["launches"] == k["calls"] == len(works) or summed != (k["flops"], k["bytes"]):
                fail(f"{what}: {kname} launched {k['launches']} times, counted {k['calls']} "
                     f"calls of work {(k['flops'], k['bytes'])} against {summed} over its calls")
        if name in ("warp-xtr", "din") and not any(
                k["launches"] for k in rec["kernels"].values()):
            fail(f"{what}: the step launched no hand-written kernel")
        m = rec["measured"]
        if not (0 < m["mfu"] <= 1.05 and 0 < m["peak_bytes"] < total):
            fail(f"{what}: mfu {m['mfu']}, peak {m['peak_bytes']} of {total} bytes")
        log(f"[dryrun] {name}/{shape}: " + json.dumps({
            "reduced": rec["reduced"], "p50_ms": m["p50_ms"], "peak_bytes": m["peak_bytes"],
            "mfu": m["mfu"], "bottleneck": rec["roofline"]["bottleneck"],
            "bound_ms": rec["roofline"]["step_lower_bound_s"] * 1e3,
            "kernels": {k: v["launches"] for k, v in rec["kernels"].items()},
            "model_flops": rec["model_flops"], "reckoned": rec["reckoned"],
        }))
    arch = get_arch("warp-xtr")
    retriever = Retriever.from_index(index, device=dev)
    cfg = arch.family.search_config(arch, "search_lifestyle")
    plan = retriever.plan(cfg)
    ref_plan = retriever.plan(dataclasses.replace(cfg, executor="reference"))
    if plan.config.executor != "kernel":
        fail(f"dryrun: the warp cell's plan resolved executor {plan.config.executor!r} on the card")
    step = arch.family.step_fn(arch, "search_lifestyle")
    queries, qmask = make_queries(torch, index, DRYRUN_QUERIES, seed + 1)
    swaps = 0
    for i in range(DRYRUN_QUERIES):
        got = step(plan, {"q": queries[i], "qmask": qmask[i]})
        want = ref_plan.retrieve(queries[i], qmask[i])
        swaps += topk_swaps(f"dryrun warp step {i}", got.doc_ids.cpu(), got.scores.cpu(),
                            want.doc_ids.cpu(), want.scores.cpu(), kernel_err)
    elapsed = time.perf_counter() - t0
    log(f"[dryrun] warp-xtr step_fn at {plan.config.gather}/{plan.config.layout} vs the reference "
        f"executor over {DRYRUN_QUERIES} queries: {swaps} tie swaps; phase {elapsed:.1f}s; {card()}")
    if elapsed > DRYRUN_BUDGET_S:
        fail(f"dryrun: the phase took {elapsed:.1f}s, over its {DRYRUN_BUDGET_S:.0f}s budget")


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
    from repro_torch.kernels.flash_attention import flash_attention_cuda, work

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
        ops_, nbytes = work(b=b, h=h, hkv=hkv, sq=s, skv=s, dh=dh, itemsize=2, window=window)
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
                zoo[name] = {
                    "shape": [b, h, hkv, s, dh], "window": window, "ms": t["ms"],
                    "plain_ms": time_cuda(torch, lambda: ref.flash_attention(
                        q, k, v, causal=True, window=window), flush, iters=3),
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
    ops_, nbytes = work(b=b, h=h, hkv=k.shape[1], sq=s, skv=s, dh=dh, itemsize=2)
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
    serve_p99, and the path's own narrow inputs: DIN's history at 65,536
    rows, its prefix mask times attention weights in [-1, 1) so that 0.0
    and -0.0 occur, and xDeepFM's linear term at serve_bulk), with int32
    and int64 ids, zero weights of both signs (which must give exactly 0),
    ids outside [0, V) (which must give exactly the in-range-only sum), a
    table view whose rows are not on 16 bytes, and a NaN row (under weight
    0.0 or -0.0 it adds nothing, under a nonzero weight it makes that bag
    NaN); then two planted faults the limit must reject (on the user
    tower's shape with weights in [0, 1), since the path's 0/1 mask hides
    a squared weight), and the kernel timed at the user tower's serve_bulk
    shape beside its plain version and ``F.embedding_bag``, at serve_p99,
    and at xDeepFM's linear term at serve_bulk (row 5-xDeepFM,
    ``xdeepfm_linear``). Returns the kernels row."""
    from repro_torch.configs import RECSYS_SHAPES, RecsysShape
    from repro_torch.configs.din import CONFIG as DIN
    from repro_torch.configs.two_tower_retrieval import CONFIG as TT
    from repro_torch.configs.xdeepfm import CONFIG as XD
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, work

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
    # The path's own narrow inputs: DIN's history (S 65,536) and xDeepFM's
    # linear term at serve_bulk (int32 ids, weights 1).
    hist = recsys_batch(torch, DIN, RecsysShape("train", DIN_HISTORY_ROWS), g, dev)
    din_w = hist["hist_mask"] * (torch.rand(hist["hist_mask"].shape, generator=g, device=dev) * 2 - 1)
    cases["din history (path's ids, mask x attention weights)"] = (din_table, hist["hist_ids"], din_w)
    xd = recsys_batch(torch, XD, RECSYS_SHAPES["serve_bulk"], g, dev)["field_ids"].int()
    cases["xdeepfm linear serve_bulk (path's ids)"] = (xdeepfm_linear, xd, torch.ones(xd.shape, device=dev))
    for what, (table, idx, w) in cases.items():
        checks[what] = bag_check(torch, what, table, idx, w)
    for zero in (0.0, -0.0):
        for table, idx, w in (cases["zero weights"], cases["din history (path's ids, mask x attention weights)"]):
            out = embedding_bag_cuda(table, idx, torch.full_like(w, zero))
            if bool(out.any()) or bool(torch.signbit(out).any()):
                fail(f"embedding_bag: weights all {zero} did not give exactly +0.0")
    _, fidx, fw = cases["user tower serve_bulk int32"]
    _, xidx, xw = cases["xdeepfm linear serve_bulk (path's ids)"]
    del wide, cases

    # A NaN row of (a copy of) DIN's table, named by bag 0 under 0.0, bag
    # 1 under -0.0 and bag 2 under 0.5, by no other slot.
    nan_row = 12_345
    idx = torch.randint(0, din_table.shape[0], (p99, 100), generator=g, device=dev)
    idx = torch.where(idx == nan_row, nan_row + 1, idx)
    w = torch.rand(p99, 100, generator=g, device=dev)
    for bag, wt in ((0, 0.0), (1, -0.0), (2, 0.5)):
        idx[bag, 50], w[bag, 50] = nan_row, wt
    poisoned = din_table.clone()
    poisoned[nan_row] = float("nan")
    got, finite = embedding_bag_cuda(poisoned, idx, w), embedding_bag_cuda(din_table, idx, w)
    rest = torch.arange(p99, device=dev) != 2
    if not (bool(torch.isnan(got[2]).all()) and torch.equal(got[rest], finite[rest])):
        fail("embedding_bag: a NaN row under weight 0.0 / -0.0 did not add exactly nothing, or "
             "under weight 0.5 did not make its bag NaN")
    del poisoned, got, finite

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
    p99_in = recsys_batch(torch, TT, RECSYS_SHAPES["serve_p99"], g, dev)
    p99_ms = time_cuda(torch, lambda: embedding_bag_cuda(user, p99_in["user_ids"], p99_in["user_mask"]),
                       flush)
    ms = time_cuda(torch, lambda: embedding_bag_cuda(user, uidx, uw), flush)
    plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags(user, uidx, uw), flush, iters=5)
    library_ms = time_cuda(torch, lambda: lib(uidx, user, per_sample_weights=uw, mode="sum"), flush)
    needed = int((uw != 0).sum())  # rows a sum of the nonzero terms reads
    ops_, nbytes = work(s=s, l=l, d=d, needed=needed, index_bytes=uidx.element_size())
    all_rows = work(s=s, l=l, d=d, needed=s * l, index_bytes=uidx.element_size())[1]
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
        "serve_p99_ms": p99_ms,
    }
    # Row 5-xDeepFM: the linear term at serve_bulk (measured only; its
    # launches are xDeepFM's training forward's, filled in by the caller).
    xs, xl = xidx.shape
    x_ops, x_bytes = work(s=xs, l=xl, d=1, needed=xs * xl, index_bytes=xidx.element_size())
    x_t = (x_bytes / HBM_BYTES_PER_S, x_ops / F32_OPS_PER_S)
    row["xdeepfm_linear"] = {
        "shape": [xs, xl, 1, xdeepfm_linear.shape[0]],
        "ms": time_cuda(torch, lambda: embedding_bag_cuda(xdeepfm_linear, xidx, xw), flush),
        "plain_ms": time_cuda(torch, lambda: ref.embedding_bag_bags(xdeepfm_linear, xidx, xw), flush,
                              iters=5),
        "library_ms": time_cuda(torch, lambda: lib(xidx, xdeepfm_linear, per_sample_weights=xw,
                                                   mode="sum"), flush),
        "bound_ms": max(x_t) * 1e3, "bound_by": "bytes" if x_t[0] >= x_t[1] else "operations",
        "max_abs_err": checks["xdeepfm linear serve_bulk (path's ids)"]["max_abs_err"], "launches": 0,
    }
    del xidx, xw
    log(
        f"[bag] timed at the user tower's serve_bulk input: S={s} L={l} D={d} V={user.shape[0]} "
        f"int64 ids, {needed} of {s * l} weights nonzero (the mask); every row read: "
        f"{all_rows} bytes, {all_rows / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 TB/s; at serve_p99 "
        f"(S={p99}) {p99_ms:.5f} ms; xDeepFM's linear term at serve_bulk (row 5-xDeepFM, S={xs} "
        f"L={xl} D=1 V={xdeepfm_linear.shape[0]} int32 ids) {row['xdeepfm_linear']['ms']:.5f} ms; "
        f"F.embedding_bag vs plain max abs err {lib_err}; {card()}; {json.dumps(row)}"
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


TRAIN_LAUNCHER_ARCHS = ("qwen2-0.5b", "din", "gin-tu")


def train_launcher(torch, out_dir: str) -> None:
    """``repro_torch.launch.train`` on the card for each of
    ``TRAIN_LAUNCHER_ARCHS`` (their reduced configs), one process per arch
    side by side: 4 steps with a checkpoint every 2, then a rerun to 6 that
    resumes; every printed loss finite."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for steps, expect in (("4", "done"), ("6", "[resume] step 4")):
        t0 = time.perf_counter()
        procs = {
            arch: subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--ckpt-dir",
                 os.path.join(out_dir, arch), "--ckpt-every", "2", "--steps", steps],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
            for arch in TRAIN_LAUNCHER_ARCHS
        }
        for arch, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            losses = [float(x.split("loss=")[1]) for x in out.splitlines() if "loss=" in x]
            if proc.returncode != 0 or expect not in out or not np.all(np.isfinite(losses)):
                fail(f"train: launch.train --arch {arch} --steps {steps} exited {proc.returncode}: "
                     f"{out[-2000:]} {err[-2000:]}")
            log(f"[train] launch.train --arch {arch} --steps {steps} on the card: exit 0, losses "
                f"{losses}; {out.strip().splitlines()[-1]}")
        log(f"[train] the launcher runs at --steps {steps} took {time.perf_counter() - t0:.1f} s")


def phase_train(torch, dev, seed: int, flush) -> dict:
    """LM training on the card (``TRAIN_RUNS``): for each, the no-grad loss
    against the step-1 loss, a gradient for every parameter tensor (none
    all zero or non-finite), ``TRAIN_STEPS`` timed steps on one repeated
    batch (the loss must fall; tokens/s, step p50, peak memory, the share
    of attention), and one step at the other microbatch count; for qwen2
    also a run through ``train_loop`` that dies at step 7, resumes from
    its step-5 checkpoint and must end bit for bit where the uninterrupted
    run ended; then recsys training (``phase_recsys_train``: the bag
    backward's kernels and the four models), gin-tu at its four shapes
    (``phase_gnn``) and the train launcher. Every measurement is printed
    before any failed check raises. Returns the bag backward's kernels
    row."""
    from repro_torch.configs.families import lm_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import ShardedBatcher, synthetic_lm_fetch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
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
                resume_check(torch, "train", arch, dict(
                    init_params_fn=fresh, loss_fn=lm_loss_fn(cfg), batch_iter=lambda _: batch,
                    opt_cfg=opt, n_steps=TRAIN_STEPS, log_every=TRAIN_STEPS, log_fn=log,
                    device=dev), final, check)
                del final
                torch.cuda.empty_cache()
            del batch, halves
            torch.cuda.empty_cache()
            log(f"[train] {arch} done in {time.perf_counter() - t_arch:.1f}s")
        row = phase_recsys_train(torch, dev, seed + 20, flush, check)
        torch.cuda.empty_cache()
        phase_gnn(torch, dev, seed + 40, flush, check)
        torch.cuda.empty_cache()
        train_launcher(torch, os.path.join(tmp, "launcher"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failures:
        fail("train: " + "; ".join(failures))
    return row


# ---------------------------------------------------------------------------
# recsys and GNN training (the train phase's recsys_train and gnn steps)
# ---------------------------------------------------------------------------


def recsys_train_batch(torch, cfg, b: int, g, dev) -> dict:
    """The train_batch inputs ``RecsysFamily.input_specs`` names for ``cfg``
    at ``b`` rows, on the card: ``recsys_batch``'s ids and masks, log_q
    standard normal, SASRec's positive and negative ids uniform, labels
    0/1."""
    from repro_torch.configs import RecsysShape
    from repro_torch.models import SASRecConfig, TwoTowerConfig

    batch = recsys_batch(torch, cfg, RecsysShape("train", b), g, dev)
    if isinstance(cfg, TwoTowerConfig):
        batch["log_q"] = torch.randn(b, generator=g, device=dev)
    elif isinstance(cfg, SASRecConfig):
        del batch["target_ids"]
        for k in ("pos_ids", "neg_ids"):
            batch[k] = torch.randint(0, cfg.item_vocab, (b, cfg.seq_len), generator=g, device=dev)
    else:
        batch["labels"] = torch.randint(0, 2, (b,), generator=g, device=dev).float()
    return batch


# The table parameters of each recsys model and the batch inputs naming their rows.
TABLE_IDS = {
    "TwoTowerConfig": {"user_table": ("user_ids",), "item_table": ("item_ids",)},
    "SASRecConfig": {"item_table": ("seq_ids", "pos_ids", "neg_ids")},
    "XDeepFMConfig": {"table": ("field_ids",), "linear": ("field_ids",)},
    "DINConfig": {"table": ("target_ids", "hist_ids")},
}
# Bag kernel launches per (micro)batch of a kernel-executor train step:
# (forward, backward). Two-tower: one bag per tower, the table's gradient
# each; DIN: the interest bag, the table's and the weights' gradients;
# xDeepFM: the linear term's bag and its table's gradient; SASRec: none.
BAG_LAUNCHES = {"TwoTowerConfig": (2, 2), "DINConfig": (1, 2), "XDeepFMConfig": (1, 1),
                "SASRecConfig": (0, 0)}


def bag_backward_check(torch, what, table, idx, w, g, weights_grad: bool) -> dict:
    """The bag backward's kernels against their plain version on the same
    inputs, per element within ``ref.embedding_bag_backward_error_bound``,
    and two calls bit-identical; returns each gradient's max abs err and
    the largest share of its limit an element used."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda

    got = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=weights_grad)
    again = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=weights_grad)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
    del again
    if not same:
        fail(f"embedding_bag backward {what}: two calls are not bit-identical")
    want = ref.embedding_bag_bags_backward(table, idx, w, g, weights_grad=weights_grad)
    limits = ref.embedding_bag_backward_error_bound(table, idx, w, g)
    out = {}
    for name, a, b, lim in zip(("table", "weights"), got, want, limits):
        if a is None:
            continue
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            fail(f"embedding_bag backward {what}: d{name} {tuple(a.shape)} not finite of shape "
                 f"{tuple(b.shape)}")
        diff = (a - b).abs_()
        excess = float((diff - lim).max())
        if not excess <= 0:
            fail(f"embedding_bag backward {what}: a d{name} element differs from the plain "
                 f"version by {excess} beyond its limit")
        out[f"d{name}_max_abs_err"] = float(diff.max())
        out[f"d{name}_share_of_limit"] = float((diff / lim).max())
        del diff
    if weights_grad:
        valid = (idx >= 0) & (idx < table.shape[0])
        if bool(got[1][~valid].any()):
            fail(f"embedding_bag backward {what}: dw is not 0 at an id outside [0, V)")
    return out


def bag_prep_check(torch, what, table, idx, w, g) -> dict:
    """The table entry's index preparation, returned through the wrapper's
    scratch, against its plain twins exactly: the sorted keys and positions
    (``ref.bag_sort``), the row offsets and each row's positions
    (``ref.bag_csr``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda

    scratch = {}
    embedding_bag_backward_cuda(table, idx, w, g, scratch=scratch)
    key, pos = ref.bag_sort(idx, table.shape[0])
    offsets, positions = ref.bag_csr(idx, table.shape[0])
    got = {k: scratch[k].long() for k in ("keys", "positions", "offsets")}
    torch.cuda.synchronize()
    same = (torch.equal(got["keys"], key) and torch.equal(got["positions"], pos)
            and torch.equal(got["offsets"], offsets)
            and torch.equal(got["positions"][: positions.numel()], positions))
    if not same:
        fail(f"embedding_bag backward {what}: the entry's sort or row offsets differ from "
             "ref.bag_sort / ref.bag_csr")
    return {"ids": idx.numel(), "in_range": positions.numel(),
            "rows_named": int((offsets[1:] > offsets[:-1]).sum()),
            "largest_row": int((offsets[1:] - offsets[:-1]).max()),
            "index_bits": str(scratch["keys"].dtype).replace("torch.", "")}


def phase_bag_backward(torch, dev, tables: dict, flush) -> dict:
    """The bag backward's kernels against their plain version at the
    training path's shapes (the two-tower user tower at its train batch,
    DIN's history with the weights' gradient, xDeepFM's linear term at D
    1), with int32 and int64 ids, duplicate ids within a bag, zero weights,
    ids outside [0, V) and one row named 100,000 times; the table entry's
    sort and row offsets against ``ref.bag_sort`` / ``ref.bag_csr``
    exactly; two planted faults (each row's last contribution dropped; dw
    written one slot off) the limits must reject; the table's gradient
    timed at the user tower's shape beside its plain version and
    ``F.embedding_bag``'s autograd, at DIN's history per gradient and both
    (row 5b-DIN) and at xDeepFM's linear term (row 5b-xDeepFM), and the
    forward kernel at DIN's history (row 5-DIN, ``din_forward``: the
    caller moves it to the forward kernel's row) and at serve_p99. Returns
    the kernels row (launches filled in by the caller)."""
    from repro_torch.configs import RECSYS_SHAPES, RecsysShape
    from repro_torch.configs.din import CONFIG as DIN
    from repro_torch.configs.two_tower_retrieval import CONFIG as TT
    from repro_torch.configs.xdeepfm import CONFIG as XD
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward_cuda,
        embedding_bag_cuda,
        grad_table_work,
        grad_weights_work,
        work,
    )

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    user, din_table, linear = tables["user_table"], tables["din"], tables["linear"]
    b_tt, b = RECSYS_TRAIN[0][1], RECSYS_TRAIN[2][1]

    def bags(table, s, l, dtype, bad=0.05):
        v = table.shape[0]
        idx = torch.randint(0, v, (s, l), generator=g, device=dev)
        idx[:, 1] = idx[:, 0]  # a duplicate in every bag
        far = torch.randint(v, 2 * v, (s, l), generator=g, device=dev)
        pick = torch.rand(s, l, generator=g, device=dev) < bad
        idx = torch.where(pick, torch.where(far % 2 == 0, far, -far), idx)
        w = torch.rand(s, l, generator=g, device=dev)
        w = torch.where(torch.rand(s, l, generator=g, device=dev) < 0.2, 0.0, w)
        return idx.to(dtype), w, torch.randn(s, table.shape[1], generator=g, device=dev)

    # The timed case is the main path's own input: the user tower at its
    # train batch, the mask as the weights, the in-range ids it draws.
    main = recsys_batch(torch, TT, RecsysShape("train", b_tt), g, dev)
    uidx, uw = main["user_ids"], main["user_mask"]
    ug = torch.randn(b_tt, user.shape[1], generator=g, device=dev)
    checks = {"user tower train (path's ids and mask)":
              bag_backward_check(torch, "user train", user, uidx, uw, ug, False)}
    cases = {
        "user tower int32": (user, *bags(user, b_tt, TT.user_fields, torch.int32), False),
        "din history int64, dw": (din_table, *bags(din_table, b, 100, torch.int64), True),
        "din history int32, dw": (din_table, *bags(din_table, b, 100, torch.int32), True),
        "xdeepfm linear D 1, dw": (linear, *bags(linear, b // 4, 39, torch.int32), True),
    }
    # One row named 100,000 times (at every other flat position below
    # 200,000) among DIN's history: the warp takes it at D 18.
    hot = bags(din_table, b, 100, torch.int64)
    hot[0].view(-1)[0:200_000:2] = 7
    cases["din history, row 7 named 100,000 times, dw"] = (din_table, *hot, True)
    for what, (table, idx, w, gg, wg) in cases.items():
        checks[what] = bag_backward_check(torch, what, table, idx, w, gg, wg)
    log(f"[bag-bwd] kernels vs plain version per element: {json.dumps(checks)}")
    prep = {"user tower train (path's ids)": bag_prep_check(torch, "user", user, uidx, uw, ug)}
    for what, (table, idx, w, gg, _) in cases.items():
        prep[what] = bag_prep_check(torch, what, table, idx, w, gg)
    log(f"[bag-bwd] the table entry's sort and row offsets equal ref.bag_sort / ref.bag_csr "
        f"exactly: {json.dumps(prep)}")

    # Planted faults, as perturbations of the plain version's output.
    _, idx, w, gg, _ = cases["din history int64, dw"]
    want_t, want_w = ref.embedding_bag_bags_backward(din_table, idx, w, gg, weights_grad=True)
    lim_t, lim_w = ref.embedding_bag_backward_error_bound(din_table, idx, w, gg)
    key, pos = ref.bag_sort(idx, din_table.shape[0])
    last = torch.ones_like(key, dtype=torch.bool)
    last[:-1] = key[1:] != key[:-1]
    w_drop = w.reshape(-1).clone()
    w_drop[pos[last & (key < din_table.shape[0])]] = 0.0
    dropped = ref.embedding_bag_bags_backward(din_table, idx, w_drop.view_as(w), gg)[0]
    faults = {"each row's last contribution dropped (dtable)": (dropped, want_t, lim_t),
              "dw written one slot off": (torch.roll(want_w, 1, dims=1), want_w, lim_w)}
    for what, (bad, want, lim) in faults.items():
        excess = float(((bad - want).abs() - lim).max())
        if not excess > 0:
            fail(f"embedding_bag backward: the per-element limit does not reject a planted "
                 f"fault ({what})")
        log(f"[bag-bwd] planted fault, {what}: {excess} beyond the limit: rejected")
    del faults, dropped, want_t, want_w, lim_t, lim_w, cases

    s, l, d, v = b_tt, uidx.shape[1], user.shape[1], user.shape[0]
    ms = time_cuda(torch, lambda: embedding_bag_backward_cuda(user, uidx, uw, ug), flush)
    plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags_backward(user, uidx, uw, ug),
                         flush, iters=5)
    leaf = user.detach().requires_grad_(True)
    lib_out = torch.nn.functional.embedding_bag(uidx, leaf, per_sample_weights=uw, mode="sum")
    lib_err = float((torch.autograd.grad(lib_out, leaf, ug, retain_graph=True)[0]
                     - embedding_bag_backward_cuda(user, uidx, uw, ug)[0]).abs().max())
    library_ms = time_cuda(
        torch, lambda: torch.autograd.grad(lib_out, leaf, ug, retain_graph=True), flush)
    del lib_out, leaf
    # The table's gradient is dense: written once whole; g, the ids and the
    # weights read once; one fma per (bag, slot, column).
    ops_, nbytes = grad_table_work(s=s, l=l, d=d, v=v, index_bytes=uidx.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    # DIN's history with the weights' gradient (both kernels), beside the
    # autograd of F.embedding_bag in the table and the weights.
    din_idx, din_w, din_g = bags(din_table, b, 100, torch.int64, bad=0.0)
    din_ms = time_cuda(torch, lambda: embedding_bag_backward_cuda(
        din_table, din_idx, din_w, din_g, weights_grad=True), flush)
    din_table_ms = time_cuda(torch, lambda: embedding_bag_backward_cuda(
        din_table, din_idx, din_w, din_g), flush)
    din_dw_ms = time_cuda(torch, lambda: embedding_bag_backward_cuda(
        din_table, din_idx, din_w, din_g, table_grad=False, weights_grad=True), flush)
    din_plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags_backward(
        din_table, din_idx, din_w, din_g, weights_grad=True), flush, iters=5)
    leaves = (din_table.detach().requires_grad_(True), din_w.detach().requires_grad_(True))
    lib_out = torch.nn.functional.embedding_bag(din_idx, leaves[0], per_sample_weights=leaves[1],
                                                mode="sum")
    din_lib_ms = time_cuda(
        torch, lambda: torch.autograd.grad(lib_out, leaves, din_g, retain_graph=True), flush)
    del lib_out, leaves
    shapes = dict(s=b, l=100, d=din_table.shape[1], index_bytes=8)
    din_work = [grad_table_work(v=din_table.shape[0], **shapes),
                grad_weights_work(after_table=True, **shapes)]
    din_ops, din_bytes = (sum(x) for x in zip(*din_work))
    din_t = (din_bytes / HBM_BYTES_PER_S, din_ops / F32_OPS_PER_S)
    din_row = {
        "shape": [b, 100, din_table.shape[1], din_table.shape[0]], "ms": din_ms,
        "table_ms": din_table_ms, "weights_ms": din_dw_ms,
        "plain_ms": din_plain_ms, "library_ms": din_lib_ms, "bound_ms": max(din_t) * 1e3,
        "bound_by": "bytes" if din_t[0] >= din_t[1] else "operations", "launches": 0,
    }
    # Row 5-DIN: the forward kernel on the same history (measured only).
    fwd_lib = torch.nn.functional.embedding_bag
    fwd_ms = time_cuda(torch, lambda: embedding_bag_cuda(din_table, din_idx, din_w), flush)
    fwd_plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags(din_table, din_idx, din_w),
                             flush, iters=5)
    fwd_lib_ms = time_cuda(torch, lambda: fwd_lib(din_idx, din_table, per_sample_weights=din_w,
                                                  mode="sum"), flush)
    fwd_err = bag_check(torch, "din history train", din_table, din_idx, din_w)["max_abs_err"]
    # DIN's history at serve_p99 as the path makes it: the prefix mask times
    # attention weights in [-1, 1).
    p99 = recsys_batch(torch, DIN, RECSYS_SHAPES["serve_p99"], g, dev)
    p99_w = p99["hist_mask"] * (torch.rand(p99["hist_mask"].shape, generator=g, device=dev) * 2 - 1)
    fwd_p99_ms = time_cuda(torch, lambda: embedding_bag_cuda(din_table, p99["hist_ids"], p99_w), flush)
    fwd_ops, fwd_bytes = work(s=b, l=100, d=din_table.shape[1], needed=int((din_w != 0).sum()),
                              index_bytes=8)
    fwd_t = (fwd_bytes / HBM_BYTES_PER_S, fwd_ops / F32_OPS_PER_S)
    din_forward = {
        "shape": [b, 100, din_table.shape[1], din_table.shape[0]], "ms": fwd_ms,
        "plain_ms": fwd_plain_ms, "library_ms": fwd_lib_ms, "bound_ms": max(fwd_t) * 1e3,
        "bound_by": "bytes" if fwd_t[0] >= fwd_t[1] else "operations", "max_abs_err": fwd_err,
        "launches": 0, "serve_p99_ms": fwd_p99_ms,
    }
    del din_idx, din_w, din_g
    # Row 5b-xDeepFM: the table's gradient at xDeepFM's linear term, one
    # training microbatch of the path's own input (field ids, weights 1).
    xb = RECSYS_TRAIN[1][1] // RECSYS_TRAIN[1][2]
    xin = recsys_batch(torch, XD, RecsysShape("train", xb), g, dev)
    xidx = xin["field_ids"]
    xw = torch.ones(xidx.shape, device=dev)
    xg = torch.randn(xb, linear.shape[1], generator=g, device=dev)
    xd_check = bag_backward_check(torch, "xdeepfm linear (path's ids)", linear, xidx, xw, xg, False)
    xd_ms = time_cuda(torch, lambda: embedding_bag_backward_cuda(linear, xidx, xw, xg), flush)
    xd_plain_ms = time_cuda(torch, lambda: ref.embedding_bag_bags_backward(linear, xidx, xw, xg),
                            flush, iters=5)
    leaf = linear.detach().requires_grad_(True)
    lib_out = torch.nn.functional.embedding_bag(xidx, leaf, per_sample_weights=xw, mode="sum")
    xd_lib_ms = time_cuda(
        torch, lambda: torch.autograd.grad(lib_out, leaf, xg, retain_graph=True), flush)
    del lib_out, leaf
    xd_ops, xd_bytes = grad_table_work(s=xb, l=xidx.shape[1], d=linear.shape[1],
                                       v=linear.shape[0], index_bytes=xidx.element_size())
    xd_t = (xd_bytes / HBM_BYTES_PER_S, xd_ops / F32_OPS_PER_S)
    xd_row = {
        "shape": [xb, xidx.shape[1], linear.shape[1], linear.shape[0]], "ms": xd_ms,
        "plain_ms": xd_plain_ms, "library_ms": xd_lib_ms, "bound_ms": max(xd_t) * 1e3,
        "bound_by": "bytes" if xd_t[0] >= xd_t[1] else "operations",
        "max_abs_err": xd_check["dtable_max_abs_err"], "launches": 0,
    }
    row = {
        "name": "embedding_bag_backward",
        "route": "cuda",
        "source": KERNEL_INFO["embedding_bag"][0],
        "replaces": KERNEL_INFO["embedding_bag"][1],
        "tpu_counterpart": "none: the TPU kernel is forward only; JAX differentiates jnp.take + sum",
        "launches": 0,
        "max_abs_err": checks["user tower train (path's ids and mask)"]["dtable_max_abs_err"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "bytes": int(nbytes),
        "din_dw": din_row,
        "xdeepfm_linear": xd_row,
        "din_forward": din_forward,
    }
    log(f"[bag-bwd] timed at the user tower's train input: S={s} L={l} D={d} V={v} int64 ids, "
        f"the table's gradient (dense, {v * d * 4} bytes); F.embedding_bag autograd vs kernel max "
        f"abs err {lib_err}; DIN history (S={b} L=100 D=18, both gradients) {din_ms:.5f} ms "
        f"(dtable alone {din_table_ms:.5f}, dw alone {din_dw_ms:.5f}) against a "
        f"{din_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms bytes bound; the forward kernel there "
        f"(row 5-DIN) {fwd_ms:.5f} ms against {fwd_t[0] * 1e3:.5f}, at serve_p99 (S="
        f"{p99['hist_ids'].shape[0]}, the path's mask x attention weights) {fwd_p99_ms:.5f} ms; xDeepFM's linear term "
        f"(row 5b-xDeepFM, S={xb} L={xidx.shape[1]} D=1 V={linear.shape[0]}) {xd_ms:.5f} ms "
        f"against {max(xd_t) * 1e3:.5f}; {card()}; {json.dumps(row)}")
    return row


def forced_bags(torch, model) -> None:
    """Teacher-force a kernel-executor model's bag sums: each gives the
    reference executor's forward value (JAX's rows times weights, summed)
    and takes the kernel's gradient (the bag backward's kernels), so the two
    executors' gradients differ only by the backward's arithmetic."""
    import types

    from repro_torch.kernels import ops, ref

    def bag(self, name, ids, weights):
        table = getattr(self, name)
        k = ops.embedding_bag(table, bag_indices=ids, bag_weights=weights, use_kernel=True)
        r = torch.sum(ref.take(table, ids) * weights.unsqueeze(-1), dim=1)
        return r.detach() + (k - k.detach())

    model._bag = types.MethodType(bag, model)


def recsys_train_model(torch, arch: str, b: int, mb: int, dev, seed: int, opt, flush,
                       check) -> dict:
    """One recsys model's training at full width: the no-grad loss, the
    step-1 gradients at both executors on the first microbatch (finite,
    non-zero, the tables' only on rows the batch names, kernel = reference
    within RECSYS_GRAD_TOL), TRAIN_STEPS timed kernel-executor steps on the
    repeated batch (the loss falls; the step-1 loss equals the no-grad
    loss), the bag launches of those steps; xDeepFM also microbatches
    4 vs 1; DIN also a train_loop killed at step 7 resumed from step 5 to
    the same bits. Returns the kernel launches of the timed steps."""
    from repro_torch.configs.families import recsys_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params
    from repro_torch.models.recsys import RECSYS_MODELS
    from repro_torch.train import TrainState, make_train_step
    from repro_torch.train.checkpoint import flatten
    from repro_torch.train.optimizer import adamw_update

    t_arch = time.perf_counter()
    cfg = get_arch(arch).config
    kind = type(cfg).__name__

    def fresh():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return init_params(cfg, gen, device=dev)

    state = TrainState.create(fresh())
    gb = torch.Generator(device=dev)
    gb.manual_seed(seed + 1)
    batch = recsys_train_batch(torch, cfg, b, gb, dev)
    n = sum(p.numel() for p in state.params.values())
    chunks = [{k: v[j * b // mb:(j + 1) * b // mb] for k, v in batch.items()} for j in range(mb)]
    loss_fn = recsys_loss_fn(cfg)
    with torch.no_grad():
        nograd = sum(float(loss_fn(state.params, c)[0]) for c in chunks) / mb

    grads, first = {}, {}
    for ex in ("reference", "kernel", "forced"):
        model = RECSYS_MODELS[type(cfg)].from_params(
            cfg, state.params, executor="reference" if ex == "reference" else "kernel",
            trainable=True)
        if ex == "forced":
            forced_bags(torch, model)
        loss, _ = model.loss(chunks[0])
        grads[ex] = torch.autograd.grad(loss, list(state.params.values()))
        first[ex] = float(loss.detach())
        del loss, model
    names = list(state.params)
    bad = [k for k, gr in zip(names, grads["kernel"]) if not bool(torch.isfinite(gr).all())]
    zero = [k for k, gr in zip(names, grads["kernel"]) if not bool(gr.any())]
    check(not bad and not zero, f"{arch}: parameters with a non-finite gradient {bad}, all zero {zero}")
    stray = {}
    for table, keys in TABLE_IDS[kind].items():
        gr = grads["kernel"][names.index(table)]
        named = torch.zeros(gr.shape[0], dtype=torch.bool, device=dev)
        for key in keys:
            named[chunks[0][key].reshape(-1).long()] = True
        stray[table] = int((gr.ne(0).any(dim=1) & ~named).sum())
    check(not any(stray.values()), f"{arch}: table gradient rows the batch does not name: {stray}")
    rel = {ex: {k: float((a - r).norm() / r.norm().clamp_min(1e-30))
                for k, a, r in zip(names, grads[ex], grads["reference"])}
           for ex in ("kernel", "forced")}
    loss_rel = abs(first["kernel"] - first["reference"]) / abs(first["reference"])
    worst = {ex: max(r, key=r.get) for ex, r in rel.items()}
    wf = worst["forced"]
    check(loss_rel <= TRAIN_LOSS_TOL and rel["forced"][wf] <= RECSYS_GRAD_TOL,
          f"{arch}: kernel vs reference executor: loss {loss_rel} relative (limit {TRAIN_LOSS_TOL}), "
          f"teacher-forced gradient {wf} {rel['forced'][wf]} of its norm (limit {RECSYS_GRAD_TOL})")
    log(f"[recsys-train] {arch}: {n} float32 parameters ({16 * n / 1e9:.2f} GB with gradients, m "
        f"and v), batch {b} in {mb} microbatch(es); step-1 gradients on {b // mb} rows: all "
        f"{len(names)} finite and non-zero; table rows outside the batch's ids with a gradient "
        f"{stray}; kernel vs reference: loss {first['kernel']} vs {first['reference']} ({loss_rel} "
        f"relative; limit {TRAIN_LOSS_TOL}); gradients teacher-forced: largest difference "
        f"{rel['forced'][wf]} of its norm at {wf} (limit {RECSYS_GRAD_TOL}); free run: "
        f"{rel['kernel'][worst['kernel']]} at {worst['kernel']} (ReLU flips; no limit)")
    del grads

    step = make_train_step(loss_fn, opt, microbatches=mb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # this model's main path: the timed kernel-executor steps
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launched = {k: LAUNCHES[k] for k in ("embedding_bag", "embedding_bag_backward")}
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = BAG_LAUNCHES[kind]
    expect = {"embedding_bag": TRAIN_STEPS * mb * fwd, "embedding_bag_backward": TRAIN_STEPS * mb * bwd}
    check(launched == expect, f"{arch}: bag launches over {TRAIN_STEPS} steps {launched}, expected {expect}")
    p50 = float(np.median(times[1:]))
    rel1 = abs(losses[0] - nograd) / abs(nograd)
    check(rel1 <= TRAIN_LOSS_TOL, f"{arch}: step-1 loss {losses[0]} vs the no-grad loss {nograd}: "
                                  f"{rel1} relative > {TRAIN_LOSS_TOL}")
    check(losses[-1] < losses[0], f"{arch}: the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    final = ([(k, v.detach().to("cpu", copy=True)) for k, v in flatten(state)]
             if kind == "DINConfig" else None)
    # The optimizer's share of the step: one adamw_update (clip, moments,
    # decay; every parameter dense) timed alone, the m moments standing in
    # for gradients of the same shapes (the state is not used again).
    adam = time_cuda(torch, lambda: adamw_update(opt, state.params, state.opt["m"], state.opt),
                     flush, iters=5)
    log(f"[recsys-train] {arch}: step-1 loss {losses[0]} (no-grad {nograd}, {rel1} relative); "
        f"losses at lr {opt.lr} {json.dumps(losses)}; step p50 {p50 * 1e3:.3f} ms (first "
        f"{times[0] * 1e3:.1f} ms), {b / p50:.1f} samples/s; peak memory {peak / 2**30:.2f} GiB; "
        f"AdamW alone {adam:.3f} ms, {adam / (p50 * 1e3):.3f} of the step; bag launches "
        f"{launched}; {card()}")
    del state, step, loss_fn, chunks
    torch.cuda.empty_cache()

    if kind == "XDeepFMConfig":
        small = {k: v[:XDEEPFM_MB_BATCH] for k, v in batch.items()}
        res = {}
        for m_ in (mb, 1):
            st = TrainState.create(fresh())
            _, met = make_train_step(recsys_loss_fn(cfg), opt, microbatches=m_)(st, small)
            res[m_] = {k: float(v) for k, v in met.items()}
            del st
            torch.cuda.empty_cache()
        d_loss = abs(res[mb]["loss"] - res[1]["loss"]) / abs(res[1]["loss"])
        d_gn = abs(res[mb]["grad_norm"] - res[1]["grad_norm"]) / res[1]["grad_norm"]
        check(d_loss <= XDEEPFM_MB_TOL and d_gn <= XDEEPFM_MB_TOL,
              f"{arch}: microbatches {mb} vs 1 at {XDEEPFM_MB_BATCH}: loss {d_loss}, grad_norm "
              f"{d_gn} relative (limit {XDEEPFM_MB_TOL})")
        log(f"[recsys-train] {arch}: one step at {XDEEPFM_MB_BATCH} rows, microbatches {mb} vs 1: "
            f"{json.dumps(res)}; loss {d_loss}, grad_norm {d_gn} relative (limit {XDEEPFM_MB_TOL})")

    if final is not None:
        resume_check(torch, "recsys-train", arch, dict(
            init_params_fn=fresh, loss_fn=recsys_loss_fn(cfg), batch_iter=lambda _: batch,
            opt_cfg=opt, n_steps=TRAIN_STEPS, log_every=TRAIN_STEPS, log_fn=log, device=dev),
            final, check)
        del final
    del batch
    torch.cuda.empty_cache()
    log(f"[recsys-train] {arch} done in {time.perf_counter() - t_arch:.1f}s")
    return launched


def phase_recsys_train(torch, dev, seed: int, flush, check) -> dict:
    """Recsys training at full width (``RECSYS_TRAIN``): the bag backward's
    kernels first (``phase_bag_backward``, on the models' full-size
    tables), then each model (``recsys_train_model``). Returns the bag
    backward's kernels row, its launches those of the models' timed
    kernel-executor steps."""
    from repro_torch.configs import din, two_tower_retrieval, xdeepfm
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig

    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tables = {
        "user_table": init_params(two_tower_retrieval.CONFIG, g, device=dev)["user_table"],
        "din": init_params(din.CONFIG, g, device=dev)["table"],
        "linear": init_params(xdeepfm.CONFIG, g, device=dev)["linear"],
    }
    row = phase_bag_backward(torch, dev, tables, flush)
    del tables
    torch.cuda.empty_cache()
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    launches = 0
    for i, (arch, b, mb) in enumerate(RECSYS_TRAIN):
        launched = recsys_train_model(torch, arch, b, mb, dev, seed + 10 * (i + 1), opt_cfg, flush,
                                      check)
        launches += launched["embedding_bag_backward"]
        if arch == "din":
            row["din_dw"]["launches"] = launched["embedding_bag_backward"]
            row["din_forward"]["launches"] = launched["embedding_bag"]
        if arch == "xdeepfm":
            row["xdeepfm_linear"]["launches"] = launched["embedding_bag_backward"]
            row["xdeepfm_forward_launches"] = launched["embedding_bag"]  # row 5-xDeepFM's
    row["launches"] = launches
    log(f"[recsys-train] step took {time.perf_counter() - t0:.1f}s")
    return row


def gnn_batch(torch, name: str, s, g, dev, seed: int) -> dict:
    """One batch of ``GNNFamily.input_specs`` at the full shape ``s`` on the
    card: features standard normal, labels in [0, n_classes); the full
    graphs' edges uniform over the nodes (molecule: 128 graphs of 30 nodes);
    minibatch_lg one ``neighbor_sample`` draw over a synthetic CSR graph
    (``GNN_GRAPH_NODES`` nodes, Poisson ``GNN_AVG_DEGREE`` degrees, uniform
    neighbours), padded with its masks."""
    from repro_torch.models.gnn import neighbor_sample

    n = s.n_nodes
    batch = {
        "x": torch.randn(n, s.d_feat, generator=g, device=dev),
        "labels": torch.randint(0, s.n_classes, (s.n_graphs or n,), generator=g, device=dev,
                                dtype=torch.int32),
    }
    if not s.batch_nodes:
        for k in ("edge_src", "edge_dst"):
            batch[k] = torch.randint(0, n, (s.n_edges,), generator=g, device=dev, dtype=torch.int32)
        if s.n_graphs:
            batch["graph_ids"] = torch.arange(s.n_graphs, device=dev, dtype=torch.int32
                                              ).repeat_interleave(n // s.n_graphs)
        return batch
    rng = np.random.default_rng(seed)
    deg = rng.poisson(GNN_AVG_DEGREE, GNN_GRAPH_NODES)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, GNN_GRAPH_NODES, indptr[-1])
    seeds = rng.choice(GNN_GRAPH_NODES, s.batch_nodes, replace=False)
    t0 = time.perf_counter()
    nodes, src, dst, emask = neighbor_sample(rng, indptr, indices, seeds, GNN_FANOUTS)
    sample_s = time.perf_counter() - t0
    if len(nodes) > n or len(src) > s.n_edges:
        fail(f"gnn minibatch_lg: the sample has {len(nodes)} nodes and {len(src)} edge slots, "
             f"over the shape's {n} and {s.n_edges}")
    pad = s.n_edges - len(src)
    batch["edge_src"] = torch.from_numpy(np.concatenate([src, np.zeros(pad, np.int32)])).to(dev)
    batch["edge_dst"] = torch.from_numpy(np.concatenate([dst, np.zeros(pad, np.int32)])).to(dev)
    batch["edge_mask"] = torch.from_numpy(
        np.concatenate([emask, np.zeros(pad, bool)]).astype(np.float32)).to(dev)
    batch["label_mask"] = (torch.arange(n, device=dev) < s.batch_nodes).float()
    log(f"[gnn] minibatch_lg: neighbor_sample of {s.batch_nodes} seeds, fanouts {GNN_FANOUTS}, over "
        f"{GNN_GRAPH_NODES} nodes / {indptr[-1]} edges in {sample_s:.3f} s: {len(nodes)} nodes, "
        f"{int(emask.sum())} sampled edges in {len(src)} slots, padded to {n} / {s.n_edges}")
    return batch


def gather_segment_ms(torch, cfg, batch, flush) -> float:
    """Device ms of the message passing in one train step: layer 0's gather
    + segment sum forward at d_feat (its input takes no gradient), and one
    later layer's forward + backward at d_hidden, times the later layers."""
    from repro_torch.models.gnn import gather_rows, segment_sum

    src, dst, mask = batch["edge_src"], batch["edge_dst"], batch.get("edge_mask")
    n = batch["x"].shape[0]

    def agg(h):
        msgs = gather_rows(h, src)
        if mask is not None:
            msgs = msgs * mask[:, None]
        return segment_sum(msgs, dst, n)

    with torch.no_grad():
        first = time_cuda(torch, lambda: agg(batch["x"]), flush, iters=5)
    h = torch.randn(n, cfg.d_hidden, device=batch["x"].device, requires_grad=True)
    go = torch.randn(n, cfg.d_hidden, device=h.device)
    later = time_cuda(torch, lambda: torch.autograd.grad(agg(h), h, go), flush, iters=5)
    return first + (cfg.n_layers - 1) * later


def phase_gnn(torch, dev, seed: int, flush, check) -> None:
    """gin-tu at its CONFIG on the four ``GNN_SHAPES`` at full size: the
    no-grad loss, two step-1 gradient computations (finite, non-zero,
    bit-identical), TRAIN_STEPS timed steps on the repeated batch (the
    loss falls; the step-1 loss equals the no-grad loss); edges/s, step
    p50, peak memory and the gather + segment sum share of the step."""
    from repro_torch.configs.families import GNN_SHAPES, GNNFamily, gnn_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, TrainState, make_train_step

    arch = get_arch("gin-tu")
    opt = AdamWConfig(**TRAIN_OPT)
    for i, name in enumerate(arch.shapes):
        t0 = time.perf_counter()
        s = GNN_SHAPES[name]
        cfg = GNNFamily._cfg_for(arch, s, reduced=False)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        state = TrainState.create(init_params(cfg, g, device=dev))
        batch = gnn_batch(torch, name, s, g, dev, seed + i)
        loss_fn = gnn_loss_fn(cfg, s.n_graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            nograd = float(loss_fn(state.params, batch)[0])
        grads = []
        for _ in range(2):
            loss, _ = loss_fn(state.params, batch)
            grads.append(torch.autograd.grad(loss, list(state.params.values())))
            del loss
        same = all(torch.equal(a, b) for a, b in zip(*grads))
        names = list(state.params)
        bad = [k for k, gr in zip(names, grads[0]) if not bool(torch.isfinite(gr).all()) or not bool(gr.any())]
        check(same, f"gin-tu {name}: two step-1 gradient computations differ")
        check(not bad, f"gin-tu {name}: parameters with a non-finite or all-zero gradient {bad}")
        del grads
        step = make_train_step(loss_fn, opt)
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        p50 = float(np.median(times[1:]))
        rel = abs(losses[0] - nograd) / abs(nograd)
        check(rel <= TRAIN_LOSS_TOL, f"gin-tu {name}: step-1 loss {losses[0]} vs the no-grad loss "
                                     f"{nograd}: {rel} relative > {TRAIN_LOSS_TOL}")
        check(losses[-1] < losses[0], f"gin-tu {name}: the loss did not fall: {losses}")
        share = gather_segment_ms(torch, cfg, batch, flush) / (p50 * 1e3)
        log(f"[gnn] gin-tu {name}: {s.n_nodes} nodes x {s.d_feat} features, {s.n_edges} edges, "
            f"{cfg.n_classes} classes, {sum(p.numel() for p in state.params.values())} parameters; "
            f"step-1 gradients bit-identical twice: {same}, every one finite and non-zero: "
            f"{not bad}; step-1 loss {losses[0]} (no-grad {nograd}, {rel} relative); losses "
            f"{json.dumps(losses)}; step p50 {p50 * 1e3:.3f} ms (first {times[0] * 1e3:.1f} ms), "
            f"{s.n_edges / p50:.1f} edges/s; peak memory {peak / 2**30:.2f} GiB; gather + segment "
            f"sum {share:.3f} of the step; {time.perf_counter() - t0:.1f} s; {card()}")
        del state, batch, step, loss_fn
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the mesh phase: the LM and recsys families over (data, model) meshes of ranks
# ---------------------------------------------------------------------------

# Mixtral-8x7b at full width over gloo ranks that share the card. The
# (1, 4) run is the zoo's 2-layer cut at the zoo's prompt; the (2, 2) run
# splits the batch and gathers FSDP blocks, so it stays shallow (every
# gather copies a layer's weights through the host). At 8, 2 and 2 layers
# (and the dry run's 2) the phase took 155.0 s: the runs took half as many
# to keep the script inside its 1200 s on a slower host, and the (1, 4) run
# half again (2 layers; layer 1 still meets the KV check's "later" rule)
# to make room for the encoder_train phase.
MESH_RANKS = 4
MESH_LM = (  # tag, (data, model), layers, batch, prompt length, greedy tokens
    ("1x4", (1, 4), 2, 2, 8192, 16),
    ("2x2", (2, 2), 1, 2, 2048, 4),
)
# The (4, 1) decode takes 2 steps (8 took 80 s of the phase) to leave the
# mesh_train phase room in the script's 1200 s.
MESH_SEQ = ("4x1", (4, 1), 1, 16384, 2)  # tag, mesh, layers, cache positions, decode steps
MESH_RECSYS = (("two-tower-retrieval", "serve_bulk"), ("din", "serve_p99"))
MESH_DRYRUN_LAYERS = 1
MESH_JOIN_S = 900.0
MESH_BUDGET_S = 240.0
MESH_MFU_MAX = 1.05
DIN_MESH_TOL = 1e-4  # DIN's logits over the mesh: within 1e-4 * max(1, |ref|)
def mesh_lm_config(layers: int):
    """mixtral-8x7b at full width, cut to ``layers``."""
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch("mixtral-8x7b").config, n_layers=layers)


def mesh_generate(torch, model, prompt, n: int, batch: int, routes=None, forced=None):
    """Greedy prefill + ``n - 1`` decode steps of ``model`` (over a mesh:
    the rank's rows of a ``batch``-row prompt) -> (logits per step [n, B,
    V] f32, tokens [B, n], the prompt's k/v after the prefill). ``routes``
    collects each router call's (top_e, probs). ``forced`` (the reference's
    {"tokens" [B, n] (the rank's rows), "routes": [top_e per router
    call]}) teacher-forces the run as the zoo's parity run does: each
    decode step takes the reference's previous token, and each router call
    the reference's expert set, weighed with this run's own probabilities;
    ``routes`` then holds the choices this run would have made."""
    from unittest import mock

    from repro_torch.models import KVCache, moe

    sink = routes if routes is not None else []
    route = moe.route

    def forced_route(x, w, c):
        probs, _, top_e = route(x, w, c)
        want = forced["routes"][len(sink)].to(top_e.device)
        sink.append((top_e, probs))
        p = torch.gather(probs, 1, want)
        return probs, p / p.sum(-1, keepdim=True), want

    s = prompt.shape[1]
    cache = KVCache.empty(model.cfg, batch, s + n, device=prompt.device, mesh=model.mesh)
    router = capture_routes(torch, sink) if forced is None else forced_route
    with mock.patch.object(moe, "route", router):
        logits, cache = model.prefill(prompt, cache)
        kv = (cache.k[:, :, :s].clone(), cache.v[:, :, :s].clone())
        steps, toks = [logits.float()], [logits.argmax(-1)]
        for t in range(n - 1):
            fed = toks[-1] if forced is None else forced["tokens"][:, t].to(prompt.device)
            logits, cache = model.decode_step(fed, cache)
            steps.append(logits.float())
            toks.append(logits.argmax(-1))
    return torch.stack(steps), torch.stack(toks, 1), kv


def mesh_seq_decode(torch, model, cache, forced):
    """One decode step per token of ``forced`` [n, 1] over ``cache`` ->
    logits [n, 1, V] f32."""
    out = []
    for t in forced:
        logits, cache = model.decode_step(t, cache)
        out.append(logits.float())
    return torch.stack(out)


def mesh_world(group, spec_path: str, out_dir: str) -> None:
    """One rank of the mesh phase's worlds: each run of the spec on its
    mesh over the world's ranks, weights drawn as the one-process reference
    drew them (every rank keeps its blocks), the kernel launches counted
    from 0 over the run; each rank saves what the parent checks."""
    import torch

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import TransformerLM, init_params, serve_step
    from repro_torch.models.recsys import RECSYS_MODELS
    from repro_torch.models.transformer import KVCache, shard_cache

    with open(spec_path) as f:
        spec = json.load(f)
    dev, r = group.device, group.rank

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def done(name, out):
        torch.save(out, os.path.join(out_dir, f"{name}_rank{r}.pt"))
        gc_cuda(torch, dev)

    for run in spec["lm"]:
        mesh = group.mesh(tuple(run["mesh"]))
        cfg = mesh_lm_config(run["layers"])
        g = torch.Generator(device=dev)
        g.manual_seed(run["seed"])
        t0 = time.perf_counter()
        model = TransformerLM.from_params(
            cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16, mesh=mesh), mesh=mesh)
        prompt = torch.load(run["prompt"]).to(dev)
        data = sharding.P(data_axes(mesh), None)
        forced = None
        if run.get("forced"):  # the reference's tokens (the rank's rows) and routing
            forced = torch.load(run["forced"])
            forced["tokens"] = sharding.local_block(forced["tokens"], data, mesh)
        routes = []
        sync()
        made = time.perf_counter() - t0
        reset_launches()  # the path starts here
        t0 = time.perf_counter()
        logits, toks, (k, v) = mesh_generate(torch, model, sharding.local_block(prompt, data, mesh),
                                             run["new"], prompt.shape[0], routes, forced)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)  # read right after the path's run
        toks = sharding.gather_block(toks, data, mesh)
        done(run["tag"], {"logits": logits.cpu(), "tokens": toks.cpu(), "k": k.cpu(), "v": v.cpu(),
                          "routes": [e.cpu() for e, _ in routes], "launches": launches,
                          "wall_s": wall, "made_s": made,
                          "peak": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0})
        del model, k, v
    if spec.get("seq"):
        run = spec["seq"]
        mesh = group.mesh(tuple(run["mesh"]))
        cfg = mesh_lm_config(run["layers"])
        g = torch.Generator(device=dev)
        g.manual_seed(run["seed"])
        model = TransformerLM.from_params(
            cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16, mesh=mesh), mesh=mesh)
        full = torch.load(run["cache"])
        cache = shard_cache(KVCache(full["k"], full["v"], full["length"]), cfg, mesh,
                            shard_seq=True, device=dev)
        del full
        forced = torch.load(run["forced"]).to(dev)
        reset_launches()
        t0 = time.perf_counter()
        logits = mesh_seq_decode(torch, model, cache, forced)
        sync()
        done(run["tag"], {"logits": logits.cpu(), "launches": dict(LAUNCHES),
                          "wall_s": time.perf_counter() - t0})
        del model, cache
    for run in spec["recsys"]:
        mesh = group.mesh(tuple(run["mesh"]))
        a = get_arch(run["arch"])
        cfg, shape = a.config, RECSYS_SHAPES[run["shape"]]
        g = torch.Generator(device=dev)
        g.manual_seed(run["seed"])
        batch = recsys_batch(torch, cfg, shape, g, dev)  # drawn as the reference drew it
        model = RECSYS_MODELS[type(cfg)].from_params(
            cfg, init_params(cfg, g, device=dev, mesh=mesh), mesh=mesh)
        specs = a.family.input_pspec(a, run["shape"], mesh)
        local = {k: sharding.local_block(t, specs[k], mesh) for k, t in batch.items()}
        step = serve_step(model, shape)
        step(local)  # warm
        sync()
        reset_launches()
        t0 = time.perf_counter()
        out = step(local)
        sync()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        out = sharding.gather_block(out, a.family.output_pspec(a, run["shape"], mesh), mesh)
        bags = {}
        if run["arch"] == "two-tower-retrieval":
            with torch.inference_mode():
                for side in ("user", "item"):
                    bags[side] = sharding.gather_block(
                        model._bag(f"{side}_table", local[f"{side}_ids"], local[f"{side}_mask"]),
                        sharding.P(data_axes(mesh), None), mesh).cpu()
        done(f"rs_{run['arch']}", {"out": out.cpu(), "bags": bags, "launches": launches,
                                   "wall_s": wall})
        del model


def mesh_device(dev) -> str:
    """The one card every gloo rank of the phase shares."""
    return f"cuda:{dev.index or 0}"


def gc_cuda(torch, dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def mesh_lm_check(torch, what: str, got: dict, want: dict, rows, *, bitwise=False) -> dict:
    """One rank's mesh run against the one-process run (its rows): the
    prompt's KV block, layer 0 within one bf16 ulp, later layers within
    ``LM_KV_TOL`` of the norm. ``bitwise`` (a free run on a mesh of one):
    logits, tokens and KV identical. Else the run was teacher-forced in
    tokens and routing (``mesh_generate``'s ``forced``), as the zoo's
    parity run is: logits at every step within ``LM_LOGITS_TOL``; a step
    whose argmax is not the reference's token only at a reference top-2
    gap within ``LM_LOGITS_TOL`` (reported); every expert set the rank's
    router would have picked apart from the reference's only at a
    reference k-th/(k+1)-th probability gap within ``MOE_FLIP_GAP``."""
    lg, lw = got["logits"], want["logits"][:, rows]
    kv = {}
    for name in ("k", "v"):
        blk, ref_blk = got[name], want[name]
        if bitwise and not torch.equal(blk, ref_blk):
            fail(f"mesh {what}: {name} cache differs from the one-process run")
        kv[name] = []
        for layer in range(blk.shape[0]):
            g_, w_ = blk[layer].float(), ref_blk[layer].float()
            if layer == 0:
                _, excess = bf16_excess(torch, g_, w_)
                if not excess <= FLASH_BF16_ATOL:
                    fail(f"mesh {what}: layer 0 {name} cache differs by {excess} beyond one bf16 ulp")
            rel = float((g_ - w_).norm() / w_.norm())
            if not rel <= LM_KV_TOL:
                fail(f"mesh {what}: layer {layer} {name} cache, relative norm {rel} > {LM_KV_TOL}")
            kv[name].append(rel)
    if bitwise:
        if not (torch.equal(lg, lw) and torch.equal(got["tokens"], want["tokens"])):
            fail(f"mesh {what}: logits or tokens differ from the one-process run")
        return {"kv_rel": kv, "logits": 0.0, "argmax_differs": []}
    worst = float((lg - lw).abs().max())
    if not worst <= LM_LOGITS_TOL:
        fail(f"mesh {what}: teacher-forced logits differ from the one-process run by {worst} > "
             f"{LM_LOGITS_TOL}")
    tw = want["tokens"][rows]
    differs = []
    for i, t in (lg.argmax(-1).T != tw).nonzero().tolist():
        top2 = torch.topk(lw[t, i], 2).values.tolist()
        if not top2[0] - top2[1] <= LM_LOGITS_TOL:
            fail(f"mesh {what}: row {i}'s argmax at step {t} is not the reference's token, whose "
                 f"top-2 logits {top2} are more than {LM_LOGITS_TOL} apart")
        differs.append([i, t, top2[0] - top2[1]])
    flips, worst_gap = 0, 0.0
    k = want["top_k"]
    for own, ref_e, ref_p in zip(got["routes"], want["routes"], want["probs"]):
        _, gaps = routing_flips(own, ref_e, ref_p, k)
        flips += int(gaps.numel())
        worst_gap = max([worst_gap, *gaps.tolist()])
    if not worst_gap <= MOE_FLIP_GAP:
        fail(f"mesh {what}: the rank's router would pick other experts than the reference's "
             f"where they are {worst_gap} apart (> {MOE_FLIP_GAP})")
    if len(got["routes"]) != len(want["routes"]):
        fail(f"mesh {what}: {len(got['routes'])} router calls, the reference made "
             f"{len(want['routes'])}")
    return {"kv_rel": kv, "logits": worst, "argmax_differs": differs,
            "would_flip": [flips, worst_gap]}


def mesh_ranks_agree(torch, what: str, outs: list, groups) -> None:
    """Every rank's tokens and routing bit-identical with rank 0's, and its
    logits with those of the ranks that hold its rows (``groups``: lists of
    ranks that share rows)."""
    for r, o in enumerate(outs):
        if not torch.equal(o["tokens"], outs[0]["tokens"]):
            fail(f"mesh {what}: rank {r}'s tokens differ from rank 0's")
        if len(o["routes"]) != len(outs[0]["routes"]) or any(
                not torch.equal(a, b) for a, b in zip(o["routes"], outs[0]["routes"])):
            fail(f"mesh {what}: rank {r}'s routing differs from rank 0's")
    for grp in groups:
        for r in grp[1:]:
            if not torch.equal(outs[r]["logits"], outs[grp[0]]["logits"]):
                fail(f"mesh {what}: rank {r}'s logits differ from rank {grp[0]}'s")


def phase_mesh(torch, dev, seed: int, flush, work: str) -> tuple[dict, dict]:
    """The LM and recsys families over (data, model) meshes of ranks
    placed by ``launch/sharding.py``'s rules. (a) One gloo world of 4 ranks
    on this card: mixtral-8x7b at full width at (1, 4) (2 layers, 2 x 8192
    prompt, 16 greedy tokens), at (2, 2) (1 layer, 2 x 2048, 4 tokens) and
    a batch-1 decode of 2 steps at (4, 1) (1 layer) over a 16,384-position cache
    split by sequence, each held to the one-process port at the same cut
    and weights (run first and freed): logits, KV blocks, tokens, and every
    rank's tokens, routing and logits against rank 0's. (b) In the same
    world, two-tower at serve_bulk and DIN at serve_p99 with tables
    row-sharded over the 4 ranks: bags within twice ``ref.embedding_bag_
    error_bound``, two-tower's top-100 identical up to tie swaps, DIN's
    logits within 1e-4 * max(1, |ref|). (c) The flash kernel at the (1, 4)
    rank's shapes and the bag kernel at rank 0's row range, each against
    its plain version and timed. (d) An NCCL world of min(cards, 4) ranks
    runs (a)'s (1, 4) check (one card: a (1, 1) world, bit for bit). (e)
    ``dryrun.run_cell`` of mixtral's decode_32k over 4 gloo ranks: its
    collectives per op as the layers imply, 0 < MFU <= 1.05. Returns the
    kernels rows' mesh entries (row 4e, row 5-rank)."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag import work as bag_work
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention import work as flash_work
    from repro_torch.launch import dryrun
    from repro_torch.launch.ranks import run_world
    from repro_torch.models import KVCache, TransformerLM, init_params, serve_step
    from repro_torch.models.recsys import RECSYS_MODELS

    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    spec = {"lm": [], "seq": None, "recsys": []}
    refs = {}
    # (a) the one-process references, each freed before the next
    for i, (tag, shape, layers, b, s, n) in enumerate(MESH_LM):
        t0 = time.perf_counter()
        cfg = mesh_lm_config(layers)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + i)
        model = TransformerLM.from_params(cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16))
        prompt = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
        routes = []
        logits, toks, (k, v) = mesh_generate(torch, model, prompt, n, b, routes)
        torch.cuda.synchronize()
        refs[tag] = {"logits": logits.cpu(), "tokens": toks.cpu(), "k": k.cpu(), "v": v.cpu(),
                     "routes": [e.cpu() for e, _ in routes], "probs": [p.cpu() for _, p in routes]}
        path = os.path.join(work, f"{tag}_prompt.pt")
        torch.save(prompt.cpu(), path)
        forced = os.path.join(work, f"{tag}_forced.pt")
        torch.save({"tokens": refs[tag]["tokens"], "routes": refs[tag]["routes"]}, forced)
        spec["lm"].append({"tag": tag, "mesh": list(shape), "layers": layers, "seed": seed + i,
                           "prompt": path, "new": n, "forced": forced})
        del model, logits, k, v, prompt
        gc_cuda(torch, dev)
        log(f"[mesh] one-process reference {tag}: mixtral-8x7b {layers} of 32 layers, prompt "
            f"{b} x {s}, {n} greedy tokens, in {time.perf_counter() - t0:.1f}s")
    tag, shape, layers, positions, n = MESH_SEQ
    cfg = mesh_lm_config(layers)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 10)
    model = TransformerLM.from_params(cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16))
    prompt = torch.randint(0, cfg.vocab, (1, positions - n), generator=g, device=dev)
    cache = KVCache.empty(cfg, 1, positions, device=dev)
    logits, cache = model.prefill(prompt, cache)
    torch.save({"k": cache.k.cpu(), "v": cache.v.cpu(), "length": cache.length.cpu()},
               os.path.join(work, "seq_cache.pt"))
    forced = [logits.argmax(-1)]
    seq_logits = []
    for _ in range(n):
        logits, cache = model.decode_step(forced[-1], cache)
        seq_logits.append(logits.float())
        forced.append(logits.argmax(-1))
    forced = torch.stack(forced[:n])
    torch.save(forced.cpu(), os.path.join(work, "seq_forced.pt"))
    refs[tag] = {"logits": torch.stack(seq_logits).cpu()}
    spec["seq"] = {"tag": tag, "mesh": list(shape), "layers": layers, "seed": seed + 10,
                   "cache": os.path.join(work, "seq_cache.pt"),
                   "forced": os.path.join(work, "seq_forced.pt")}
    del model, cache, prompt, logits
    gc_cuda(torch, dev)
    # (b)'s references: the outputs, the bags and their limits
    rank_bag = {}
    for i, (arch, shape_name) in enumerate(MESH_RECSYS):
        cfg, rshape = get_arch(arch).config, RECSYS_SHAPES[shape_name]
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 20 + i)
        batch = recsys_batch(torch, cfg, rshape, g, dev)
        params = init_params(cfg, g, device=dev)
        model = RECSYS_MODELS[type(cfg)].from_params(cfg, params)
        r = {"out": serve_step(model, rshape)(batch).cpu()}
        if arch == "two-tower-retrieval":
            r["bags"], r["limit"] = {}, {}
            with torch.inference_mode():
                for side in ("user", "item"):
                    table, ids, w = params[f"{side}_table"], batch[f"{side}_ids"], batch[f"{side}_mask"]
                    r["bags"][side] = model._bag(f"{side}_table", ids, w).cpu()
                    r["limit"][side] = (2 * ref.embedding_bag_error_bound(table, ids, w)).cpu()
            # (c)'s bag row: rank 0's row range of the user table, ids as the model passes them.
            rows = cfg.user_vocab // MESH_RANKS
            ids = batch["user_ids"]
            own = (ids >= 0) & (ids < rows)
            rank_bag = {"table": params["user_table"][:rows].clone(),
                        "ids": torch.where(own, ids, -1),
                        "w": torch.where(own, batch["user_mask"], 0.0).contiguous()}
        refs[f"rs_{arch}"] = r
        spec["recsys"].append({"arch": arch, "shape": shape_name, "mesh": [1, MESH_RANKS],
                               "seed": seed + 20 + i})
        del model, params, batch
        gc_cuda(torch, dev)
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t_refs = time.perf_counter() - t_phase

    # (a) + (b): one gloo world of 4 ranks on this card
    t0 = time.perf_counter()
    out_dir = os.path.join(work, "gloo")
    os.makedirs(out_dir)
    run_world(mesh_world, MESH_RANKS, backend="gloo", device=mesh_device(dev),
              args=(spec_path, out_dir), join_timeout_s=MESH_JOIN_S)
    t_world = time.perf_counter() - t0

    def load(name, n_ranks=MESH_RANKS, where=out_dir):
        return [torch.load(os.path.join(where, f"{name}_rank{r}.pt")) for r in range(n_ranks)]

    def ran(o):  # the kernels a rank launched on its run's path
        return {k: c for k, c in o["launches"].items() if c}

    launches, report = {}, {}
    for tag, shape, layers, b, s, n in MESH_LM:
        outs = load(tag)
        d, m = shape
        groups = [list(range(i * m, (i + 1) * m)) for i in range(d)]
        mesh_ranks_agree(torch, tag, outs, groups)
        cfg = mesh_lm_config(layers)
        want = refs[tag]
        for r, o in enumerate(outs):
            di, mi = divmod(r, m)
            per = b // d
            rows = slice(di * per, (di + 1) * per)
            hkv = max(1, cfg.n_kv_heads // m)
            first = mi * hkv if cfg.n_kv_heads >= m else mi // (m // cfg.n_kv_heads)
            w = dict(want, k=want["k"][:, rows, :, first:first + hkv],
                     v=want["v"][:, rows, :, first:first + hkv], top_k=cfg.moe.top_k)
            res = mesh_lm_check(torch, f"{tag} rank {r}", o, w, rows)
            if r == 0:
                report[tag] = res
        launches[tag] = [ran(o) for o in outs]
        fl = [o["launches"]["flash_attention"] for o in outs]
        if fl != [layers] * MESH_RANKS:
            fail(f"mesh {tag}: flash launches per rank {fl}, expected one per layer ({layers})")
        log(f"[mesh] {tag} gloo on one card, teacher-forced in tokens and routing: rank 0 vs "
            f"one-process: {json.dumps(report[tag])}; "
            f"flash launches per rank {fl}; rank walls (s) {[round(o['wall_s'], 3) for o in outs]}, "
            f"weights made in {[round(o['made_s'], 1) for o in outs]} s, peaks (GB) "
            f"{[round(o['peak'] / 1e9, 2) for o in outs]}; every rank's tokens and routing equal "
            f"rank 0's")
        del outs
    tag = MESH_SEQ[0]
    outs = load(tag)
    want = refs[tag]["logits"]
    worst, flips = 0.0, []
    for r, o in enumerate(outs):
        if not torch.equal(o["logits"], outs[0]["logits"]):
            fail(f"mesh {tag}: rank {r}'s logits differ from rank 0's")
        worst = max(worst, float((o["logits"] - want).abs().max()))
    for t in range(want.shape[0]):
        a_, b_ = int(outs[0]["logits"][t].argmax()), int(want[t].argmax())
        if a_ != b_:
            top2 = torch.topk(want[t, 0], 2).values.tolist()
            if not top2[0] - top2[1] <= LM_LOGITS_TOL:
                fail(f"mesh {tag}: step {t}'s token differs at a top-2 gap of {top2}")
            flips.append(t)
    if not worst <= LM_LOGITS_TOL:
        fail(f"mesh {tag}: the sequence-split decode's logits differ by {worst} > {LM_LOGITS_TOL}")
    launches[tag] = [ran(o) for o in outs]
    log(f"[mesh] {tag} decode over {MESH_SEQ[3]} positions split by sequence over 4 ranks, "
        f"{MESH_SEQ[4]} steps teacher-forced: logits max abs diff {worst} (limit "
        f"{LM_LOGITS_TOL}), greedy token differs at steps {flips}; rank walls (s) "
        f"{[round(o['wall_s'], 3) for o in outs]}")
    del outs
    for arch, shape_name in MESH_RECSYS:
        outs = load(f"rs_{arch}")
        want = refs[f"rs_{arch}"]
        for r, o in enumerate(outs):
            if not torch.equal(o["out"], outs[0]["out"]):
                fail(f"mesh {arch}: rank {r}'s output differs from rank 0's")
        got = outs[0]["out"]
        if arch == "two-tower-retrieval":
            for side in ("user", "item"):
                excess = float(((outs[0]["bags"][side] - want["bags"][side]).abs()
                                - want["limit"][side]).max())
                if not excess <= 0:
                    fail(f"mesh {arch}: the {side} bags differ by {excess} beyond twice the limit")
            k = RECSYS_TOPK
            top_g, top_w = torch.topk(got, k), torch.topk(want["out"], k)
            swaps = topk_swaps(f"mesh {arch} top-{k}", top_g.indices.numpy(), top_g.values.numpy(),
                               top_w.indices.numpy(), top_w.values.numpy(), 0.0,
                               tol=RECSYS_TT_TOL, tie=2 * RECSYS_TT_TOL)
            err = float((got - want["out"]).abs().max())
        else:
            err = float(((got - want["out"]).abs() / want["out"].abs().clamp(min=1)).max())
            if not err <= DIN_MESH_TOL:
                fail(f"mesh {arch}: logits differ by {err} x max(1, |ref|) > {DIN_MESH_TOL}")
            swaps = None
        bl = [o["launches"]["embedding_bag"] for o in outs]
        if min(bl) < 1:
            fail(f"mesh {arch}: bag launches per rank {bl}")
        launches[f"rs_{arch}"] = [ran(o) for o in outs]
        log(f"[mesh] {arch} {shape_name}, tables row-sharded over 4 ranks: max err {err}, top-k "
            f"swaps {swaps}, bag launches per rank {bl}, rank walls (s) "
            f"{[round(o['wall_s'], 4) for o in outs]}")
        del outs

    # (c) the kernel rows at the ranks' inputs
    tag, shape, layers, b, s, n = MESH_LM[0]
    cfg = mesh_lm_config(layers)
    m = shape[1]
    h, hkv = cfg.n_heads // m, max(1, cfg.n_kv_heads // m)
    dh, window = cfg.resolved_head_dim, cfg.sliding_window
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 30)
    q, k, v = (torch.randn(b, nh, s, dh, generator=g, device=dev).to(torch.bfloat16)
               for nh in (h, hkv, hkv))
    got = flash_attention_cuda(q, k, v, causal=True, window=window)
    want = ref.flash_attention(q, k, v, causal=True, window=window)
    err, excess = bf16_excess(torch, got, want)
    if not excess <= FLASH_BF16_ATOL:
        fail(f"mesh: the flash kernel at the rank's heads differs by {excess} beyond one bf16 ulp")
    ops_, nbytes = flash_work(b=b, h=h, hkv=hkv, sq=s, skv=s, dh=dh, itemsize=2, window=window)
    pos = torch.arange(s, device=dev)
    rel = pos.unsqueeze(1) - pos
    mask = (rel >= 0) & (rel < window)
    kr, vr = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / BF16_OPS_PER_S
    flash_row = {
        "shape": [b, h, hkv, s, dh], "window": window, "mesh": "1x4 rank",
        "launches": sum(x.get("flash_attention", 0) for x in launches[tag]),
        "max_abs_err": err,
        "ms": time_cuda(torch, lambda: flash_attention_cuda(q, k, v, causal=True, window=window), flush),
        "plain_ms": time_cuda(torch, lambda: ref.flash_attention(q, k, v, causal=True, window=window),
                              flush, iters=3),
        "library_ms": time_cuda(torch, lambda: sdpa(q, kr, vr, attn_mask=mask), flush),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    del q, k, v, kr, vr, mask, got, want
    table, ids, w = rank_bag["table"], rank_bag["ids"], rank_bag["w"]
    check = bag_check(torch, "rank 0's row range", table, ids, w)
    bs, bl_ = ids.shape
    needed = int(((ids >= 0) & (w != 0)).sum())  # rows in the rank's range, weight nonzero
    ops_, nbytes = bag_work(s=bs, l=bl_, d=table.shape[1], needed=needed,
                            index_bytes=ids.element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    lib = torch.nn.functional.embedding_bag
    lib_ids = ids.clamp(min=0)  # the same sums: every dropped id has weight 0
    bag_row = {
        "shape": [bs, bl_, table.shape[1], table.shape[0]], "mesh": "1x4 rank 0",
        "in_range": needed, "of": bs * bl_,
        "launches": sum(x.get("embedding_bag", 0) for x in launches["rs_two-tower-retrieval"]),
        "max_abs_err": check["max_abs_err"],
        "ms": time_cuda(torch, lambda: embedding_bag_cuda(table, ids, w), flush),
        "plain_ms": time_cuda(torch, lambda: ref.embedding_bag_bags(table, ids, w), flush, iters=5),
        "library_ms": time_cuda(torch, lambda: lib(lib_ids, table, per_sample_weights=w,
                                                   mode="sum"), flush),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    del table, ids, w, rank_bag, lib_ids
    gc_cuda(torch, dev)
    log(f"[mesh] row 4e (flash at a (1, 4) rank's heads): {json.dumps(flash_row)}; row 5-rank (the "
        f"bag on rank 0's quarter of the user table, bound over its {bag_row['in_range']} rows in "
        f"range of {bag_row['of']}): {json.dumps(bag_row)}; {card()}")

    # (d) NCCL: (a)'s (1, 4) check on min(cards, 4) ranks
    t0 = time.perf_counter()
    cards = min(torch.cuda.device_count(), MESH_RANKS)
    first = dict(spec["lm"][0], mesh=[1, cards])
    if cards == 1:  # a mesh of one runs free and must be the one-process run bit for bit
        first.pop("forced")
    nccl_spec = dict(spec, lm=[first], seq=None, recsys=[])
    nccl_path = os.path.join(work, "nccl.json")
    with open(nccl_path, "w") as f:
        json.dump(nccl_spec, f)
    nccl_dir = os.path.join(work, "nccl")
    os.makedirs(nccl_dir)
    run_world(mesh_world, cards, backend="nccl", args=(nccl_path, nccl_dir),
              join_timeout_s=MESH_JOIN_S)
    tag, shape, layers, b, s, n = MESH_LM[0]
    outs = load(tag, cards, nccl_dir)
    cfg = mesh_lm_config(layers)
    for r, o in enumerate(outs):
        hkv = max(1, cfg.n_kv_heads // cards)
        want = dict(refs[tag], k=refs[tag]["k"][:, :, :, r * hkv:(r + 1) * hkv],
                    v=refs[tag]["v"][:, :, :, r * hkv:(r + 1) * hkv], top_k=cfg.moe.top_k)
        res = mesh_lm_check(torch, f"nccl {cards} rank {r}", o, want, slice(0, b),
                            bitwise=cards == 1)
    if cards > 1:
        mesh_ranks_agree(torch, "nccl", outs, [list(range(cards))])
    log(f"[mesh] NCCL world of {cards} rank(s), mesh (1, {cards}): "
        + ("bit for bit the one-process run" if cards == 1 else json.dumps(res))
        + f"; flash launches per rank {[o['launches']['flash_attention'] for o in outs]}; "
        f"{time.perf_counter() - t0:.1f}s")
    del outs, refs

    # (e) the dry run over 4 gloo ranks on this card
    t0 = time.perf_counter()
    arch = get_arch("mixtral-8x7b")
    cut = dataclasses.replace(arch, config=mesh_lm_config(MESH_DRYRUN_LAYERS))
    rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", device=mesh_device(dev), ranks=4,
                          backend="gloo", arch=cut, iters=3, verbose=False)
    want_counts = {"all-reduce": 2 * MESH_DRYRUN_LAYERS, "all-gather": 2}
    if rec["collectives"]["counts"] != want_counts:
        fail(f"mesh dryrun: collectives {rec['collectives']['counts']}, the layers imply "
             f"{want_counts}")
    mfu = rec["measured"]["mfu"]
    if not 0 < mfu <= MESH_MFU_MAX:
        fail(f"mesh dryrun: MFU {mfu} outside (0, {MESH_MFU_MAX}]")
    log(f"[mesh] dryrun mixtral-8x7b/decode_32k over 4 gloo ranks on one card, "
        f"{MESH_DRYRUN_LAYERS} layers (cut: {rec['reduced']}): p50 {rec['measured']['p50_ms']:.3f} ms, "
        f"MFU {mfu:.6f} over 4 devices, collectives {json.dumps(rec['collectives'])}, bound "
        f"{rec['roofline']['step_lower_bound_s'] * 1e3:.3f} ms ({rec['roofline']['bottleneck']}), "
        f"{time.perf_counter() - t0:.1f}s")
    elapsed = time.perf_counter() - t_phase
    log(f"[mesh] phase took {elapsed:.1f}s (references {t_refs:.1f}s, gloo world {t_world:.1f}s); "
        f"launches per run and rank {json.dumps(launches)}; {card()}")
    if elapsed > MESH_BUDGET_S * 1.5:
        log(f"[mesh] over its budget of {MESH_BUDGET_S:.0f}s")
    return flash_row, bag_row


# ---------------------------------------------------------------------------
# the mesh_train phase: the LM and recsys families trained over meshes of ranks
# ---------------------------------------------------------------------------

# Four gloo ranks on this card train each run for MESH_TRAIN_STEPS steps on
# one repeated global batch, from weights every rank draws alike (each keeps
# its blocks), TRAIN_OPT, each config's bf16 compute and remat (float32 for
# the recsys models). The LM runs take MESH_TRAIN_SEQ tokens a row (train_4k's
# 4096 until the encoder_train phase needed the time: their logits and
# activations cross the host in every collective). qwen2 takes a global batch of 4
# in 2 microbatches (one row a rank a microbatch: 4 ranks' float32 logits
# of 151,936 columns share the card); mixtral one layer at full width at
# the one-card train phase's 2 rows, one a data rank, in one microbatch (2
# microbatches of 1 row do not split over 2 data ranks, and a batch of 4
# doubles the expert blocks every step moves through the host), with fsdp
# experts and with tp_only experts, local dispatch and ZeRO-1 moments. two-tower is cut to 16,384 rows: every rank of the
# (1, 4) mesh holds the [B, B] in-batch softmax, a quarter of the one-card
# 32,768 run's memory at this batch. Resume: a checkpoint after step
# MESH_TRAIN_RESUME[0], a failure injected at step index MESH_TRAIN_RESUME[1]
# (every run), and the resume, for qwen2 (2.0 GB at 2 layers) and DIN: a mixtral
# layer's state is 20.6 GB whole and two-tower's 28.7 GB, each written to
# the machine's temporary directory and read back by four ranks, more than
# the script's 1200 s leave room for (their resumes over a mesh are held on
# the CPU by tests/test_torch_mesh_train_*.py).
# qwen2 runs 2 of its 24 layers: its rank steps and its checkpoint and
# resume at 24 took 26.0 + 17.0 + 17.5 s and 8.74 + 20.05 s, and the
# script must end inside its 1200 s on a slower host too.
MESH_TRAIN_SEQ = 2048
MESH_TRAIN_RUNS = (  # tag, arch, layers (None: all), batch, microbatches, mesh, overrides, resume
    ("qwen2", "qwen2-0.5b", 2, 4, 2, (2, 2), {}, True),
    ("mixtral_fsdp", "mixtral-8x7b", 1, 2, 1, (2, 2), {}, False),
    ("mixtral_tp", "mixtral-8x7b", 1, 2, 1, (2, 2),
     {"moe_weight_mode": "tp_only", "local_dispatch": True}, False),
)
MESH_TRAIN_RECSYS = (  # tag, arch, batch, mesh, resume
    ("two-tower", "two-tower-retrieval", 16_384, (1, 4), False),
    ("din", "din", 65_536, (2, 2), True),
)
# gin-tu at its CONFIG (5 layers, d_hidden 64) on full GNN_SHAPES: the
# graph drawn as the gnn phase draws it (minibatch_lg's 59,474 padding
# edges at the end of the edge arrays, so on the last data rank). Every
# node and edge array over the data axes, the parameters replicated.
# ogb_products stays out: gloo moves ~0.6 GB/s, and its 980 MB gather of x
# and 627 MB [N, 64] collectives a layer would take ~25-30 s a step
# (``scripts/mesh_smoke.py --train`` runs it over four cards, NCCL).
MESH_TRAIN_GNN = (  # tag, shape, mesh, resume
    ("gin_full_graph_sm", "full_graph_sm", (2, 2), False),
    ("gin_minibatch_lg", "minibatch_lg", (4, 1), False),
    ("gin_molecule", "molecule", (2, 2), True),
)
MESH_TRAIN_STEPS = 3
# Step 1's collectives per op, recorded: each run's must equal its entry,
# and so must launch.cost.mesh_train_collectives (the formula PERF.md
# states), so that a change to the collectives changes a number here.
MESH_TRAIN_COUNTS = {
    "qwen2": {"all-gather": 12, "all-reduce": 26, "reduce-scatter": 4},
    "mixtral_fsdp": {"all-gather": 7, "all-reduce": 11, "reduce-scatter": 3},
    "mixtral_tp": {"all-gather": 13, "all-reduce": 11, "reduce-scatter": 10},
    "two-tower": {"all-reduce": 3},
    "din": {"all-reduce": 7},
    "dryrun": {"all-gather": 6, "all-reduce": 14, "reduce-scatter": 2},
    "gin_full_graph_sm": {"all-gather": 9, "all-reduce": 3, "reduce-scatter": 9},
    "gin_minibatch_lg": {"all-gather": 9, "all-reduce": 3, "reduce-scatter": 9},
    "gin_molecule": {"all-gather": 10, "all-reduce": 3, "reduce-scatter": 10},
}
MESH_TRAIN_RESUME = (2, 2)  # checkpoint after step 2, a failure injected at step index 2
# The LM over the mesh against one process: the TP and FSDP sums round in
# another order and bf16 products run at other shapes, as microbatches 2 vs
# 1 do on one card (TRAIN_MB_*): step-1 loss and grad_norm, relative.
MESH_TRAIN_LOSS_TOL = 2.0 ** -7
MESH_TRAIN_GNORM_TOL = 2.0 ** -5
# The recsys models in float32: losses relative; the step-1 gradients,
# teacher-forced (the bags' forward values the one-process reference
# executor's, on each data rank's rows), each tensor within this of its norm.
MESH_TRAIN_RECSYS_TOL = 1e-5
# gin-tu in float32: the step-1 loss relative, and the step-1 gradients
# (the same state and batch: GIN has no kernel, so nothing to force) each
# within this of its tensor's norm.
MESH_TRAIN_GNN_TOL = 1e-5
# The dry run: qwen2-0.5b's train_4k at 2 layers, a batch of 4 in one
# microbatch, as the world's qwen2 run. mixtral's (one layer, tp_only with
# local dispatch, as the world's mixtral_tp run) took 75.7 s, its two steps
# moving the layer's weights through the host; the script must end inside
# its 1200 s on a slower host too.
MESH_TRAIN_DRYRUN = ("qwen2-0.5b", "train_4k", 2, 4, (2, 2))  # arch, shape, layers, batch, mesh
MESH_TRAIN_JOIN_S = 900.0
MESH_TRAIN_BUDGET_S = 300.0
# gin-tu's runs (their one-process references, and rank 0's runs in the
# world); the phase fails past it.
MESH_TRAIN_GNN_BUDGET_S = 120.0


def mesh_train_config(run: dict):
    """The run's config: the arch at full width, its depth and overrides."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(run["arch"]).config
    over = dict(run.get("overrides") or {})
    if over.pop("local_dispatch", False):
        over["moe"] = dataclasses.replace(cfg.moe, local_dispatch=True)
    if run.get("layers"):
        over["n_layers"] = run["layers"]
    return dataclasses.replace(cfg, **over)


def mesh_train_run_config(run: dict):
    """A run's config: the LM's by ``mesh_train_config``, gin-tu's at its
    shape, the recsys arch's own."""
    from repro_torch.configs.families import GNN_SHAPES
    from repro_torch.configs.registry import get_arch

    if run["kind"] == "lm":
        return mesh_train_config(run)
    arch = get_arch(run["arch"])
    if run["kind"] == "gnn":
        return arch.family._cfg_for(arch, GNN_SHAPES[run["shape"]], reduced=False)
    return arch.config


def mesh_train_step(run: dict, loss_fn, mesh=None, layout=None):
    """A run's train step: gin-tu's through its family's entry point
    (``GNNFamily.step_fn``, the family's AdamW: lr 3e-4 after 100 warmup
    steps, as a gin-tu cell trains), the others ``make_train_step`` at
    TRAIN_OPT; over ``mesh`` / ``layout`` a rank's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.train import AdamWConfig, make_train_step

    if run["kind"] == "gnn":
        arch = get_arch(run["arch"])
        return arch.family.step_fn(arch, run["shape"], mesh=mesh)
    return make_train_step(loss_fn, AdamWConfig(**TRAIN_OPT), microbatches=run["microbatches"],
                           layout=layout)


def fingerprint(torch, t) -> list:
    """The exact int64 sum of a tensor's bit patterns and the float64 sum
    of its squares, with no temporary larger than the tensor: equal
    tensors give equal fingerprints."""
    t = t.detach()
    bits = t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)
    return [int(torch.sum(bits, dtype=torch.int64)),
            float(torch.sum(t.float().square(), dtype=torch.float64))]


def block_key(name: str, layout) -> tuple:
    """Which block of ``name``'s parameter this rank holds: its position
    along each axis its spec names (for a kv head shared by model ranks,
    the head's)."""
    mesh = layout.mesh
    key = []
    for p in layout.param_specs[name]:
        if p is None:
            continue
        i = mesh.index_of(p)
        if p == ("model",) and layout.kv_shared(name) > 1:
            i //= layout.kv_shared(name)
        key.append(i)
    return tuple(key)


def state_prints(torch, state) -> dict:
    from repro_torch.train.checkpoint import flatten

    return {k: fingerprint(torch, v) for k, v in flatten(state)}


def meta_state(torch, state):
    """``state``'s structure on the meta device: a template to restore into
    once the state itself is freed."""
    from torch import nn

    from repro_torch.train import TrainState

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def tree(d):
        return None if d is None else {k: meta(v) for k, v in d.items()}

    return TrainState(params={k: nn.Parameter(meta(v)) for k, v in state.params.items()},
                      opt={"m": tree(state.opt["m"]), "v": tree(state.opt["v"]),
                           "step": meta(state.opt["step"])}, error_fb=tree(state.error_fb))


def mesh_train_world(group, spec_path: str, out_dir: str) -> None:
    """One rank of the mesh_train phase's world: each run of the spec on its
    mesh, weights drawn as the one-process reference drew them (each rank
    keeps its blocks), the kernel launches counted from 0 over the run's
    steps; step 1 counted (collectives per op), its synced gradients checked
    per block (finite, not all zero), every parameter's fingerprint after
    every step (so the parent checks replicated blocks alike), the resume
    from a checkpoint after a failure injected at step index 2. Recsys runs
    also give their teacher-forced step-1 gradients against the reference's
    (rows the batch names, and every dense tensor); DIN's rank 0 saves its
    bag kernels' inputs."""
    from unittest import mock

    import torch

    from repro_torch.configs.families import GNN_SHAPES, gnn_loss_fn, lm_loss_fn, recsys_loss_fn
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import init_params
    from repro_torch.models import recsys as rs
    from repro_torch.models.convert import train_layout
    from repro_torch.train import FailureInjector, TrainState, restore_checkpoint, save_checkpoint
    from repro_torch.train import loop
    from repro_torch.train.loop import shard_batch, sync_grads

    with open(spec_path) as f:
        spec = json.load(f)
    dev, r = group.device, group.rank

    def sync():
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None

    for run in spec["runs"]:
        mesh = group.mesh(tuple(run["mesh"]))
        lm, gnn = run["kind"] == "lm", run["kind"] == "gnn"
        cfg = mesh_train_run_config(run)
        layout = train_layout(cfg, mesh)
        mb = run["microbatches"]
        t0 = time.perf_counter()
        g = torch.Generator(device=dev)
        g.manual_seed(run["seed"])
        if gnn:  # the weights drawn first, the graph as the reference drew it
            params = init_params(cfg, g, device=dev, mesh=mesh)
            batch = {k: v.to(dev) for k, v in shard_batch(torch.load(run["batch"]), mesh).items()}
        else:
            if lm:
                batch = {k: v.to(dev) for k, v in torch.load(run["batch"]).items()}
            else:
                batch = recsys_train_batch(torch, cfg, run["batch_rows"], g, dev)
            params = init_params(cfg, g, device=dev, mesh=mesh)
            batch = shard_batch(batch, mesh, mb)
        made = time.perf_counter() - t0
        res = {"metrics": [], "prints": [], "walls": [], "made_s": made,
               "keys": {k: block_key(k, layout) for k in params},
               "executor": "kernel" if dev.type == "cuda" else "reference"}

        def loss_fn():
            if gnn:
                return gnn_loss_fn(cfg, GNN_SHAPES[run["shape"]].n_graphs, mesh)
            return lm_loss_fn(cfg, mesh) if lm else recsys_loss_fn(cfg, mesh)

        if run["kind"] == "recsys":  # the teacher-forced step-1 gradients and DIN's bag inputs
            ref = torch.load(run["ref"], map_location=dev)
            forced = ref["forced"][mesh.index_of(data_axes(mesh))]
            p = {k: torch.nn.Parameter(v) for k, v in params.items()}
            model = rs.RECSYS_MODELS[type(cfg)].from_params(cfg, p, trainable=True, mesh=mesh)
            bag = type(model)._bag
            seen = {}

            def forced_bag(self, name, ids, weights):
                out = bag(self, name, ids, weights)
                return forced[name].detach() + (out - out.detach())

            raw = rs.ops.embedding_bag

            def capture(table, *, bag_indices, bag_weights, use_kernel):
                out = raw(table, bag_indices=bag_indices, bag_weights=bag_weights,
                          use_kernel=use_kernel)
                if r == 0 and run["capture"] and "ids" not in seen:
                    seen.update(table=table.detach().clone(), ids=bag_indices.clone(),
                                w=bag_weights.detach().clone())
                    out.register_hook(lambda gr: seen.setdefault("g", gr.detach().clone()))
                return out

            with mock.patch.object(type(model), "_bag", forced_bag), \
                    mock.patch.object(rs.ops, "embedding_bag", capture):
                loss, _ = model.loss(batch)
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            grads = sync_grads(grads, layout)
            cmp = {}
            for k, gk in grads.items():
                if k in ref["rows"]:
                    ids, want = ref["rows"][k]
                    start = mesh.index_of(("model",)) * gk.shape[0]
                    own = (ids >= start) & (ids < start + gk.shape[0])
                    got = gk[ids[own] - start]
                    rest = gk.clone()
                    rest[ids[own] - start] = 0
                    cmp[k] = [float((got - want[own]).square().sum()), float(want[own].square().sum()),
                              bool(rest.any()), bool(torch.isfinite(gk).all()), bool(gk.any())]
                else:
                    want = ref["dense"][k]
                    cmp[k] = [float((gk - want).square().sum()), float(want.square().sum()), False,
                              bool(torch.isfinite(gk).all()), bool(gk.any())]
            res["forced"] = {"loss": float(loss.detach()), "grads": cmp,
                             "replicas": {k: layout.grad_replicas(k) for k in grads}}
            if seen:
                torch.save({k: v.cpu() for k, v in seen.items()}, os.path.join(out_dir, "din_bag.pt"))
            del model, p, grads, ref, forced, loss
            gc_cuda(torch, dev)

        state = TrainState.create(params, layout=layout)
        step = mesh_train_step(run, loss_fn(), mesh, layout)
        ckdir = os.path.join(run["work"], run["tag"])
        every, dies = MESH_TRAIN_RESUME
        inj = FailureInjector(fail_at=(dies,))
        checked = {}
        sync_grads_ = loop.sync_grads
        first = None
        if gnn:  # step 1's gradients (whole: replicated) against the reference's
            loss, _ = loss_fn()(state.params, batch)
            first = sync_grads(dict(zip(state.params, torch.autograd.grad(
                loss, list(state.params.values())))), layout)
            want = torch.load(run["ref"], map_location=dev)
            res["gnn"] = {"loss": float(loss.detach()),
                          "grads": {k: [float((v - want[k]).square().sum()),
                                        float(want[k].square().sum())] for k, v in first.items()}}
            del loss, want

        def grad_check(grads, lay):  # step 1's synced gradients, per block
            out = sync_grads_(grads, lay)
            if not checked:
                checked.update({k: [bool(torch.isfinite(v).all()), bool(v.any())]
                                for k, v in out.items()})
                if first is not None:  # the step's own computation, bit for bit the one above
                    res["gnn"]["twice_equal"] = all(torch.equal(out[k], first[k]) for k in out)
            return out

        sync()
        reset_launches()  # the path starts here
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        for s in range(MESH_TRAIN_STEPS):
            try:
                inj.maybe_fail(s)
            except RuntimeError as e:  # the unbroken run goes on; the resumed one is held to it
                res["failed_at"] = [s, str(e)]
            t1 = time.perf_counter()
            with mock.patch.object(loop, "sync_grads", grad_check):
                if s == 0:
                    with cost.StepCost() as c:
                        state, m = step(state, batch)
                    res["counts"] = dict(c.op_counts)
                else:
                    state, m = step(state, batch)
            sync()
            res["walls"].append(time.perf_counter() - t1)
            gc_cuda(torch, dev)  # the step's cached blocks back to the card the ranks share
            res["metrics"].append({k: float(v) for k, v in m.items()})
            res["prints"].append({k: fingerprint(torch, v) for k, v in state.params.items()})
            if run["resume"] and s + 1 == every:
                t1 = time.perf_counter()
                save_checkpoint(ckdir, every, state, layout=layout)
                res["save_s"] = time.perf_counter() - t1
        res["launches"] = dict(LAUNCHES)
        res["peak"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        res["grad_ok"] = checked
        if run["resume"]:
            final = state_prints(torch, state)
            template = meta_state(torch, state)
            del state
            gc_cuda(torch, dev)
            t1 = time.perf_counter()
            restored, at = restore_checkpoint(ckdir, template, every, dev, layout=layout)
            step = mesh_train_step(run, loss_fn(), mesh, layout)
            for _ in range(at, MESH_TRAIN_STEPS):
                restored, _m = step(restored, batch)
            sync()
            again = state_prints(torch, restored)
            res["resume"] = {"from": at, "equal": again == final,
                             "differs": [k for k in final if again.get(k) != final[k]][:5],
                             "s": time.perf_counter() - t1}
            del restored
        else:
            del state
        res["run_s"] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"{run['tag']}_rank{r}.pt"))
        del step, params, batch, first
        gc_cuda(torch, dev)


def recsys_forced_reference(torch, cfg, params, batch, d: int, mb: int = 1) -> dict:
    """The one-process port's teacher-forced step-1 gradients of a recsys
    model (the kernel executor, each bag's forward value the reference
    executor's, ``forced_bags``) as ``d`` data ranks compute them: the
    forward on each rank's rows (``shard_batch``'s blocks), the losses
    summed over the blocks / d (the global mean: the blocks' sizes are
    powers of two, so each row's gradient is scaled alike). Returns
    {"loss", "grads", "forced": per block {table: bag values}}."""
    from repro_torch.models.recsys import RECSYS_MODELS

    p = {k: torch.nn.Parameter(v) for k, v in params.items()}
    model = RECSYS_MODELS[type(cfg)].from_params(cfg, p, trainable=True)
    model.executor = "kernel"
    forced_bags(torch, model)
    bag = model._bag
    rows = next(iter(batch.values())).shape[0] // d
    total, forced = 0.0, []
    for i in range(d):
        rec = {}

        def recording(name, ids, weights, rec=rec):
            out = bag(name, ids, weights)
            rec[name] = out.detach().clone()
            return out

        model._bag = recording
        loss, _ = model.loss({k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
        total = total + loss / d
        forced.append(rec)
    grads = dict(zip(p, torch.autograd.grad(total, list(p.values()))))
    return {"loss": float(total.detach()), "grads": grads, "forced": forced}


def mesh_train_reference(torch, dev, run: dict, tmp: str) -> dict:
    """The one-process port on the run's state and batch: MESH_TRAIN_STEPS
    steps (metrics), and for a recsys model the teacher-forced step-1
    gradients, saved for the ranks (a table's at the rows the batch names);
    for gin-tu the step-1 gradients and the graph, saved for the ranks."""
    from repro_torch.configs.families import GNN_SHAPES, gnn_loss_fn, lm_loss_fn, recsys_loss_fn
    from repro_torch.models import init_params
    from repro_torch.train import TrainState

    lm, gnn = run["kind"] == "lm", run["kind"] == "gnn"
    cfg = mesh_train_run_config(run)
    g = torch.Generator(device=dev)
    g.manual_seed(run["seed"])
    out = {}
    if gnn:  # the weights first, then the graph as the gnn phase draws it
        s = GNN_SHAPES[run["shape"]]
        params = init_params(cfg, g, device=dev)
        batch = gnn_batch(torch, run["shape"], s, g, dev, run["seed"])
        torch.save({k: v.cpu() for k, v in batch.items()}, run["batch"])
        loss_fn = gnn_loss_fn(cfg, s.n_graphs)
        p = {k: torch.nn.Parameter(v) for k, v in params.items()}
        loss, _ = loss_fn(p, batch)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        torch.save({k: v.cpu() for k, v in grads.items()}, run["ref"])
        out["grad_loss"] = float(loss.detach())
        del p, loss, grads
    else:
        if lm:
            batch = {k: v.to(dev) for k, v in torch.load(run["batch"]).items()}
        else:
            batch = recsys_train_batch(torch, cfg, run["batch_rows"], g, dev)
        params = init_params(cfg, g, device=dev)
        loss_fn = lm_loss_fn(cfg) if lm else recsys_loss_fn(cfg)
    if run["kind"] == "recsys":
        d = run["mesh"][0]
        f = recsys_forced_reference(torch, cfg, params, batch, d)
        tables = TABLE_IDS[type(cfg).__name__]
        rows, dense = {}, {}
        for k, gk in f["grads"].items():
            if k in tables:
                ids = torch.unique(torch.cat([batch[n].reshape(-1).long() for n in tables[k]]))
                rows[k] = (ids, gk[ids])
            else:
                dense[k] = gk
        torch.save({"rows": rows, "dense": dense, "forced": f["forced"]}, run["ref"])
        out["forced_loss"] = f["loss"]
        out["grad_norms"] = {k: float(v.norm()) for k, v in f["grads"].items()}
        del f, rows, dense
    state = TrainState.create(params)
    step = mesh_train_step(run, loss_fn)
    metrics, walls = [], []
    for _ in range(MESH_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    out.update(metrics=metrics, walls=walls)
    del state, step, loss_fn, params, batch
    gc_cuda(torch, dev)
    return out


def mesh_train_check(torch, tag: str, outs: list, want: dict, run: dict, cfg) -> dict:
    """A run's ranks against the one-process reference and each other (see
    ``phase_mesh_train``); returns its report (rank 0's numbers)."""
    from repro_torch.launch.cost import mesh_train_collectives

    o0 = outs[0]
    for r, o in enumerate(outs):
        for s, (a, b) in enumerate(zip(o["metrics"], o0["metrics"])):
            if a != b:
                fail(f"mesh_train {tag}: rank {r}'s metrics at step {s + 1} differ from rank 0's")
        bad = [k for k, (finite, nonzero) in o["grad_ok"].items() if not (finite and nonzero)]
        if bad or not o["grad_ok"]:
            fail(f"mesh_train {tag}: rank {r}'s step-1 gradient blocks not finite or all zero: {bad}")
        if run["resume"] and not o["resume"]["equal"]:
            fail(f"mesh_train {tag}: rank {r}'s run resumed from step {o['resume']['from']} does "
                 f"not end bit for bit with the unbroken run ({o['resume']['differs']})")
        if "failed_at" not in o:
            fail(f"mesh_train {tag}: the failure injected at step index {MESH_TRAIN_RESUME[1]} "
                 "did not fire")
    for s in range(MESH_TRAIN_STEPS):  # replicated blocks alike on every rank that holds them
        for k in o0["prints"][s]:
            seen = {}
            for r, o in enumerate(outs):
                key = o["keys"][k]
                if key in seen and seen[key][1] != o["prints"][s][k]:
                    fail(f"mesh_train {tag}: {k}'s block {key} differs between ranks {seen[key][0]} "
                         f"and {r} after step {s + 1}")
                seen.setdefault(key, (r, o["prints"][s][k]))
    formula = mesh_train_collectives(cfg, tuple(run["mesh"]), microbatches=run["microbatches"],
                                     executor=o0["executor"])
    if not o0["counts"] == formula == MESH_TRAIN_COUNTS[tag]:
        fail(f"mesh_train {tag}: step 1 ran the collectives {o0['counts']}, the formula gives "
             f"{formula}, the recorded counts are {MESH_TRAIN_COUNTS[tag]}")
    got, ref = o0["metrics"], want["metrics"]
    losses = [m["loss"] for m in got]
    rel = {k: abs(got[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ("loss", "grad_norm")}
    if run["kind"] == "lm":
        if not rel["loss"] <= MESH_TRAIN_LOSS_TOL or not rel["grad_norm"] <= MESH_TRAIN_GNORM_TOL:
            fail(f"mesh_train {tag}: step 1 loss {rel['loss']}, grad_norm {rel['grad_norm']} "
                 f"relative to one process (limits {MESH_TRAIN_LOSS_TOL}, {MESH_TRAIN_GNORM_TOL})")
        if not losses[-1] < losses[0]:
            fail(f"mesh_train {tag}: the loss did not fall over {MESH_TRAIN_STEPS} steps: {losses}")
        forced = None
    elif run["kind"] == "gnn":
        if not rel["loss"] <= MESH_TRAIN_GNN_TOL:
            fail(f"mesh_train {tag}: step 1 loss {rel['loss']} relative to one process > "
                 f"{MESH_TRAIN_GNN_TOL}")
        if not losses[-1] < losses[0]:
            fail(f"mesh_train {tag}: the loss did not fall over {MESH_TRAIN_STEPS} steps: {losses}")
        g_loss = abs(o0["gnn"]["loss"] - want["grad_loss"]) / abs(want["grad_loss"])
        errs = {}
        for r, o in enumerate(outs):
            if not o["gnn"].get("twice_equal"):
                fail(f"mesh_train {tag}: rank {r}'s two step-1 gradient computations differ")
            for k, (diff, norm) in o["gnn"]["grads"].items():
                errs[k] = max(errs.get(k, 0.0), (diff / norm) ** 0.5 if norm else float(diff > 0))
        worst_k = max(errs, key=errs.get)
        if not (g_loss <= MESH_TRAIN_GNN_TOL and errs[worst_k] <= MESH_TRAIN_GNN_TOL):
            fail(f"mesh_train {tag}: step 1: loss {g_loss} relative, {worst_k}'s gradient "
                 f"{errs[worst_k]} of its norm (limit {MESH_TRAIN_GNN_TOL})")
        forced = {"loss": g_loss, "worst_grad": [worst_k, errs[worst_k]]}
    else:
        worst = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got, ref))
        if not worst <= MESH_TRAIN_RECSYS_TOL:
            fail(f"mesh_train {tag}: losses {worst} relative to one process > "
                 f"{MESH_TRAIN_RECSYS_TOL}")
        rel["losses"] = worst
        f_loss = abs(o0["forced"]["loss"] - want["forced_loss"]) / abs(want["forced_loss"])
        errs = {}
        for k in o0["forced"]["grads"]:
            diff = sum(o["forced"]["grads"][k][0] / o["forced"]["replicas"][k] for o in outs)
            norm = sum(o["forced"]["grads"][k][1] / o["forced"]["replicas"][k] for o in outs)
            errs[k] = (diff / norm) ** 0.5 if norm else float(diff > 0)
            for r, o in enumerate(outs):
                _, _, stray, finite, _ = o["forced"]["grads"][k]
                if stray or not finite:
                    fail(f"mesh_train {tag}: rank {r}'s {k} gradient is non-finite or off the "
                         "rows the batch names")
        worst_k = max(errs, key=errs.get)
        if not (f_loss <= MESH_TRAIN_RECSYS_TOL and errs[worst_k] <= MESH_TRAIN_RECSYS_TOL):
            fail(f"mesh_train {tag}: teacher-forced step 1: loss {f_loss} relative, {worst_k}'s "
                 f"gradient {errs[worst_k]} of its norm (limit {MESH_TRAIN_RECSYS_TOL})")
        forced = {"loss": f_loss, "worst_grad": [worst_k, errs[worst_k]]}
    return {"vs_one_process": rel, "losses": losses, "ref_losses": [m["loss"] for m in ref],
            "grad_norm": [got[0]["grad_norm"], ref[0]["grad_norm"]], "forced": forced,
            "counts": o0["counts"], "rank_step_s": [round(w, 3) for w in o0["walls"]],
            "one_process_step_s": [round(w, 3) for w in want["walls"]],
            "peak_gb": [round(o["peak"] / 1e9, 2) for o in outs],
            "made_s": round(o0["made_s"], 1), "save_s": o0.get("save_s"),
            "resume": o0.get("resume"), "run_s": round(o0["run_s"], 2)}


def phase_mesh_train(torch, dev, seed: int, flush, work: str) -> tuple[dict, dict]:
    """The LM, recsys and GNN families trained over (data, model) meshes of
    gloo ranks on this card (``MESH_TRAIN_RUNS``, ``MESH_TRAIN_RECSYS``,
    ``MESH_TRAIN_GNN``), each held to the one-process port on the same state
    and batch (run first, freed before the world): the LM's step-1 loss and
    grad_norm within MESH_TRAIN_*_TOL and a falling loss, the recsys models'
    losses within MESH_TRAIN_RECSYS_TOL and their teacher-forced step-1
    gradients within it of each tensor's norm, gin-tu's step-1 loss and
    gradients within MESH_TRAIN_GNN_TOL, its step-1 gradients computed twice
    bit for bit, a falling loss, its runs inside MESH_TRAIN_GNN_BUDGET_S;
    on every rank the metrics rank 0's, every
    block's step-1 gradient finite and not all zero, every replicated block
    alike after every step, step 1's collectives per op equal to
    ``launch.cost.mesh_train_collectives`` and to MESH_TRAIN_COUNTS; the
    resumed runs bit for bit.
    Then the bag kernels at DIN's rank 0 block (rows 5-rank-train and
    5b-rank, launches from the runs) against their plain versions, timed,
    and ``dryrun.run_cell`` of qwen2-0.5b train_4k over 4 gloo ranks at (2,
    2), two layers: its collectives the formula's, 0 < MFU <= 1.05. Returns the
    two rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels.embedding_bag import (
        embedding_bag_backward_cuda, embedding_bag_cuda, grad_table_work, grad_weights_work,
    )
    from repro_torch.kernels.embedding_bag import work as bag_work
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost import mesh_train_collectives
    from repro_torch.launch.ranks import run_world

    t_phase = time.perf_counter()
    os.makedirs(work, exist_ok=True)
    runs = []
    for i, (tag, arch, layers, b, mb, shape, over, resume) in enumerate(MESH_TRAIN_RUNS):
        cfg = mesh_train_config({"arch": arch, "layers": layers, "overrides": over})
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 50 + i)
        tokens = torch.randint(0, cfg.vocab, (b, MESH_TRAIN_SEQ), generator=g, device=dev)
        labels = tokens.clone()
        labels[0, : MESH_TRAIN_SEQ // 4] = -1  # masked labels in one row: the count is global
        path = os.path.join(work, f"{tag}_batch.pt")
        torch.save({"tokens": tokens.cpu(), "labels": labels.cpu()}, path)
        runs.append({"tag": tag, "kind": "lm", "arch": arch, "layers": layers, "overrides": over,
                     "microbatches": mb, "mesh": list(shape), "seed": seed + 60 + i,
                     "batch": path, "resume": resume, "work": work, "capture": False})
    for i, (tag, arch, b, shape, resume) in enumerate(MESH_TRAIN_RECSYS):
        runs.append({"tag": tag, "kind": "recsys", "arch": arch, "batch_rows": b,
                     "microbatches": 1, "mesh": list(shape), "seed": seed + 70 + i,
                     "ref": os.path.join(work, f"{tag}_ref.pt"), "resume": resume, "work": work,
                     "capture": tag == "din"})
    for i, (tag, shape, mesh_shape, resume) in enumerate(MESH_TRAIN_GNN):
        runs.append({"tag": tag, "kind": "gnn", "arch": "gin-tu", "shape": shape,
                     "microbatches": 1, "mesh": list(mesh_shape), "seed": seed + 80 + i,
                     "batch": os.path.join(work, f"{tag}_batch.pt"),
                     "ref": os.path.join(work, f"{tag}_ref.pt"), "resume": resume, "work": work,
                     "capture": False})
    refs, t_gnn = {}, 0.0
    for run in runs:
        t0 = time.perf_counter()
        refs[run["tag"]] = mesh_train_reference(torch, dev, run, work)
        if run["kind"] == "gnn":
            t_gnn += time.perf_counter() - t0
        log(f"[mesh_train] one-process reference {run['tag']}: losses "
            f"{[m['loss'] for m in refs[run['tag']]['metrics']]}, step 1 "
            f"{json.dumps(refs[run['tag']]['metrics'][0])}, steps (s) "
            f"{[round(w, 3) for w in refs[run['tag']]['walls']]}; {time.perf_counter() - t0:.1f}s")
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump({"runs": runs}, f)
    t_refs = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    out_dir = os.path.join(work, "world")
    os.makedirs(out_dir)
    gc_cuda(torch, dev)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # the ranks' allocators
    try:
        run_world(mesh_train_world, MESH_RANKS, backend="gloo", device=mesh_device(dev),
                  args=(spec_path, out_dir), join_timeout_s=MESH_TRAIN_JOIN_S)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    t_world = time.perf_counter() - t0
    launches = {}
    for run in runs:
        tag = run["tag"]
        outs = [torch.load(os.path.join(out_dir, f"{tag}_rank{r}.pt")) for r in range(MESH_RANKS)]
        rep = mesh_train_check(torch, tag, outs, refs[tag], run, mesh_train_run_config(run))
        if run["kind"] == "gnn":
            t_gnn += outs[0]["run_s"]
        launches[tag] = [{k: c for k, c in o["launches"].items() if c} for o in outs]
        log(f"[mesh_train] {tag} ({run['arch']}, mesh {tuple(run['mesh'])}, "
            f"{run['microbatches']} microbatch(es)) on 4 gloo ranks of one card: {json.dumps(rep)}; "
            f"launches per rank {json.dumps(launches[tag])}; {card()}")
        del outs
    log(f"[mesh_train] gin-tu's runs took {t_gnn:.1f}s (references and rank 0's runs; budget "
        f"{MESH_TRAIN_GNN_BUDGET_S:.0f}s)")
    if t_gnn > MESH_TRAIN_GNN_BUDGET_S:
        fail(f"mesh_train: gin-tu's runs took {t_gnn:.1f}s, over their budget of "
             f"{MESH_TRAIN_GNN_BUDGET_S:.0f}s")

    # rows 5-rank-train and 5b-rank: the bag kernels at DIN's rank 0 block
    cap = torch.load(os.path.join(out_dir, "din_bag.pt"))
    table, ids, w, gr = (cap[k].to(dev) for k in ("table", "ids", "w", "g"))
    bs, bl = ids.shape
    d, v = table.shape[1], table.shape[0]
    fwd = bag_check(torch, "DIN rank 0's block (train)", table, ids, w)
    needed = int(((ids >= 0) & (w != 0)).sum())
    ops_, nbytes = bag_work(s=bs, l=bl, d=d, needed=needed, index_bytes=ids.element_size())
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    lib = torch.nn.functional.embedding_bag
    lib_ids = ids.clamp(min=0)  # the same sums: every dropped id has weight 0
    din_launches = launches["din"]
    fwd_row = {
        "shape": [bs, bl, d, v], "mesh": "2x2 rank 0", "in_range": needed, "of": bs * bl,
        "launches": sum(x.get("embedding_bag", 0) for x in din_launches),
        "max_abs_err": fwd["max_abs_err"],
        "ms": time_cuda(torch, lambda: embedding_bag_cuda(table, ids, w), flush),
        "plain_ms": time_cuda(torch, lambda: ref.embedding_bag_bags(table, ids, w), flush, iters=5),
        "library_ms": time_cuda(torch, lambda: lib(lib_ids, table, per_sample_weights=w,
                                                   mode="sum"), flush),
        "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
    }
    bwd = bag_backward_check(torch, "DIN rank 0's block (train)", table, ids, w, gr, True)
    shapes = dict(s=bs, l=bl, d=d, index_bytes=ids.element_size())
    ops_, nbytes = (sum(x) for x in zip(grad_table_work(v=v, **shapes),
                                        grad_weights_work(after_table=True, **shapes)))
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops_ / F32_OPS_PER_S
    leaves = (table.detach().requires_grad_(True), w.detach().requires_grad_(True))
    lib_out = lib(lib_ids, leaves[0], per_sample_weights=leaves[1], mode="sum")
    bwd_row = {
        "shape": [bs, bl, d, v], "mesh": "2x2 rank 0",
        "launches": sum(x.get("embedding_bag_backward", 0) for x in din_launches),
        "max_abs_err": max(bwd["dtable_max_abs_err"], bwd["dweights_max_abs_err"]),
        "ms": time_cuda(torch, lambda: embedding_bag_backward_cuda(table, ids, w, gr,
                                                                   weights_grad=True), flush),
        "plain_ms": time_cuda(torch, lambda: ref.embedding_bag_bags_backward(
            table, ids, w, gr, weights_grad=True), flush, iters=5),
        "library_ms": time_cuda(torch, lambda: torch.autograd.grad(lib_out, leaves, gr,
                                                                   retain_graph=True), flush),
        "bound_ms": max(t_b, t_o) * 1e3, "bound_by": "bytes" if t_b >= t_o else "operations",
    }
    del cap, table, ids, w, gr, leaves, lib_out, lib_ids
    gc_cuda(torch, dev)
    for name, row in (("embedding_bag", fwd_row), ("embedding_bag_backward", bwd_row)):
        if row["launches"] < 1:
            fail(f"mesh_train: DIN's ranks launched {name} {row['launches']} times")
    log(f"[mesh_train] row 5-rank-train (the bag forward on DIN's rank 0 block at (2, 2), bound "
        f"over its {needed} ids in range of {bs * bl}): {json.dumps(fwd_row)}; row 5b-rank (the "
        f"backward there, dtable and dw): {json.dumps(bwd_row)}; {card()}")

    # the dry run over 4 gloo ranks on this card
    t0 = time.perf_counter()
    arch_name, shape, layers, batch, mesh = MESH_TRAIN_DRYRUN
    cut = mesh_train_config({"arch": arch_name, "layers": layers})
    cut = dataclasses.replace(get_arch(arch_name), config=cut, train_microbatches=1)
    rec = dryrun.run_cell(arch_name, shape, device=mesh_device(dev), ranks=4, mesh=mesh,
                          backend="gloo", arch=cut, iters=1, batch=batch, verbose=False)
    formula = mesh_train_collectives(cut.config, mesh, microbatches=1)
    if not rec["collectives"]["counts"] == formula == MESH_TRAIN_COUNTS["dryrun"]:
        fail(f"mesh_train dryrun: collectives {rec['collectives']['counts']}, the formula gives "
             f"{formula}, the recorded counts are {MESH_TRAIN_COUNTS['dryrun']}")
    mfu = rec["measured"]["mfu"]
    if not 0 < mfu <= MESH_MFU_MAX:
        fail(f"mesh_train dryrun: MFU {mfu} outside (0, {MESH_MFU_MAX}]")
    log(f"[mesh_train] dryrun {arch_name}/{shape} over 4 gloo ranks at {mesh}, {layers} layers "
        f"(cut: {rec['reduced']}): p50 {rec['measured']['p50_ms']:.3f} ms, MFU {mfu:.6f} over 4 "
        f"devices, collectives {json.dumps(rec['collectives'])}, peak "
        f"{rec['measured']['peak_bytes']}, {time.perf_counter() - t0:.1f}s")
    elapsed = time.perf_counter() - t_phase
    log(f"[mesh_train] phase took {elapsed:.1f}s (references {t_refs:.1f}s, gloo world "
        f"{t_world:.1f}s); {card()}")
    if elapsed > MESH_TRAIN_BUDGET_S * 1.5:
        log(f"[mesh_train] over its budget of {MESH_TRAIN_BUDGET_S:.0f}s")
    return fwd_row, bwd_row


def run(torch, dev, args) -> list:
    """All phases on ``dev``; returns the kernels rows (raises on any
    failed check)."""
    from repro_torch.core import Retriever, WarpSearchConfig

    walls, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:  # the wall time since the last lap, under name
        now = time.perf_counter()
        walls[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    lap("index")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = phase_kernels(torch, index, plan_ragged, flush)
    lap("kernels")
    kernel_err = max(row["max_abs_err"] for row in kernels)  # the scoring kernels
    queries, qmask = make_queries(torch, index, 128, args.seed + 1)
    counts, lat = phase_retrieve(torch, retriever, queries, qmask, 4, kernel_err)
    for row in kernels:
        row["launches"] = counts[row["name"]]
    lap("retrieve")
    phase_autotune(torch, retriever, queries, qmask, args.seed + 12, kernel_err)
    lap("autotune")
    if args.profile:
        phase_profile(torch, retriever, queries, qmask)
    phase_serve(torch, retriever, 256, args.seed + 2, kernel_err)
    lap("serve")
    phase_fixture(torch, dev)
    lap("fixture")
    serve_dir = tempfile.mkdtemp(prefix="serving_phase_")
    try:
        store = os.path.join(serve_dir, "store")
        seg_launches = phase_segments(torch, index, dev, args.seed + 6, kernel_err, lat, store)
        for row in kernels:
            if row["name"] == "segmented_ragged_fused_gather_score":
                row["launches"] = seg_launches
        lap("segments")
        phase_serving(torch, index, dev, args.seed + 7, kernel_err, store)
        lap("serving")
        shutil.rmtree(serve_dir, ignore_errors=True)
        os.makedirs(serve_dir)
        sh = phase_sharded(torch, index, dev, args.seed + 8, kernel_err,
                           os.path.join(serve_dir, "sharded"), args.profile)
        for row in kernels:
            if row["name"] in sh["counts"] and row["name"] != "segmented_ragged_fused_gather_score":
                row["sharded_launches"] = sh["counts"][row["name"]]
        lap("sharded")
        ranks = phase_ranks(torch, index, sh, args.seed + 13, kernel_err, serve_dir)
        for row in kernels:
            if row["name"] in ranks:
                row["ranks_launches"] = ranks[row["name"]]
        lap("ranks")
        phase_encode(torch, dev, args.seed + 9, kernel_err, sh, args.profile)
        lap("encode")
        del sh
        torch.cuda.empty_cache()
        enc = phase_encoder_train(torch, dev, args.seed + 16, kernel_err, flush)
        for row in kernels:
            if row["name"] in enc:
                row["encoder_train_launches"] = enc[row["name"]]
        lap("encoder_train")
        phase_dryrun(torch, index, dev, args.seed, kernel_err)
        lap("dryrun")
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    del retriever, index, plan_ragged, queries, qmask
    torch.cuda.empty_cache()

    phase_build(torch, dev, args.seed + 5, kernel_err, args.profile)
    lap("build")
    torch.cuda.empty_cache()

    flash = phase_flash(torch, dev, flush)
    lap("flash")
    seeds = [args.seed + 3 + i for i in range(args.lm_seeds)]
    flash["launches"] = phase_lm(torch, dev, seeds, args.profile)
    lap("lm")
    torch.cuda.empty_cache()  # the LM's weights and caches are gone
    for arch, n in phase_zoo(torch, dev, args.seed + 10, args.profile).items():
        flash["zoo"][arch.split("-")[0]]["launches"] = n
    lap("zoo")

    bag = phase_recsys(torch, dev, args.seed + 4, flush, args.profile)
    lap("recsys")
    torch.cuda.empty_cache()
    bag_backward = phase_train(torch, dev, args.seed + 11, flush)
    lap("train")
    bag["din_history"] = bag_backward.pop("din_forward")  # row 5-DIN, the forward kernel's
    bag["xdeepfm_linear"]["launches"] = bag_backward.pop("xdeepfm_forward_launches")
    torch.cuda.empty_cache()
    mesh_dir = tempfile.mkdtemp(prefix="mesh_phase_")
    try:
        flash["mesh"], bag["rank"] = phase_mesh(torch, dev, args.seed + 14, flush, mesh_dir)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    lap("mesh")
    torch.cuda.empty_cache()
    mesh_dir = tempfile.mkdtemp(prefix="mesh_train_phase_")
    try:
        bag["rank_train"], bag_backward["rank"] = phase_mesh_train(torch, dev, args.seed + 15,
                                                                   flush, mesh_dir)
    finally:
        shutil.rmtree(mesh_dir, ignore_errors=True)
    lap("mesh_train")
    log(f"[done] phase walls (s) {json.dumps(walls)}")
    return kernels + [flash, bag, bag_backward]


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
    # Every phase but `autotune` plans from the heuristic, whatever table
    # build/ may hold; `autotune` installs its own table and resets it.
    os.environ.setdefault("REPRO_AUTOTUNE_TABLE", os.devnull)

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
