#!/usr/bin/env python3
"""The LM family over a (1, 4) mesh of four cards, one rank per card
(NCCL), for a machine with four cards.

    python3 scripts/mesh_smoke.py [--seed 0] [--skip-dbrx] [--skip-dryrun]
    python3 scripts/mesh_smoke.py --train [--seed 0] [--only mixtral,qwen2,gnn,cli]

1. Holds mixtral-8x7b's (1, 4) cut at full width (``chip_smoke.py``'s
   mesh phase, 2 x 8192 prompt, 16 greedy tokens) over the four cards
   against the one-process run on card 0, teacher-forced in tokens and
   routing (``mesh_lm_check``: logits, argmax, would-be routing flips,
   each rank's KV block; every rank's tokens and routing against rank
   0's).
2. Serves mixtral-8x7b whole (32 layers, 93 GB of bf16 weights, 23.3 GB a
   card): a 2 x 8192 prompt, then 32 greedy tokens. Each rank draws its own
   blocks at random (``random_blocks``; the replicated tensors from one
   seed on every rank), so no rank ever holds a whole tensor; step 1 holds
   the numerics. Prints prefill and
   decode tokens/s, each rank's peak memory, and the collectives' share of
   a decode step (one more step with every collective synchronized and
   timed on the host).
3. The same for dbrx-132b (263 GB, 65.8 GB a card) at its deepest depth
   that the cards hold (``--skip-dbrx`` leaves it out); the depth is
   reckoned from the free memory of card 0 before anything runs.
4. ``python -m repro_torch.launch.dryrun --arch mixtral-8x7b --ranks 4``:
   its serving cells over the four cards, records under
   ``chiprun_out/mesh_dryrun``.

With ``--train`` it trains over the four cards (NCCL, one rank a card)
instead:

1. mixtral-8x7b's train_4k at (2, 2), full width, as many layers as the
   cards hold (``deepest_train``: ~17.5 GB of float32 state a layer, a
   quarter a card, beside the gathered experts and the activations), a
   global batch of ``TRAIN_BATCH`` rows of 4096 in its 2 microbatches;
2. qwen2-0.5b whole at (4, 1), ``QWEN_BATCH`` rows of 4096.

Each takes ``TRAIN_STEPS`` steps (the first counted: its collectives per op
must equal ``launch.cost.mesh_train_collectives``; every rank's metrics
equal rank 0's; the loss falls) and reports tokens/s over the timed steps,
each rank's peak bytes and the collectives' share of one more step whose
collectives are synchronized and timed on the host. Then
``launch.dryrun --arch mixtral-8x7b --shape train_4k --ranks 4 --mesh 2,2``
(from the run's batch and depth) and ``launch.train --ranks 4 --mesh 2,2`` (mixtral's
reduced config, 4 steps) run over the cards.

3. gin-tu at its CONFIG on ogb_products, the whole graph (2,449,408 nodes,
   61,859,840 edges), at (4, 1) (``gnn_over_cards``): the one-process port
   on card 0 first (its step-1 loss, then freed), then ``TRAIN_STEPS``
   steps over the cards from the same weights and graph (every rank draws
   them alike and keeps its block of every node and edge array): step 1's
   loss within ``GNN_LOSS_TOL`` relative of one process, its collectives
   the recorded ``GNN_COUNTS`` and the formula's, every rank's metrics
   rank 0's, the loss falls; a checkpoint after step 2 gathered to rank 0
   alone (``gather_to_root`` over NCCL), restored on every rank, and steps
   3 and 4 run again from it bit for bit. Reports edges/s, each rank's peak
   and the collectives' share of a synchronized step.

``--only`` picks among the training runs: mixtral, qwen2, gnn, and cli
(the dry run and the launcher).

Prints each card's name and power limit, and exits nonzero when a check
fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

PROMPT = (2, 8192)
NEW = 32
CARD_SHARE = 0.9  # of a card's free memory the weights may take (the rest: cache, activations)
ACTIVATIONS = 6e9  # bytes a rank keeps free for the prefill's activations and the cache


def random_blocks(torch, cfg, mesh, seed: int) -> dict:
    """This rank's bf16 blocks of ``cfg``'s weights drawn at random block by
    block (normal / sqrt(fan-in), norm scales 1): a tensor replicated over
    the mesh from one seed on every rank, a split one from a seed of its
    block's position, so ranks that share a block draw it alike."""
    import math

    from repro_torch.launch import sharding
    from repro_torch.models.convert import init_params, param_specs

    specs = param_specs(cfg, mesh)
    full = init_params(cfg, torch.Generator(), device="meta")
    first_kv = sharding.kv_heads_of_rank(cfg, mesh)[0]
    out = {}
    for i, (name, meta) in enumerate(full.items()):
        shape = sharding.lm_local_shape(name, tuple(meta.shape), specs[name], mesh, cfg)
        if name.endswith("scale"):
            out[name] = torch.ones(shape, dtype=torch.bfloat16, device=mesh.device)
            continue
        block = [mesh.index_of(p) for p in specs[name] if p]
        if name.split(".")[-2:-1] in (["wk"], ["wv"]):
            block.append(first_kv)
        fan = meta.shape[1]  # Dense [out, in], experts [E, in, out], the embedding [V, D]
        g = torch.Generator(device=mesh.device)
        g.manual_seed(((seed * 1009 + i) * 131 + sum(b * 17 ** j for j, b in enumerate(block))))
        w = torch.randn(shape, generator=g, device=mesh.device)
        out[name] = w.mul_(1.0 / math.sqrt(fan)).to(torch.bfloat16)
        del w
    return out


def serve_world(group, arch_name: str, layers: int, seed: int, out_dir: str) -> None:
    """One rank of the whole-model run: its blocks drawn from ``seed``, a
    timed prefill, ``NEW - 1`` timed decode steps, then one decode step
    with its collectives timed."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import KVCache, TransformerLM

    mesh = group.mesh((1, group.size))
    dev = mesh.device
    cfg = dataclasses.replace(get_arch(arch_name).config, n_layers=layers)
    t0 = time.perf_counter()
    model = TransformerLM.from_params(cfg, random_blocks(torch, cfg, mesh, seed), mesh=mesh)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab, PROMPT, generator=g, device=dev)
    torch.cuda.synchronize(dev)
    made = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    warm = KVCache.empty(cfg, PROMPT[0], 256, device=dev, mesh=mesh)
    model.decode_step(model.prefill(prompt[:, :128], warm)[0].argmax(-1), warm)  # first launches
    del warm
    cache = KVCache.empty(cfg, PROMPT[0], PROMPT[1] + NEW + 1, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompt, cache)
    torch.cuda.synchronize(dev)
    prefill_s = time.perf_counter() - t0
    nxt = logits.argmax(-1)
    toks = [nxt]
    t0 = time.perf_counter()
    for _ in range(NEW - 1):
        logits, cache = model.decode_step(nxt, cache)
        nxt = logits.argmax(-1)
        toks.append(nxt)
    torch.cuda.synchronize(dev)
    decode_s = time.perf_counter() - t0
    # One more step with each collective synchronized and timed.
    spent = [0.0]
    real = {name: getattr(mesh_mod.RankMesh, name) for name in ("all_reduce", "all_gather")}

    def timed(name):
        def call(self, *a, **k):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = real[name](self, *a, **k)
            torch.cuda.synchronize(dev)
            spent[0] += time.perf_counter() - t
            return out
        return call

    for name in real:
        setattr(mesh_mod.RankMesh, name, timed(name))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model.decode_step(nxt, cache)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    for name, fn in real.items():
        setattr(mesh_mod.RankMesh, name, fn)
    torch.save({"tokens": torch.stack(toks, 1).cpu(), "made_s": made, "weights": weights,
                "peak": torch.cuda.max_memory_allocated(dev), "prefill_s": prefill_s,
                "decode_s": decode_s, "step_s": step_s, "collective_s": spent[0]},
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def serve_whole(torch, arch_name: str, layers: int, seed: int, work: str) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.ranks import run_world

    out = os.path.join(work, f"{arch_name}_{layers}")
    os.makedirs(out)
    t0 = time.perf_counter()
    run_world(serve_world, 4, backend="nccl", args=(arch_name, layers, seed, out),
              join_timeout_s=1500)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]
    for r, o in enumerate(ranks):
        if not torch.equal(o["tokens"], ranks[0]["tokens"]):
            cs.fail(f"{arch_name}: rank {r}'s tokens differ from rank 0's")
    vocab = get_arch(arch_name).config.vocab
    t = ranks[0]["tokens"]
    if int(t.min()) < 0 or int(t.max()) >= vocab:
        cs.fail(f"{arch_name}: tokens outside the vocabulary")
    b, s = PROMPT
    prefill = max(o["prefill_s"] for o in ranks)
    decode = max(o["decode_s"] for o in ranks)
    rep = {
        "arch": arch_name, "layers": layers, "of": get_arch(arch_name).config.n_layers,
        "prompt": list(PROMPT), "new_tokens": NEW,
        "prefill_tokens_per_s": b * s / prefill, "prefill_s": prefill,
        "decode_tokens_per_s": b * (NEW - 1) / decode, "decode_step_ms": decode / (NEW - 1) * 1e3,
        "weights_gb_per_rank": [o["weights"] / 1e9 for o in ranks],
        "peak_gb_per_rank": [o["peak"] / 1e9 for o in ranks],
        "collective_share_of_a_decode_step": [o["collective_s"] / o["step_s"] for o in ranks],
        "synced_step_ms": [o["step_s"] * 1e3 for o in ranks],
        "weights_made_s": max(o["made_s"] for o in ranks),
        "world_s": time.perf_counter() - t0,
    }
    cs.log(f"[mesh_smoke] {json.dumps(rep)}; {cs.card()}")
    return rep


def deepest(torch, arch_name: str) -> int:
    """The most layers whose bf16 weights, a quarter a card, fit
    ``CARD_SHARE`` of card 0's free memory less ``ACTIVATIONS``."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(arch_name).config
    free = torch.cuda.mem_get_info(0)[0] * CARD_SHARE - ACTIVATIONS
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    per_layer = (cfg.param_count() - embed - cfg.d_model) / cfg.n_layers
    layers = int((free - embed * 2 / 4) // (per_layer * 2 / 4))
    return max(1, min(cfg.n_layers, layers))


TRAIN_STEPS = 4
TRAIN_BATCH = 8  # mixtral train_4k rows a step (its 256 cut to what the activations leave room for)
QWEN_BATCH = 16
TRAIN_STATE = 20.0  # float32 bytes a parameter: itself, m, v, its gradient and the microbatch sum
TRAIN_TRANSIENT = 18e9  # bytes a rank keeps for a layer's gathered experts, grads and activations


def deepest_train(torch, arch_name: str, cards: int = 4) -> int:
    """The most layers of ``arch_name`` whose training state, split over
    ``cards``, fits ``CARD_SHARE`` of card 0's free memory less
    ``TRAIN_TRANSIENT``."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(arch_name).config
    free = torch.cuda.mem_get_info(0)[0] * CARD_SHARE - TRAIN_TRANSIENT
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    per_layer = (cfg.param_count() - embed - cfg.d_model) / cfg.n_layers
    layers = int((free - embed * TRAIN_STATE / cards) // (per_layer * TRAIN_STATE / cards))
    return max(1, min(cfg.n_layers, layers))


def train_world(group, arch_name: str, layers: int, batch: int, shape, seed: int,
                out_dir: str) -> None:
    """One rank of a training run over the cards: its blocks drawn from
    ``seed`` (every rank draws each tensor and keeps its block), the global
    batch drawn alike and cut to its rows, ``TRAIN_STEPS`` steps (the first
    counted), then one more with each collective synchronized and timed."""
    import torch

    from repro_torch.configs.families import lm_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import init_params
    from repro_torch.models.convert import train_layout
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train.loop import shard_batch

    mesh = group.mesh(tuple(shape))
    dev = mesh.device
    arch = get_arch(arch_name)
    cfg = dataclasses.replace(arch.config, n_layers=layers)
    mb = arch.train_microbatches
    layout = train_layout(cfg, mesh)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, 4096), generator=g, device=dev)
    local = shard_batch({"tokens": tokens, "labels": tokens}, mesh, mb)
    state = TrainState.create(init_params(cfg, g, device=dev, mesh=mesh), layout=layout)
    step = make_train_step(lm_loss_fn(cfg, mesh), AdamWConfig(**cs.TRAIN_OPT), microbatches=mb,
                           layout=layout)
    torch.cuda.synchronize(dev)
    made = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics, walls = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if i == 0:
            with cost.StepCost() as c:
                state, m = step(state, local)
            counts = dict(c.op_counts)
        else:
            state, m = step(state, local)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    spent = [0.0]
    real = {name: getattr(mesh_mod.RankMesh, name)
            for name in ("_all_reduce", "_all_gather", "_reduce_scatter")}

    def timed(name):
        def call(self, *a, **k):
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            out = real[name](self, *a, **k)
            torch.cuda.synchronize(dev)
            spent[0] += time.perf_counter() - t
            return out
        return call

    for name in real:
        setattr(mesh_mod.RankMesh, name, timed(name))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, _ = step(state, local)
    torch.cuda.synchronize(dev)
    synced = time.perf_counter() - t0
    for name, fn in real.items():
        setattr(mesh_mod.RankMesh, name, fn)
    torch.save({"metrics": metrics, "walls": walls, "counts": counts, "made_s": made,
                "state_bytes": state_bytes, "peak": torch.cuda.max_memory_allocated(dev),
                "synced_s": synced, "collective_s": spent[0]},
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def train_over_cards(torch, arch_name: str, layers: int, batch: int, shape, seed: int,
                     work: str) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.cost import mesh_train_collectives
    from repro_torch.launch.ranks import run_world

    arch = get_arch(arch_name)
    out = os.path.join(work, f"train_{arch_name}_{layers}")
    os.makedirs(out)
    t0 = time.perf_counter()
    run_world(train_world, 4, backend="nccl",
              args=(arch_name, layers, batch, tuple(shape), seed, out), join_timeout_s=1500)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]
    for r, o in enumerate(ranks):
        if o["metrics"] != ranks[0]["metrics"]:
            cs.fail(f"{arch_name} training: rank {r}'s metrics differ from rank 0's")
    cfg = dataclasses.replace(arch.config, n_layers=layers)
    want = mesh_train_collectives(cfg, tuple(shape), microbatches=arch.train_microbatches)
    if ranks[0]["counts"] != want:
        cs.fail(f"{arch_name} training: step 1 ran {ranks[0]['counts']}, the formula gives {want}")
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    if not losses[-1] < losses[0]:
        cs.fail(f"{arch_name} training: the loss did not fall: {losses}")
    step = max(sorted(o["walls"][1:])[len(o["walls"][1:]) // 2] for o in ranks)
    rep = {
        "arch": arch_name, "layers": layers, "of": arch.config.n_layers, "mesh": list(shape),
        "batch": [batch, 4096], "microbatches": arch.train_microbatches, "losses": losses,
        "step_1": ranks[0]["metrics"][0], "counts": ranks[0]["counts"],
        "step_p50_s": step, "tokens_per_s": batch * 4096 / step,
        "first_step_s": max(o["walls"][0] for o in ranks),
        "state_gb_per_rank": [o["state_bytes"] / 1e9 for o in ranks],
        "peak_gb_per_rank": [o["peak"] / 1e9 for o in ranks],
        "collective_share_of_a_step": [o["collective_s"] / o["synced_s"] for o in ranks],
        "synced_step_s": [o["synced_s"] for o in ranks],
        "made_s": max(o["made_s"] for o in ranks), "world_s": time.perf_counter() - t0,
    }
    cs.log(f"[mesh_smoke] train {json.dumps(rep)}; {cs.card()}")
    return rep


GNN_SHAPE, GNN_MESH = "ogb_products", (4, 1)
GNN_LOSS_TOL = 1e-5  # step 1's loss over the cards vs one process, relative (float32 sums)
GNN_COUNTS = {"all-gather": 9, "all-reduce": 3, "reduce-scatter": 9}  # step 1's, recorded
GNN_CKPT_AT = 2  # the checkpoint after this step; the steps after it run again from it


def gnn_draw(torch, shape: str, seed: int, dev):
    """gin-tu's weights, then the whole graph of ``shape``, drawn from
    ``seed`` on ``dev`` as ``chip_smoke.py``'s mesh_train phase draws them."""
    from repro_torch.configs.families import GNN_SHAPES
    from repro_torch.models import init_params

    cfg = cs.mesh_train_run_config({"kind": "gnn", "arch": "gin-tu", "shape": shape})
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = init_params(cfg, g, device=dev)
    batch = cs.gnn_batch(torch, shape, GNN_SHAPES[shape], g, dev, seed)
    return cfg, params, batch


def gnn_world(group, shape: str, mesh_shape, seed: int, out_dir: str, ckdir: str) -> None:
    """One rank of gin-tu over the cards: the weights (replicated) and its
    block of the graph, ``TRAIN_STEPS`` steps (the first counted), a
    checkpoint after ``GNN_CKPT_AT`` through rank 0, the steps after it run
    again from the restored state, then one more step with each collective
    synchronized and timed. (It also runs on gloo CPU ranks, for a
    rehearsal at a small shape.)"""
    import torch

    from repro_torch.configs.families import GNN_SHAPES, gnn_loss_fn
    from repro_torch.launch import cost
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.convert import train_layout
    from repro_torch.train import AdamWConfig, TrainState, make_train_step
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import shard_batch

    mesh = group.mesh(tuple(mesh_shape))
    dev = mesh.device
    card = dev.type == "cuda"

    def sync():
        if card:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    cfg, params, whole = gnn_draw(torch, shape, seed, dev)
    batch = {k: v.clone() for k, v in shard_batch(whole, mesh).items()}
    del whole
    layout = train_layout(cfg, mesh)
    state = TrainState.create(params, layout=layout)
    step = make_train_step(gnn_loss_fn(cfg, GNN_SHAPES[shape].n_graphs, mesh),
                           AdamWConfig(**cs.TRAIN_OPT), layout=layout)
    sync()
    made = time.perf_counter() - t0
    cs.gc_cuda(torch, dev)
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    metrics, walls, prints = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        if i == 0:
            with cost.StepCost() as c:
                state, m = step(state, batch)
            counts = dict(c.op_counts)
        else:
            state, m = step(state, batch)
        sync()
        walls.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
        prints.append(cs.state_prints(torch, state))
        if i + 1 == GNN_CKPT_AT:
            t0 = time.perf_counter()
            ckpt.save_checkpoint(ckdir, GNN_CKPT_AT, state, layout=layout)
            save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, at = ckpt.restore_checkpoint(ckdir, cs.meta_state(torch, state), GNN_CKPT_AT, dev,
                                           layout=layout)
    for _ in range(at, TRAIN_STEPS):
        restored, _m = step(restored, batch)
    sync()
    resume = {"from": at, "equal": cs.state_prints(torch, restored) == prints[-1],
              "s": time.perf_counter() - t0}
    del restored
    spent = [0.0]
    real = {name: getattr(mesh_mod.RankMesh, name)
            for name in ("_all_reduce", "_all_gather", "_reduce_scatter")}

    def timed(name):
        def call(self, *a, **k):
            sync()
            t = time.perf_counter()
            out = real[name](self, *a, **k)
            sync()
            spent[0] += time.perf_counter() - t
            return out
        return call

    for name in real:
        setattr(mesh_mod.RankMesh, name, timed(name))
    sync()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    sync()
    synced = time.perf_counter() - t0
    for name, fn in real.items():
        setattr(mesh_mod.RankMesh, name, fn)
    torch.save({"metrics": metrics, "walls": walls, "counts": counts, "made_s": made,
                "peak": torch.cuda.max_memory_allocated(dev) if card else 0, "synced_s": synced,
                "collective_s": spent[0], "save_s": save_s, "resume": resume,
                "prints": prints[-1]}, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def gnn_over_cards(torch, seed: int, work: str) -> dict:
    """gin-tu on ogb_products over the four cards against one process on
    card 0 (see the module)."""
    from repro_torch.configs.families import GNN_SHAPES, gnn_loss_fn
    from repro_torch.launch.cost import mesh_train_collectives
    from repro_torch.launch.ranks import run_world

    s = GNN_SHAPES[GNN_SHAPE]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cfg, params, batch = gnn_draw(torch, GNN_SHAPE, seed, dev)
    p = {k: torch.nn.Parameter(v) for k, v in params.items()}
    with torch.no_grad():
        want = float(gnn_loss_fn(cfg, s.n_graphs)(p, batch)[0])
    one_s = time.perf_counter() - t0
    del params, batch, p
    cs.gc_cuda(torch, dev)
    out = os.path.join(work, "train_gin")
    os.makedirs(out)
    t0 = time.perf_counter()
    run_world(gnn_world, 4, backend="nccl",
              args=(GNN_SHAPE, GNN_MESH, seed, out, os.path.join(work, "gin_ckpt")),
              join_timeout_s=1500)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]
    for r, o in enumerate(ranks):
        if o["metrics"] != ranks[0]["metrics"] or o["prints"] != ranks[0]["prints"]:
            cs.fail(f"gin-tu {GNN_SHAPE} training: rank {r}'s metrics or weights differ from "
                    "rank 0's")
        if not o["resume"]["equal"]:
            cs.fail(f"gin-tu {GNN_SHAPE} training: rank {r}'s run resumed from step "
                    f"{o['resume']['from']} does not end bit for bit with the unbroken run")
    formula = mesh_train_collectives(cfg, GNN_MESH)
    if not ranks[0]["counts"] == formula == GNN_COUNTS:
        cs.fail(f"gin-tu training: step 1 ran {ranks[0]['counts']}, the formula gives {formula}, "
                f"the recorded counts are {GNN_COUNTS}")
    losses = [m["loss"] for m in ranks[0]["metrics"]]
    rel = abs(losses[0] - want) / abs(want)
    if not rel <= GNN_LOSS_TOL:
        cs.fail(f"gin-tu training: step 1 loss {losses[0]} vs one process {want}: {rel} relative "
                f"> {GNN_LOSS_TOL}")
    if not losses[-1] < losses[0]:
        cs.fail(f"gin-tu training: the loss did not fall: {losses}")
    step = max(sorted(o["walls"][1:])[len(o["walls"][1:]) // 2] for o in ranks)
    rep = {
        "arch": "gin-tu", "shape": GNN_SHAPE, "mesh": list(GNN_MESH), "nodes": s.n_nodes,
        "edges": s.n_edges, "losses": losses, "one_process_loss": want, "step_1_rel": rel,
        "step_1": ranks[0]["metrics"][0], "counts": ranks[0]["counts"], "step_p50_s": step,
        "edges_per_s": s.n_edges / step, "first_step_s": max(o["walls"][0] for o in ranks),
        "peak_gb_per_rank": [o["peak"] / 1e9 for o in ranks],
        "collective_share_of_a_step": [o["collective_s"] / o["synced_s"] for o in ranks],
        "synced_step_s": [o["synced_s"] for o in ranks],
        "save_s": ranks[0]["save_s"], "resume": ranks[0]["resume"],
        "made_s": max(o["made_s"] for o in ranks), "one_process_s": one_s,
        "world_s": time.perf_counter() - t0,
    }
    cs.log(f"[mesh_smoke] train {json.dumps(rep)}; {cs.card()}")
    return rep


def train_main(torch, seed: int, work: str, only: set) -> None:
    if "mixtral" in only or "cli" in only:
        layers = deepest_train(torch, "mixtral-8x7b")
        cs.log(f"[mesh_smoke] training state reckoned at {TRAIN_STATE:g} bytes a parameter")
        cs.log(f"[mesh_smoke] mixtral-8x7b: {layers} of 32 layers' training state fits "
               f"{CARD_SHARE} of a card's free memory less {TRAIN_TRANSIENT / 1e9:.0f} GB")
    if "mixtral" in only:
        train_over_cards(torch, "mixtral-8x7b", layers, TRAIN_BATCH, (2, 2), seed, work)
    if "qwen2" in only:
        train_over_cards(torch, "qwen2-0.5b", 24, QWEN_BATCH, (4, 1), seed, work)
    if "gnn" in only:
        gnn_over_cards(torch, seed, work)
    if "cli" not in only:
        return
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for cmd in (
        ["-m", "repro_torch.launch.dryrun", "--arch", "mixtral-8x7b", "--shape", "train_4k",
         "--ranks", "4", "--mesh", "2,2", "--batch", str(TRAIN_BATCH), "--layers", str(layers),
         "--iters", "3", "--out", os.path.join(ROOT, "chiprun_out", "mesh_dryrun")],
        ["-m", "repro_torch.launch.train", "--arch", "mixtral-8x7b", "--ranks", "4", "--mesh",
         "2,2", "--steps", "4", "--ckpt-dir", os.path.join(work, "ckpt"), "--ckpt-every", "2"],
    ):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=1500)
        cs.log(f"[mesh_smoke] {' '.join(cmd[:3])} ... exit {proc.returncode} in "
               f"{time.perf_counter() - t0:.1f}s: {proc.stdout[-3000:]}")
        if proc.returncode:
            cs.log(proc.stderr[-6000:])
            cs.fail(f"mesh_smoke: {' '.join(cmd)} failed")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-dbrx", action="store_true")
    ap.add_argument("--skip-dryrun", action="store_true")
    ap.add_argument("--train", action="store_true", help="train over the four cards instead")
    ap.add_argument("--only", default="mixtral,qwen2,gnn,cli",
                    help="with --train, the runs to make (mixtral, qwen2, gnn, cli)")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= {"mixtral", "qwen2", "gnn", "cli"}:
        ap.error(f"--only takes mixtral, qwen2, gnn and cli, not {args.only}")
    os.environ.setdefault("REPRO_AUTOTUNE_TABLE", os.devnull)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("mesh_smoke: this script needs four CUDA cards", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.device_count()} cards: {cs.card()}")
    work = tempfile.mkdtemp(prefix="mesh_smoke_")
    if args.train:
        try:
            train_main(torch, args.seed, work, only)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        cs.log(cs.card())
        return 0
    try:
        # 1. the (1, 4) cut over four cards against one process on card 0
        cs.MESH_RANKS = 4
        t0 = time.perf_counter()
        check = mesh_cut_check(torch, args.seed, work)
        cs.log(f"[mesh_smoke] mixtral-8x7b {cs.MESH_LM[0][2]}-layer cut, NCCL (1, 4) vs one "
               f"process: "
               f"{json.dumps(check)} in {time.perf_counter() - t0:.1f}s")
        # 2. mixtral whole; 3. dbrx as deep as the cards hold
        serve_whole(torch, "mixtral-8x7b", 32, args.seed, work)
        if not args.skip_dbrx:
            layers = deepest(torch, "dbrx-132b")
            cs.log(f"[mesh_smoke] dbrx-132b: {layers} of 40 layers fit {CARD_SHARE} of a card's "
                   f"free memory")
            serve_whole(torch, "dbrx-132b", layers, args.seed, work)
        # 4. the dry run's serving cells over the four cards
        if not args.skip_dryrun:
            out = os.path.join(ROOT, "chiprun_out", "mesh_dryrun")
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mixtral-8x7b",
                 "--ranks", "4", "--out", out, "--iters", "3"],
                cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
                capture_output=True, text=True, timeout=1500)
            cs.log(proc.stdout[-6000:])
            if proc.returncode:
                cs.log(proc.stderr[-6000:])
                cs.fail("mesh_smoke: the dry run over four ranks failed")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(cs.card())
    return 0


def mesh_cut_check(torch, seed: int, work: str) -> dict:
    """``chip_smoke.py``'s (1, 4) run under NCCL, one rank per card,
    against the one-process run on card 0."""
    from repro_torch.launch.ranks import run_world
    from repro_torch.models import TransformerLM, init_params

    dev = torch.device("cuda", 0)
    tag, shape, layers, b, s, n = cs.MESH_LM[0]
    cfg = cs.mesh_lm_config(layers)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model = TransformerLM.from_params(cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16))
    prompt = torch.randint(0, cfg.vocab, (b, s), generator=g, device=dev)
    routes = []
    logits, toks, (k, v) = cs.mesh_generate(torch, model, prompt, n, b, routes)
    want = {"logits": logits.cpu(), "tokens": toks.cpu(), "k": k.cpu(), "v": v.cpu(),
            "routes": [e.cpu() for e, _ in routes], "probs": [p.cpu() for _, p in routes],
            "top_k": cfg.moe.top_k}
    del model, logits, k, v
    cs.gc_cuda(torch, dev)
    path, forced = os.path.join(work, "prompt.pt"), os.path.join(work, "forced.pt")
    torch.save(prompt.cpu(), path)
    torch.save({"tokens": want["tokens"], "routes": want["routes"]}, forced)
    spec = {"seq": None, "recsys": [],
            "lm": [{"tag": tag, "mesh": [1, 4], "layers": layers, "seed": seed, "prompt": path,
                    "new": n, "forced": forced}]}
    spec_path = os.path.join(work, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out_dir = os.path.join(work, "cut")
    os.makedirs(out_dir)
    run_world(cs.mesh_world, 4, backend="nccl", args=(spec_path, out_dir), join_timeout_s=900)
    outs = [torch.load(os.path.join(out_dir, f"{tag}_rank{r}.pt")) for r in range(4)]
    cs.mesh_ranks_agree(torch, "nccl 4 cards", outs, [[0, 1, 2, 3]])
    hkv = cfg.n_kv_heads // 4
    res = {}
    for r, o in enumerate(outs):
        w = dict(want, k=want["k"][:, :, :, r * hkv:(r + 1) * hkv],
                 v=want["v"][:, :, :, r * hkv:(r + 1) * hkv])
        res[r] = cs.mesh_lm_check(torch, f"nccl 4 cards rank {r}", o, w, slice(0, b))
        res[r]["flash_launches"] = o["launches"]["flash_attention"]
        res[r]["peak_gb"] = o["peak"] / 1e9
        res[r]["wall_s"] = o["wall_s"]
    return res


if __name__ == "__main__":
    sys.exit(main())
