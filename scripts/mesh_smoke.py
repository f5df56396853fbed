#!/usr/bin/env python3
"""The LM family over a (1, 4) mesh of four cards, one rank per card
(NCCL), for a machine with four cards.

    python3 scripts/mesh_smoke.py [--seed 0] [--skip-dbrx] [--skip-dryrun]

1. Holds mixtral-8x7b's 8-layer cut at full width (``chip_smoke.py``'s
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-dbrx", action="store_true")
    ap.add_argument("--skip-dryrun", action="store_true")
    args = ap.parse_args()
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
    try:
        # 1. the 8-layer cut over four cards against one process on card 0
        cs.MESH_RANKS = 4
        t0 = time.perf_counter()
        check = mesh_cut_check(torch, args.seed, work)
        cs.log(f"[mesh_smoke] mixtral-8x7b 8-layer cut, NCCL (1, 4) vs one process: "
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
