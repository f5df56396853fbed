"""World bodies of ``tests/test_torch_mesh.py``: the LM and recsys families
served over (data, model) meshes of ranks.

They run in the ranks that ``repro_torch.launch.ranks.run_world`` spawns,
so this module imports torch, numpy and the port only (a rank never
imports JAX). One world lays every mesh over its ranks in turn; each rank
writes what it computed to ``<out>/rank<r>.npz``, which the test process
compares with the one-process port and with JAX.
"""

import os
from unittest import mock

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.launch import sharding
from repro_torch.models import KVCache, TransformerLM, init_params, moe, params_from_jax
from repro_torch.models.recsys import RECSYS_MODELS, serve_step
from repro_torch.models.transformer import shard_cache
from repro_torch.serving import generate

LM_ARCHS = ("mixtral-8x7b", "qwen3-4b")
LM_MESHES = ((1, 4), (2, 2), (4, 1))
SEQ_MESHES = ((4, 1), (2, 2))  # shard_seq decode: the cache split over data 4 and 2
# Layouts the registry's configs do not use, run by the port's own draw at
# one mesh each and held to one process: (arch, mesh, config overrides).
LM_VARIANTS = (
    ("qwen3-4b", (1, 4), dict(embed_shard="vocab", tie_embeddings=True)),
    ("qwen3-4b", (1, 4), dict(embed_shard="replicated")),
    ("qwen3-4b", (1, 4), dict(tie_embeddings=True)),  # "d": the tied head's product all-reduced
    ("mixtral-8x7b", (2, 2), dict(moe_weight_mode="tp_only")),
)
RECSYS_ARCHS = ("two-tower-retrieval", "sasrec", "xdeepfm", "din")
RECSYS_MESHES = ((1, 4), (2, 2))
RECSYS_SHAPES = ("serve_p99", "retrieval_cand")
B, S, N = 4, 40, 4  # prompt rows and length, decode steps (past mixtral's window of 32)
SEQ_S, SEQ_LEN = 40, 48  # the shard_seq prompt and the cache it is split from


def tree_of(z, prefix: str) -> dict:
    """The nested dict of arrays saved under ``prefix`` ("a/b/0/w" keys;
    numbers are list indices)."""
    root: dict = {}
    for key in z.files:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def lm_run(model, prompt, n: int, cache_len: int, batch: int):
    """Greedy prefill + ``n - 1`` decode steps on the rank's rows of a
    ``batch``-row prompt -> (logits per step [n, B_loc, V], tokens [B_loc,
    n], the cache after the prefill (k, v copies))."""
    cache = KVCache.empty(model.cfg, batch, cache_len, torch.float32, device="cpu",
                          mesh=model.mesh)
    logits, cache = model.prefill(prompt, cache)
    kv = (cache.k.clone(), cache.v.clone())
    steps, toks = [logits], [logits.argmax(-1)]
    for _ in range(n - 1):
        logits, cache = model.decode_step(toks[-1], cache)
        steps.append(logits)
        toks.append(logits.argmax(-1))
    return torch.stack(steps), torch.stack(toks, 1), kv


def seq_decode(model, full_model, prompt, forced):
    """A one-process prefill of ``prompt`` [1, S] into a cache of SEQ_LEN
    positions, split by sequence over the mesh's data axes, then one decode
    step per ``forced`` token -> logits [len(forced), 1, V]."""
    cfg = full_model.cfg
    cache = KVCache.empty(cfg, 1, SEQ_LEN, torch.float32, device="cpu")
    _, cache = full_model.prefill(prompt, cache)
    if model is not full_model:
        cache = shard_cache(cache, cfg, model.mesh, shard_seq=True)
    out = []
    for t in forced:
        logits, cache = model.decode_step(torch.tensor([int(t)]), cache)
        out.append(logits)
    return torch.stack(out)


def moe_local(mesh, z, cfg):
    """JAX's local-dispatch MoE layer at the mesh: the rank's tokens, the
    experts tp_only (d_ff over model) -> (y rows, top_e, counts)."""
    routes = []
    route = moe.route

    def capture(x, w, c):
        out = route(x, w, c)
        routes.append(out[2])
        return out

    spec3 = sharding.P(None, None, "model")
    params = {
        "router": torch.from_numpy(np.ascontiguousarray(z["moe/router"].T)),
        "gate": sharding.local_block(torch.from_numpy(z["moe/gate"]), spec3, mesh),
        "up": sharding.local_block(torch.from_numpy(z["moe/up"]), spec3, mesh),
        "down": sharding.local_block(torch.from_numpy(z["moe/down"]),
                                     sharding.P(None, "model", None), mesh),
    }
    x = sharding.local_block(torch.from_numpy(z["moe/x"]), sharding.P("data", None), mesh)
    with mock.patch.object(moe, "route", capture):
        y, aux = moe.moe_apply(params, cfg, x, mesh=mesh)
    top_e = routes[0]
    return y, top_e, torch.bincount(top_e.flatten(), minlength=cfg.n_experts), aux


def variant(arch: str, overrides: dict):
    """(config, tag) of an ``LM_VARIANTS`` entry."""
    import dataclasses

    tag = ",".join(f"{k}={v}" for k, v in sorted(overrides.items()))
    return dataclasses.replace(get_arch(arch).reduced, **overrides), f"{arch}[{tag}]"


def recsys_batch(z, arch: str, shape: str) -> dict:
    pre = f"rs/{arch}/{shape}/b/"
    return {k[len(pre):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(pre)}


def recsys_cfg(arch: str, split_all: bool = True):
    cfg = get_arch(arch).reduced
    if not split_all:  # a user table whose rows do not divide the model axis of 4
        import dataclasses

        cfg = dataclasses.replace(cfg, user_vocab=cfg.user_vocab + 2)
    return cfg


def serve(mesh, z, arch: str, shape: str, executor: str, params: dict, cfg):
    """One recsys serve or retrieval step on the rank's block of the batch
    -> the whole output, gathered over the data axes."""
    a = get_arch(arch)
    model = RECSYS_MODELS[type(cfg)].from_params(cfg, params, mesh=mesh)
    model.executor = executor
    batch = recsys_batch(z, arch, shape)
    specs = a.family.input_pspec(a, shape, mesh)
    local = {k: sharding.local_block(v, specs[k], mesh) for k, v in batch.items()}
    from repro_torch.configs.families import RECSYS_SHAPES_REDUCED

    out = serve_step(model, RECSYS_SHAPES_REDUCED[shape])(local)
    return sharding.gather_block(out, a.family.output_pspec(a, shape, mesh), mesh)


def serve_world(group, jax_npz: str, out_dir: str) -> None:
    """Every mesh in turn over the world's 4 ranks: the LMs' greedy
    prefill + decode, the cache blocks after the prefill, shard_seq decode,
    JAX's local-dispatch MoE at data 2, ``generate``, the layouts of
    ``LM_VARIANTS``, and the recsys serve steps at both executors (tables
    split, and a user table left whole)."""
    torch.set_num_threads(1)
    z = np.load(jax_npz)
    res = {}
    for shape in LM_MESHES:
        mesh = group.mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        for arch in LM_ARCHS:
            cfg = get_arch(arch).reduced
            tree = tree_of(z, f"lm/{arch}/p/")
            model = TransformerLM.from_params(
                cfg, params_from_jax(tree, cfg, device="cpu", mesh=mesh), mesh=mesh)
            prompt = torch.from_numpy(z[f"lm/{arch}/prompt"]).long()
            local = sharding.local_block(prompt, sharding.P("data", None), mesh)
            logits, toks, (k, v) = lm_run(model, local, N, S + N, B)
            res[f"{arch}/{tag}/logits"] = logits
            res[f"{arch}/{tag}/tokens"] = sharding.gather_block(toks, sharding.P("data", None), mesh)
            res[f"{arch}/{tag}/k"], res[f"{arch}/{tag}/v"] = k, v
            if shape in SEQ_MESHES:
                full = TransformerLM.from_params(cfg, params_from_jax(tree, cfg, device="cpu"))
                res[f"{arch}/{tag}/seq"] = seq_decode(
                    model, full, torch.from_numpy(z[f"lm/{arch}/seq_prompt"]).long(),
                    z[f"lm/{arch}/seq_forced"])
        if shape == (2, 2):
            mcfg = moe.MoEConfig(n_experts=4, top_k=2, local_dispatch=True)
            y, top_e, counts, aux = moe_local(mesh, z, mcfg)
            res.update({"moe/y": y, "moe/top_e": top_e, "moe/counts": counts, "moe/aux": aux})
            # generate itself over the mesh: every row's tokens on every rank
            cfg = get_arch("qwen3-4b").reduced
            model = TransformerLM.from_params(cfg, params_from_jax(
                tree_of(z, "lm/qwen3-4b/p/"), cfg, device="cpu", mesh=mesh), mesh=mesh)
            res["generate"] = generate(model, z["lm/qwen3-4b/prompt"], max_new_tokens=N,
                                       cache_dtype=torch.float32)
        for arch, at, overrides in LM_VARIANTS:
            if at != shape:
                continue
            cfg, key = variant(arch, overrides)
            model = TransformerLM.from_params(cfg, init_params(
                cfg, torch.Generator().manual_seed(9), device="cpu", mesh=mesh), mesh=mesh)
            local = sharding.local_block(torch.from_numpy(z[f"lm/{arch}/prompt"]).long(),
                                         sharding.P("data", None), mesh)
            logits, toks, _ = lm_run(model, local, N, S + N, B)
            res[f"{key}/logits"] = logits
            res[f"{key}/tokens"] = sharding.gather_block(toks, sharding.P("data", None), mesh)
    for shape in RECSYS_MESHES:
        mesh = group.mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        for arch in RECSYS_ARCHS:
            variants = [True] + ([False] if arch == "two-tower-retrieval" else [])
            for split_all in variants:
                cfg = recsys_cfg(arch, split_all)
                if split_all:
                    params = params_from_jax(tree_of(z, f"rs/{arch}/p/"), cfg, device="cpu",
                                             mesh=mesh)
                else:
                    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu",
                                         mesh=mesh)
                for rshape in RECSYS_SHAPES:
                    for ex in ("reference", "kernel"):
                        key = f"rs/{arch}/{tag}/{rshape}/{ex}" + ("" if split_all else "/whole")
                        res[key] = serve(mesh, z, arch, rshape, ex, params, cfg)
    np.savez(os.path.join(out_dir, f"rank{group.rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})
