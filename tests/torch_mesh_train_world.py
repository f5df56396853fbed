"""World bodies of ``tests/test_torch_mesh_train_lm.py``,
``tests/test_torch_mesh_train_recsys.py`` and
``tests/test_torch_mesh_train_gnn.py``: the LM, recsys and GNN families
trained over (data, model) meshes of ranks.

They run in the ranks that ``repro_torch.launch.ranks.run_world`` spawns,
so this module imports torch, numpy and the port only (a rank never
imports JAX). One world lays every mesh over its 4 ranks in turn and
trains each case there from JAX's initial state (``state_from_jax``);
each rank writes what it computed to ``<out>/rank<r>.pt``, which the test
process compares with the one-process port and with JAX.
"""

import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import families
from repro_torch.configs.families import (
    GNN_SHAPES_REDUCED, RECSYS_SHAPES_REDUCED, GNNFamily, gnn_loss_fn, lm_loss_fn,
)
from repro_torch.configs.registry import get_arch
from repro_torch.launch import cost, sharding
from repro_torch.models.convert import state_from_jax, train_layout
from repro_torch.models.recsys import RECSYS_MODELS
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import compress_grads
from repro_torch.train.loop import make_train_step, shard_batch, sync_grads
from repro_torch.train.optimizer import AdamWConfig

MESHES = ((1, 4), (2, 2), (4, 1))
# case -> (arch, config overrides): qwen3-4b's reduced config (qk norms;
# 2 kv heads, so one kv head is shared at model 4), mixtral's with fsdp
# experts (the gathered dispatch), and with tp_only experts, local dispatch
# and ZeRO-1 moments.
LM_CASES = {
    "qwen3": ("qwen3-4b", {}),
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral_tp": ("mixtral-8x7b", {"moe_weight_mode": "tp_only", "local_dispatch": True}),
}
RECSYS_ARCHS = ("two-tower-retrieval", "sasrec", "xdeepfm", "din")
EXECUTORS = ("reference", "kernel")
B, S, MB, STEPS = 8, 16, 2, 3  # LM rows, length, microbatches (JAX's global order), steps
OPT = dict(warmup_steps=1, total_steps=6)


def lm_cfg(case: str):
    arch, over = LM_CASES[case]
    cfg = get_arch(arch).reduced
    over = dict(over)
    if over.pop("local_dispatch", False):
        over["moe"] = dataclasses.replace(cfg.moe, local_dispatch=True)
    return dataclasses.replace(cfg, **over)


def recsys_cfg(arch: str):
    return get_arch(arch).reduced


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


def jax_state(z, prefix: str) -> dict:
    """JAX's ``TrainState`` saved under ``prefix`` as {"params", "opt"}."""
    opt = tree_of(z, prefix + "opt/")
    return {"params": tree_of(z, prefix + "params/"), "opt": opt, "error_fb": None}


def batches(z, prefix: str, n: int = STEPS) -> list:
    """The ``n`` global batches saved under ``prefix`` ("b<i>/<name>")."""
    out = []
    for i in range(n):
        pre = f"{prefix}b{i}/"
        out.append({k[len(pre):]: torch.from_numpy(z[k]) for k in z.files if k.startswith(pre)})
    return out


def prints(state) -> dict:
    """Each leaf's bits as bytes: equal leaves, equal prints."""
    return {k: v.detach().contiguous().numpy().tobytes() for k, v in ckpt.flatten(state)}


def block_key(name: str, layout) -> tuple:
    """Which block of ``name``'s parameter this rank holds (for a kv head
    shared by model ranks, the head's)."""
    mesh, key = layout.mesh, []
    for p in layout.param_specs[name]:
        if p is None:
            continue
        i = mesh.index_of(p)
        if p == ("model",) and layout.kv_shared(name) > 1:
            i //= layout.kv_shared(name)
        key.append(i)
    return tuple(key)


def joined(state, layout) -> dict:
    """The whole tensors of a state's params, m and v (collective)."""
    out = {}
    for name, t in ckpt.flatten(state):
        if name.split(".")[0] in ("params", "opt") and name != "opt.step":
            out[name] = layout.join(name, t.detach())
    return out


def root_gathered(state, layout) -> bool:
    """Every leaf of ``state`` gathered to rank 0 alone: there the joined
    tensor, None on every other rank (collective)."""
    ok = True
    for name, t in ckpt.flatten(state):
        got = layout.gather_to_root(name, t.detach())
        whole = layout.join(name, t.detach())
        ok = ok and (got is None if layout.mesh.rank else torch.equal(got, whole))
    return ok


def train_case(mesh, cfg, state, loss_fn, batch_list, layout):
    """STEPS steps over the mesh -> (the step-1 first microbatch's synced
    gradients joined, the metrics, every step's leaf prints and block keys,
    each step-1 gradient block finite and nonzero, the counted collectives
    of step 1)."""
    mb0 = shard_batch({k: v[: B // MB] for k, v in batch_list[0].items()}, mesh)
    loss, _ = loss_fn(state.params, mb0)
    g = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    g = sync_grads(g, layout)
    ok = {k: [bool(torch.isfinite(v).all()), bool(v.any())] for k, v in g.items()}
    grads = {k: layout.join("opt.m." + k, v) for k, v in g.items()}
    step = make_train_step(loss_fn, AdamWConfig(**OPT), microbatches=MB, layout=layout)
    metrics, steps = [], []
    for i, b in enumerate(batch_list):
        local = shard_batch(b, mesh, MB)
        if i == 0:
            with cost.StepCost() as c:
                state, m = step(state, local)
            counts = dict(c.op_counts)
        else:
            state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
        steps.append({k: v.detach().numpy().tobytes() for k, v in state.params.items()})
    return state, {"grads": grads, "metrics": metrics, "steps": steps, "grad_ok": ok,
                   "counts": counts, "keys": {k: block_key(k, layout) for k in state.params}}


def lm_world(group, npz: str, out_dir: str) -> None:
    """Every LM case on every mesh from JAX's initial state: the step-1
    gradients, 3 steps, the final params and moments joined (and each
    rank's moment blocks); at (2, 2) a compression round and a checkpoint
    saved over the mesh and restored in one process (and the reverse)."""
    torch.set_num_threads(1)
    z = np.load(npz)
    res = {}
    for shape in MESHES:
        mesh = group.mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        for case in LM_CASES:
            cfg = lm_cfg(case)
            layout = train_layout(cfg, mesh)
            state = state_from_jax(jax_state(z, f"{case}/init/"), cfg, device="cpu", mesh=mesh)
            state, out = train_case(mesh, cfg, state, lm_loss_fn(cfg, mesh), batches(z, "lm/"),
                                    layout)
            out["final"] = joined(state, layout)
            out["root"] = root_gathered(state, layout)
            out["m_blocks"] = {k: v.clone() for k, v in state.opt["m"].items()}
            out["zero1_dims"] = {k: layout.zero1_dim(k) for k in state.params}
            res[f"{case}/{tag}"] = out
            if shape == (2, 2) and case == "qwen3":
                res["ckpt"] = _checkpoint_round(z, cfg, mesh, layout, state, out_dir)
            if shape == (2, 2) and case == "mixtral_tp":
                res["compress"] = _compress_round(cfg, layout, state)
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


def _checkpoint_round(z, cfg, mesh, layout, state, out_dir: str) -> dict:
    """One process -> mesh: the test's one-process checkpoint (JAX's initial
    state) restored into this rank's blocks, then saved over the mesh ->
    one process; and the state after 3 steps saved over the mesh."""
    template = state_from_jax(jax_state(z, "qwen3/init/"), cfg, device="cpu", mesh=mesh)
    restored, at = ckpt.restore_checkpoint(os.path.join(out_dir, "one"), template, layout=layout)
    want = {k: v for k, v in ckpt.flatten(template)}
    same = all(torch.equal(v, want[k]) for k, v in ckpt.flatten(restored))
    ckpt.save_checkpoint(os.path.join(out_dir, "mesh"), at, restored, layout=layout)
    ckpt.save_checkpoint(os.path.join(out_dir, "trained"), STEPS, state, layout=layout)
    return {"restored_equal_blocks": same, "step": at}


def _compress_round(cfg, layout, state) -> dict:
    """Two rounds of int8 compression with error feedback over the blocks
    of seeded gradients (the moments' layout), joined."""
    rng = np.random.default_rng(5)
    full = {k: torch.from_numpy(rng.standard_normal(
        tuple(layout.join("params." + k, v.detach()).shape)).astype(np.float32))
        for k, v in state.params.items()}
    blocks = {k: layout.cut("opt.m." + k, v).contiguous() for k, v in full.items()}
    err = {k: torch.zeros_like(v) for k, v in blocks.items()}
    out = []
    for scale in (1.0, 0.5):
        deq, err = compress_grads({k: v * scale for k, v in blocks.items()}, err, layout=layout)
        out.append({"deq": {k: layout.join("opt.m." + k, v) for k, v in deq.items()},
                    "err": {k: layout.join("opt.m." + k, v) for k, v in err.items()}})
    return {"grads": full, "rounds": out}


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------


def recsys_loss_fn(cfg, executor: str, mesh=None):
    """The model's loss at ``executor`` (the model built once per params
    dict; on the CPU "kernel" runs the bag Function's plain versions)."""
    cache = {}

    def fn(params, batch):
        if cache.get("params") is not params:
            model = RECSYS_MODELS[type(cfg)].from_params(cfg, params, trainable=True, mesh=mesh)
            model.executor = executor
            cache.update(params=params, model=model)
        return cache["model"].loss(batch)

    return fn


def recsys_world(group, npz: str, out_dir: str) -> None:
    """Every recsys model at both executors on every mesh from JAX's initial
    state: the step-1 gradients, 3 steps, the final params and moments (at
    (2, 2) also saved as a checkpoint over the mesh)."""
    torch.set_num_threads(1)
    z = np.load(npz)
    res = {}
    for shape in MESHES:
        mesh = group.mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        for arch in RECSYS_ARCHS:
            cfg = recsys_cfg(arch)
            layout = train_layout(cfg, mesh)
            for ex in EXECUTORS:
                state = state_from_jax(jax_state(z, f"{arch}/init/"), cfg, device="cpu", mesh=mesh)
                loss_fn = recsys_loss_fn(cfg, ex, mesh)
                blist = batches(z, f"{arch}/")
                g_loss, _ = loss_fn(state.params, shard_batch(blist[0], mesh))
                g = dict(zip(state.params,
                             torch.autograd.grad(g_loss, list(state.params.values()))))
                g = sync_grads(g, layout)
                out = {"grad_ok": {k: [bool(torch.isfinite(v).all()), bool(v.any())]
                                   for k, v in g.items()},
                       "grads": {k: layout.join("opt.m." + k, v) for k, v in g.items()},
                       "keys": {k: block_key(k, layout) for k in state.params}}
                step = make_train_step(loss_fn, AdamWConfig(**OPT), layout=layout)
                out["metrics"], out["steps"] = [], []
                for i, b in enumerate(blist):
                    if i == 0:
                        with cost.StepCost() as c:
                            state, m = step(state, shard_batch(b, mesh))
                        out["counts"] = dict(c.op_counts)
                    else:
                        state, m = step(state, shard_batch(b, mesh))
                    out["metrics"].append({k: float(v) for k, v in m.items()})
                    out["steps"].append({k: v.detach().numpy().tobytes()
                                         for k, v in state.params.items()})
                out["final"] = joined(state, layout)
                out["root"] = root_gathered(state, layout)
                if shape == (2, 2) and ex == "reference":
                    ckpt.save_checkpoint(os.path.join(out_dir, arch), STEPS, state,
                                         layout=layout)
                res[f"{arch}/{tag}/{ex}"] = out
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


def recsys_shape():
    return RECSYS_SHAPES_REDUCED["train_batch"]


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

# case -> gin-tu's reduced shape; "nan" is full_graph_sm with one label
# >= n_classes, whose losses are NaN.
GNN_CASES = {"full_graph_sm": "full_graph_sm", "minibatch_lg": "minibatch_lg",
             "ogb_products": "ogb_products", "molecule": "molecule", "nan": "full_graph_sm"}


def gnn_cfg(case: str):
    return GNNFamily._cfg_for(get_arch("gin-tu"), GNN_SHAPES_REDUCED[GNN_CASES[case]], True)


def gnn_step(case: str, mesh=None):
    """The family's train step of the case's shape (over ``mesh``: a rank's),
    its AdamW at warmup 1 (``OPT``) so that 3 steps move the parameters."""
    from unittest import mock

    with mock.patch.object(families, "_OPT", AdamWConfig(**OPT)):
        return GNNFamily.step_fn(get_arch("gin-tu"), GNN_CASES[case], reduced=True, mesh=mesh)


def gnn_world(group, npz: str, out_dir: str) -> None:
    """Every GNN case on every mesh from JAX's initial state: the step-1
    gradients synced and joined, 3 steps of ``GNNFamily.step_fn(mesh=)``
    (step 1 counted), the final params and moments joined, every leaf
    gathered to rank 0 alone; at (2, 2) a checkpoint saved over the mesh."""
    torch.set_num_threads(1)
    z = np.load(npz)
    res = {}
    for shape in MESHES:
        mesh = group.mesh(shape)
        tag = f"{shape[0]}x{shape[1]}"
        for case in GNN_CASES:
            cfg = gnn_cfg(case)
            layout = train_layout(cfg, mesh)
            state = state_from_jax(jax_state(z, f"{case}/init/"), cfg, device="cpu", mesh=mesh)
            blist = batches(z, f"{case}/")
            loss_fn = gnn_loss_fn(cfg, GNN_SHAPES_REDUCED[GNN_CASES[case]].n_graphs, mesh)
            loss, _ = loss_fn(state.params, shard_batch(blist[0], mesh))
            g = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
            g = sync_grads(g, layout)
            out = {"grad_ok": {k: [bool(torch.isfinite(v).all()), bool(v.any())]
                               for k, v in g.items()},
                   "grads": {k: layout.join("opt.m." + k, v) for k, v in g.items()},
                   "keys": {k: block_key(k, layout) for k in state.params},
                   "metrics": [], "steps": []}
            step = gnn_step(case, mesh)
            for i, b in enumerate(blist):
                if i == 0:
                    with cost.StepCost() as c:
                        state, m = step(state, shard_batch(b, mesh))
                    out["counts"] = dict(c.op_counts)
                else:
                    state, m = step(state, shard_batch(b, mesh))
                out["metrics"].append({k: float(v) for k, v in m.items()})
                out["steps"].append({k: v.detach().numpy().tobytes()
                                     for k, v in state.params.items()})
            out["final"] = joined(state, layout)
            out["root"] = root_gathered(state, layout)
            if shape == (2, 2):
                ckpt.save_checkpoint(os.path.join(out_dir, case), STEPS, state, layout=layout)
            res[f"{case}/{tag}"] = out
    torch.save(res, os.path.join(out_dir, f"rank{group.rank}.pt"))


__all__ = ["MESHES", "LM_CASES", "RECSYS_ARCHS", "EXECUTORS", "B", "S", "MB", "STEPS", "OPT",
           "lm_cfg", "recsys_cfg", "tree_of", "jax_state", "batches", "prints", "lm_world",
           "recsys_world", "recsys_loss_fn", "sharding", "GNN_CASES", "gnn_cfg", "gnn_step",
           "gnn_world"]
