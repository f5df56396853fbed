"""Family entry points of the port and their shapes: the port's copy of
``repro/configs/families.py`` for the LM, GNN and recsys families.

Each family runs its cells: ``shape_cell``, ``abstract_state`` (the
step's state as a tree of (shape, dtype) pairs shaped like the port's own:
``TrainState``'s params and AdamW moments for train cells, the weights
for serving ones, bf16 for the LM's; made on the ``meta`` device, so
nothing is allocated even for dbrx-132b), ``input_specs`` (each input as a
(shape, dtype) pair), ``step_fn`` (train through
``train.make_train_step``, the LM with the arch's ``train_microbatches``;
prefill, decode, serve and retrieval through the model) and ``smoke`` (the
reduced config for real). The loss of a train step builds its model once
per params dict, a view onto ``TrainState``'s parameters (``lm_loss_fn``,
``gnn_loss_fn``, ``recsys_loss_fn``; ``encoder_loss_fn`` for the XTR token
encoder, which has no family). ``state_pspec`` and
``input_pspec`` are JAX's, over a ``RankMesh`` (``launch/mesh.py``) and
the port's own tensors (``launch/sharding.py``): they place a cell's
state and inputs on the ranks of a mesh (``launch/dryrun.py``). The LM and
recsys ``step_fn(..., mesh=)`` of a train cell (and GNN's, over its
replicated parameters and its block of the graph) is the rank's step over its
blocks (``train.make_train_step(..., layout=convert.train_layout(cfg,
mesh))``, ZeRO-1 moments where ``state_pspec`` makes them so), on its
rows of the global batch: ``train.shard_batch(batch, mesh,
microbatches)``, ``input_pspec``'s block of each microbatch in JAX's
order.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchDef, ShapeCell
from repro_torch.core.types import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import data_axes
from repro_torch.models.convert import init_params, train_layout
from repro_torch.models.encoder import EncoderConfig, TokenEncoder
from repro_torch.models.gnn import GIN, GINConfig
from repro_torch.models.recsys import (
    RECSYS_MODELS,
    DINConfig,
    SASRecConfig,
    TwoTowerConfig,
    XDeepFMConfig,
    serve_step,
)
from repro_torch.models.transformer import KVCache, TransformerConfig, TransformerLM
from repro_torch.train.loop import TrainState, make_train_step
from repro_torch.train.optimizer import AdamWConfig

__all__ = [
    "spec_tree",
    "LMShape", "LM_SHAPES", "LM_SHAPES_REDUCED", "LMFamily", "lm_loss_fn",
    "encoder_loss_fn",
    "GNNShape", "GNN_SHAPES", "GNN_SHAPES_REDUCED", "GNNFamily", "gnn_loss_fn",
    "RecsysShape", "RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED", "RecsysFamily", "recsys_loss_fn",
]

_OPT = AdamWConfig()


def spec_tree(tree):
    """A tree of tensors (dicts, ``TrainState``) as the same tree of
    (shape, dtype) pairs; a ``TrainState`` becomes {"params", "opt"}."""
    if isinstance(tree, TrainState):
        tree = {"params": tree.params, "opt": tree.opt}
    if isinstance(tree, dict):
        return {k: spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), tree.dtype)


@functools.lru_cache(maxsize=64)
def _param_specs(cfg) -> dict:
    """``init_params(cfg)`` made on the ``meta`` device, as (shape, dtype)
    pairs: nothing is allocated."""
    return spec_tree(init_params(cfg, torch.Generator(), device="meta"))


def _state_pspec_from_params(pp: dict) -> dict:
    """``TrainState``'s specs: the moments mirror the parameters."""
    return {"params": pp, "opt": {"m": pp, "v": pp, "step": shd.P()}}


def _train_state_specs(cfg) -> dict:
    """``TrainState.create`` over meta tensors of ``cfg``'s parameters."""
    meta = {k: torch.empty(dims, dtype=dtype, device="meta")
            for k, (dims, dtype) in _param_specs(cfg).items()}
    return spec_tree(TrainState.create(meta))


# ======================================================================= LM
@dataclasses.dataclass(frozen=True)
class LMShape:
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


LM_SHAPES = {
    "train_4k": LMShape(4096, 256, "train"),
    "prefill_32k": LMShape(32768, 32, "prefill"),
    "decode_32k": LMShape(32768, 128, "decode"),
    "long_500k": LMShape(524288, 1, "decode"),
}

# Reduced geometry used by smoke tests (same kind, tiny sizes).
LM_SHAPES_REDUCED = {
    "train_4k": LMShape(64, 4, "train"),
    "prefill_32k": LMShape(128, 2, "prefill"),
    "decode_32k": LMShape(128, 4, "decode"),
    "long_500k": LMShape(256, 1, "decode"),
}


class _Loss:
    """``loss_fn(params, batch) -> (loss, metrics)`` over a state dict of
    ``nn.Parameter``s (``TrainState``'s): the model is a view onto those
    very tensors, built by ``make(params)`` once per params dict, and
    ``call(model, batch)`` gives its loss."""

    def __init__(self, make, call):
        self._make, self._call = make, call
        self._params = self._model = None

    def __call__(self, params: dict, batch: dict):
        if params is not self._params:
            self._model = self._make(params)
            self._params = params
        return self._call(self._model, batch)


def lm_loss_fn(cfg: TransformerConfig, mesh=None) -> _Loss:
    """``TransformerLM.loss`` of ``cfg`` (over ``mesh``: of a rank's blocks)."""
    return _Loss(lambda p: TransformerLM.from_params(cfg, p, trainable=True, mesh=mesh),
                 lambda m, b: m.loss(b["tokens"], b["labels"]))


def encoder_loss_fn(cfg: EncoderConfig, loss) -> _Loss:
    """``loss(encoder, batch)`` over a trainable ``TokenEncoder`` of ``cfg``
    (the XTR in-batch objective of ``examples/train_encoder_torch.py``)."""
    return _Loss(lambda p: TokenEncoder.from_params(cfg, p, trainable=True), loss)


def _train_step(cfg, loss_fn, microbatches: int, mesh):
    """``make_train_step`` of a train cell, over ``mesh`` when given."""
    if mesh is None:
        return make_train_step(loss_fn, _OPT, microbatches=microbatches)
    return make_train_step(loss_fn, _OPT, microbatches=microbatches, layout=train_layout(cfg, mesh))


class LMFamily:
    name = "lm"

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = LM_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))

    @staticmethod
    def abstract_state(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """train: {"params", "opt": {"m", "v", "step"}} of ``TrainState``;
        prefill and decode: the weights in bf16. name -> (shape, dtype)."""
        cfg: TransformerConfig = arch.reduced if reduced else arch.config
        s = (LM_SHAPES_REDUCED if reduced else LM_SHAPES)[shape]
        if s.kind == "train":
            return _train_state_specs(cfg)
        return {k: (dims, torch.bfloat16) for k, (dims, _) in _param_specs(cfg).items()}

    @staticmethod
    def input_specs(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """name -> (shape, dtype); a cache is a dict of its k, v and length
        (bf16 k/v, as JAX's ``KVCache.empty`` default)."""
        cfg: TransformerConfig = arch.reduced if reduced else arch.config
        s = (LM_SHAPES_REDUCED if reduced else LM_SHAPES)[shape]
        b, sl = s.global_batch, s.seq_len
        if s.kind == "train":
            return {"tokens": ((b, sl), torch.int32), "labels": ((b, sl), torch.int32)}
        kv = ((cfg.n_layers, b, sl, cfg.n_kv_heads, cfg.resolved_head_dim), torch.bfloat16)
        cache = {"k": kv, "v": kv, "length": ((b,), torch.int32)}
        tokens = (b, sl) if s.kind == "prefill" else (b,)
        return {"tokens": (tokens, torch.int32), "cache": cache}

    @staticmethod
    def step_fn(arch: ArchDef, shape: str, *, reduced: bool = False, mesh=None):
        """train: ``step(TrainState, batch) -> (TrainState, metrics)`` (with
        ``mesh``, a rank's, see the module); prefill and decode:
        ``step(model, batch) -> (logits, cache)``."""
        cfg: TransformerConfig = arch.reduced if reduced else arch.config
        s = (LM_SHAPES_REDUCED if reduced else LM_SHAPES)[shape]
        if s.kind == "train":
            return _train_step(cfg, lm_loss_fn(cfg, mesh), arch.train_microbatches, mesh)
        if s.kind == "prefill":
            def prefill_step(model: TransformerLM, batch):
                return model.prefill(batch["tokens"], batch["cache"])
            return prefill_step

        def decode_step(model: TransformerLM, batch):
            return model.decode_step(batch["tokens"], batch["cache"])
        return decode_step

    @staticmethod
    def state_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """``lm_param_pspec`` of the weights (the config's ``embed_shard``
        and ``moe_weight_mode``); a train cell's ``TrainState``, its moments
        ZeRO-1 under ``tp_only``."""
        s = LM_SHAPES[shape]
        cfg: TransformerConfig = arch.config
        params_abs = _param_specs(cfg)
        pp = shd.lm_param_pspec(params_abs, mesh, embed_shard=cfg.embed_shard,
                                moe_weight_mode=cfg.moe_weight_mode)
        if s.kind != "train":
            return pp
        if cfg.moe_weight_mode == "tp_only":
            opt_pp = shd.zero1_opt_pspec(pp, params_abs, mesh)
            return {"params": pp, "opt": {"m": opt_pp, "v": opt_pp, "step": shd.P()}}
        return _state_pspec_from_params(pp)

    @staticmethod
    def input_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """Tokens over the data axes; the cache by ``kv_cache_pspec``, by
        sequence for batch-1 decode (``long_500k``)."""
        s = LM_SHAPES[shape]
        fsdp = data_axes(mesh)
        if s.kind == "train":
            return {"tokens": shd.P(fsdp, None), "labels": shd.P(fsdp, None)}
        shard_seq = s.global_batch == 1
        cache = LMFamily.input_specs(arch, shape)["cache"]
        cache_ps = shd.kv_cache_pspec(cache, mesh, shard_seq=shard_seq)
        if s.kind == "prefill":
            tok = shd.P(fsdp, None)
        else:
            tok = shd.P() if shard_seq else shd.P(fsdp)
        return {"tokens": tok, "cache": cache_ps}

    @staticmethod
    def smoke(arch: ArchDef, shape: str, seed: int = 0, *, device=None) -> dict:
        """The reduced config for real on ``device`` (None: the card), weights
        and tokens from ``seed``: {"loss"} for train, {"logits"} else."""
        dev = resolve_device(device)
        cfg: TransformerConfig = arch.reduced
        s = LM_SHAPES_REDUCED[shape]
        g = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(cfg, g, device=dev)
        b, sl = s.global_batch, s.seq_len
        tokens = torch.randint(0, cfg.vocab, (b, sl), generator=g, device=dev)
        step = LMFamily.step_fn(arch, shape, reduced=True)
        if s.kind == "train":
            _, metrics = step(TrainState.create(params), {"tokens": tokens, "labels": tokens})
            return {"loss": metrics["loss"]}
        model = TransformerLM.from_params(cfg, params)
        cache = KVCache.empty(cfg, b, sl, torch.float32, device=dev)
        if s.kind == "prefill":
            return {"logits": step(model, {"tokens": tokens, "cache": cache})[0]}
        # decode: prefill a short prompt then decode one token
        _, cache = model.prefill(tokens[:, : sl // 2], cache)
        return {"logits": step(model, {"tokens": tokens[:, 0], "cache": cache})[0]}


# ====================================================================== GNN
@dataclasses.dataclass(frozen=True)
class GNNShape:
    kind: str
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int
    n_graphs: int | None = None  # molecule batching
    batch_nodes: int | None = None  # minibatch seeds


# Node/edge counts are the assigned sizes padded UP to multiples of 512
# (JAX's mesh rule); validity masks cover the padding (Cora 2708->2816
# nodes, 10556->10752 edges; ogbn-products 2449029->2449408 /
# 61859140->61859840).
GNN_SHAPES = {
    "full_graph_sm": GNNShape("train", 2816, 10752, 1433, 7),
    "minibatch_lg": GNNShape("train", 170240, 169984, 602, 41, batch_nodes=1024),
    "ogb_products": GNNShape("train", 2449408, 61859840, 100, 47),
    "molecule": GNNShape("train", 30 * 128, 64 * 128, 16, 2, n_graphs=128),
}

GNN_SHAPES_REDUCED = {
    "full_graph_sm": GNNShape("train", 120, 480, 16, 7),
    "minibatch_lg": GNNShape("train", 512, 960, 16, 8, batch_nodes=32),
    "ogb_products": GNNShape("train", 256, 1024, 16, 8),
    "molecule": GNNShape("train", 10 * 8, 16 * 8, 8, 2, n_graphs=8),
}


def gnn_loss_fn(cfg: GINConfig, n_graphs: int | None = None, mesh=None) -> _Loss:
    """``GIN.loss`` of ``cfg``, with ``n_graphs`` added to each batch for
    graph readout (over ``mesh``, of a rank's blocks of the batch)."""
    extra = {"n_graphs": n_graphs} if n_graphs else {}
    return _Loss(lambda p: GIN.from_params(cfg, p, trainable=True),
                 lambda m, b: m.loss({**b, **extra}, mesh=mesh))


class GNNFamily:
    """GIN on the four graph shapes; every cell trains."""

    name = "gnn"

    @staticmethod
    def _cfg_for(arch: ArchDef, s: GNNShape, reduced: bool) -> GINConfig:
        base: GINConfig = arch.reduced if reduced else arch.config
        return dataclasses.replace(
            base,
            d_feat=s.d_feat,
            n_classes=s.n_classes,
            readout="graph" if s.n_graphs else "node",
        )

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = GNN_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))

    @staticmethod
    def abstract_state(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """``TrainState``'s {"params", "opt"} as (shape, dtype) pairs."""
        s = (GNN_SHAPES_REDUCED if reduced else GNN_SHAPES)[shape]
        return _train_state_specs(GNNFamily._cfg_for(arch, s, reduced))

    @staticmethod
    def input_specs(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        s = (GNN_SHAPES_REDUCED if reduced else GNN_SHAPES)[shape]
        spec = {
            "x": ((s.n_nodes, s.d_feat), torch.float32),
            "edge_src": ((s.n_edges,), torch.int32),
            "edge_dst": ((s.n_edges,), torch.int32),
            "labels": ((s.n_graphs or s.n_nodes,), torch.int32),
        }
        if s.batch_nodes:  # sampled subgraph: padded edges + seed-only labels
            spec["edge_mask"] = ((s.n_edges,), torch.float32)
            spec["label_mask"] = ((s.n_nodes,), torch.float32)
            spec["labels"] = ((s.n_nodes,), torch.int32)
        if s.n_graphs:
            spec["graph_ids"] = ((s.n_nodes,), torch.int32)
        return spec

    @staticmethod
    def local_input_specs(arch: ArchDef, shape: str, mesh, *, reduced: bool = False) -> dict:
        """``input_specs`` of one rank's block by ``input_pspec``: every node
        and edge array (and molecule's graphs) over the data axes. Every
        reduced and full shape divides over 2 and 4 data ranks, so there is
        no padding rule: a mesh whose data axes do not divide a shape
        raises."""
        specs = GNNFamily.input_specs(arch, shape, reduced=reduced)
        ps = GNNFamily.input_pspec(arch, shape, mesh)
        out = {k: (shd.local_shape(dims, ps[k], mesh), dtype) for k, (dims, dtype) in specs.items()}
        n_graphs = (GNN_SHAPES_REDUCED if reduced else GNN_SHAPES)[shape].n_graphs
        if n_graphs:  # the readout's graphs, reduce-scattered to the labels' block
            shd.local_shape((n_graphs,), ps["labels"], mesh)
        return out

    @staticmethod
    def step_fn(arch: ArchDef, shape: str, *, reduced: bool = False, mesh=None):
        """``step(TrainState, batch) -> (TrainState, metrics)``; with
        ``mesh``, a rank's step over its blocks of the batch
        (``local_input_specs``; ``train.shard_batch`` cuts them) and the
        replicated state."""
        s = (GNN_SHAPES_REDUCED if reduced else GNN_SHAPES)[shape]
        cfg = GNNFamily._cfg_for(arch, s, reduced)
        if mesh is not None:  # raises where the mesh does not split the graph
            GNNFamily.local_input_specs(arch, shape, mesh, reduced=reduced)
        return _train_step(cfg, gnn_loss_fn(cfg, s.n_graphs, mesh), 1, mesh)

    @staticmethod
    def state_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """Parameters (and moments) replicated."""
        s = GNN_SHAPES[shape]
        cfg = GNNFamily._cfg_for(arch, s, reduced=False)
        return _state_pspec_from_params(shd.replicated(_param_specs(cfg)))

    @staticmethod
    def input_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """Every node and edge array over the data axes."""
        return shd.batch_pspec(GNNFamily.input_specs(arch, shape), mesh)

    @staticmethod
    def smoke(arch: ArchDef, shape: str, seed: int = 0, *, device=None, params=None) -> dict:
        """One train step of the reduced config on ``device`` (None: the
        card) -> {"loss"}: the batch drawn as JAX's smoke draws it (numpy,
        seed 0), the weights ``params`` (a state dict) or drawn from
        ``seed``."""
        dev = resolve_device(device)
        s = GNN_SHAPES_REDUCED[shape]
        cfg = GNNFamily._cfg_for(arch, s, reduced=True)
        rng = np.random.default_rng(0)
        batch = {
            "x": rng.standard_normal((s.n_nodes, s.d_feat)).astype(np.float32),
            "edge_src": rng.integers(0, s.n_nodes, s.n_edges).astype(np.int32),
            "edge_dst": rng.integers(0, s.n_nodes, s.n_edges).astype(np.int32),
            "labels": rng.integers(0, s.n_classes, s.n_graphs or s.n_nodes).astype(np.int32),
        }
        if s.batch_nodes:
            batch["edge_mask"] = np.ones((s.n_edges,), np.float32)
            lm = np.zeros((s.n_nodes,), np.float32)
            lm[: s.batch_nodes] = 1.0
            batch["label_mask"] = lm
            batch["labels"] = rng.integers(0, s.n_classes, s.n_nodes).astype(np.int32)
        if s.n_graphs:
            batch["graph_ids"] = np.repeat(
                np.arange(s.n_graphs), s.n_nodes // s.n_graphs
            ).astype(np.int32)
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        state = TrainState.create(params)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        _, metrics = GNNFamily.step_fn(arch, shape, reduced=True)(state, batch)
        return {"loss": metrics["loss"]}


# =================================================================== RecSys
@dataclasses.dataclass(frozen=True)
class RecsysShape:
    kind: str
    batch: int
    n_candidates: int | None = None


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train", 65536),
    "serve_p99": RecsysShape("serve", 512),
    "serve_bulk": RecsysShape("serve", 262144),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=1_000_000),
}

RECSYS_SHAPES_REDUCED = {
    "train_batch": RecsysShape("train", 64),
    "serve_p99": RecsysShape("serve", 16),
    "serve_bulk": RecsysShape("serve", 128),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=512),
}


class RecsysFamily:
    """``batch`` is users (or rows) per step; ``retrieval`` scores one user
    against ``n_candidates``. The train step is ``make_train_step`` over
    the model's ``loss``; the serve and retrieval steps are
    ``models.recsys.serve_step(model, shape)``."""

    name = "recsys"

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = RECSYS_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))

    @staticmethod
    def abstract_state(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """train: ``TrainState``'s {"params", "opt"}; serve and retrieval:
        the float32 weights. name -> (shape, dtype)."""
        cfg = arch.reduced if reduced else arch.config
        s = (RECSYS_SHAPES_REDUCED if reduced else RECSYS_SHAPES)[shape]
        if s.kind == "train":
            return _train_state_specs(cfg)
        return dict(_param_specs(cfg))

    @staticmethod
    def input_specs(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """name -> (shape, dtype), in JAX's order."""
        cfg = arch.reduced if reduced else arch.config
        s = (RECSYS_SHAPES_REDUCED if reduced else RECSYS_SHAPES)[shape]
        b, nc = s.batch, s.n_candidates
        i32, f32 = torch.int32, torch.float32
        if isinstance(cfg, TwoTowerConfig):
            if s.kind == "retrieval":
                return {
                    "user_ids": ((b, cfg.user_fields), i32),
                    "user_mask": ((b, cfg.user_fields), f32),
                    "cand_emb": ((nc, cfg.tower_mlp[-1]), f32),
                }
            out = {
                "user_ids": ((b, cfg.user_fields), i32),
                "user_mask": ((b, cfg.user_fields), f32),
                "item_ids": ((b, cfg.item_fields), i32),
                "item_mask": ((b, cfg.item_fields), f32),
            }
            if s.kind == "train":
                out["log_q"] = ((b,), f32)
            return out
        if isinstance(cfg, SASRecConfig):
            base = {"seq_ids": ((b, cfg.seq_len), i32), "seq_mask": ((b, cfg.seq_len), f32)}
            if s.kind == "train":
                base["pos_ids"] = ((b, cfg.seq_len), i32)
                base["neg_ids"] = ((b, cfg.seq_len), i32)
            elif s.kind == "serve":
                base["target_ids"] = ((b,), i32)
            else:
                base["cand_ids"] = ((nc,), i32)
            return base
        if isinstance(cfg, XDeepFMConfig):
            rows = nc if s.kind == "retrieval" else b
            out = {"field_ids": ((rows, cfg.n_fields), i32)}
            if s.kind == "train":
                out["labels"] = ((rows,), f32)
            return out
        if isinstance(cfg, DINConfig):
            if s.kind == "retrieval":
                return {
                    "target_ids": ((nc,), i32),
                    "hist_ids": ((1, cfg.seq_len), i32),
                    "hist_mask": ((1, cfg.seq_len), f32),
                }
            out = {
                "target_ids": ((b,), i32),
                "hist_ids": ((b, cfg.seq_len), i32),
                "hist_mask": ((b, cfg.seq_len), f32),
            }
            if s.kind == "train":
                out["labels"] = ((b,), f32)
            return out
        raise TypeError(type(cfg))

    @staticmethod
    def step_fn(arch: ArchDef, shape: str, *, reduced: bool = False, mesh=None):
        """train: ``step(TrainState, batch) -> (TrainState, metrics)`` (with
        ``mesh``, a rank's, see the module); serve and retrieval:
        ``step(model, batch)``, ``serve_step``'s."""
        cfg = arch.reduced if reduced else arch.config
        s = (RECSYS_SHAPES_REDUCED if reduced else RECSYS_SHAPES)[shape]
        if s.kind == "train":
            return _train_step(cfg, recsys_loss_fn(cfg, mesh), arch.train_microbatches, mesh)

        def step(model, batch):
            return serve_step(model, s)(batch)
        return step

    @staticmethod
    def state_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """``recsys_param_pspec`` of the weights (and of a train cell's
        moments)."""
        pp = shd.recsys_param_pspec(_param_specs(arch.config), mesh)
        return _state_pspec_from_params(pp) if RECSYS_SHAPES[shape].kind == "train" else pp

    @staticmethod
    def input_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """Batches over the data axes; at retrieval the candidate axis is
        the parallel one (one user, history or sequence replicated)."""
        specs = RecsysFamily.input_specs(arch, shape)
        ps = shd.batch_pspec(specs, mesh)
        if RECSYS_SHAPES[shape].kind == "retrieval":
            fsdp = data_axes(mesh)
            if "cand_emb" in specs:
                ps.update(cand_emb=shd.P(fsdp, None), user_ids=shd.P(None, None),
                          user_mask=shd.P(None, None))
            if "cand_ids" in specs:
                ps.update(cand_ids=shd.P(fsdp), seq_ids=shd.P(None, None),
                          seq_mask=shd.P(None, None))
            if "target_ids" in specs and "hist_ids" in specs:
                ps.update(target_ids=shd.P(fsdp), hist_ids=shd.P(None, None),
                          hist_mask=shd.P(None, None))
            if "field_ids" in specs:
                ps["field_ids"] = shd.P(fsdp, None)
        return ps

    @staticmethod
    def output_pspec(arch: ArchDef, shape: str, mesh):
        """The spec of a serve or retrieval step's output over ``mesh``: the
        rows of the batch, or at retrieval the candidates (two-tower's and
        SASRec's [B, N] scores along N), over the data axes."""
        fsdp = data_axes(mesh)
        s = RECSYS_SHAPES[shape]
        if s.kind == "retrieval" and isinstance(arch.config, (TwoTowerConfig, SASRecConfig)):
            return shd.P(None, fsdp)
        return shd.P(fsdp)

    @staticmethod
    def smoke(arch: ArchDef, shape: str, seed: int = 0, *, device=None, params=None) -> dict:
        """The reduced config for real on ``device`` (None: the card): the
        batch drawn as JAX's smoke draws it (numpy, seed 0: ids below the
        smallest vocabulary, masks 1, labels 0/1, floats standard normal),
        the weights ``params`` (a state dict) or drawn from ``seed``.
        -> {"loss"} for train, {"scores"} else."""
        dev = resolve_device(device)
        cfg = arch.reduced
        s = RECSYS_SHAPES_REDUCED[shape]
        specs = RecsysFamily.input_specs(arch, shape, reduced=True)
        rng = np.random.default_rng(0)

        def realize(name, spec):
            dims, dtype = spec
            if dtype == torch.int32:
                vocabs = [getattr(cfg, a) for a in ("user_vocab", "item_vocab", "vocab")
                          if hasattr(cfg, a)]
                hi = min(vocabs) if vocabs else 8
                return rng.integers(0, hi, dims).astype(np.int32)
            if "mask" in name:
                return np.ones(dims, np.float32)
            if name == "labels":
                return rng.integers(0, 2, dims).astype(np.float32)
            return rng.standard_normal(dims).astype(np.float32)

        batch = {k: torch.from_numpy(realize(k, v)).to(dev) for k, v in specs.items()}
        if params is None:
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
        step = RecsysFamily.step_fn(arch, shape, reduced=True)
        if s.kind == "train":
            _, metrics = step(TrainState.create(params), batch)
            return {"loss": metrics["loss"]}
        return {"scores": step(RECSYS_MODELS[type(cfg)].from_params(cfg, params), batch)}


def recsys_loss_fn(cfg, mesh=None) -> _Loss:
    """The recsys model's ``loss`` for ``cfg`` (the executor resolved from
    the weights' device: the bag kernel on the card; over ``mesh``, of a
    rank's blocks)."""
    model = RECSYS_MODELS[type(cfg)]
    return _Loss(lambda p: model.from_params(cfg, p, trainable=True, mesh=mesh),
                 lambda m, b: m.loss(b))
