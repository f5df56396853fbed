"""RecSys models of the port: two-tower retrieval, SASRec, xDeepFM (CIN),
DIN, with their serving methods. Counterpart of ``repro/models/recsys.py``.

The configs keep every field and default of the JAX ones. Each model is an
``nn.Module`` built with ``from_params`` from a state dict
(``convert.init_params`` or ``convert.params_from_jax``); dense layers keep
``nn.Linear``'s [d_out, d_in] layout. Its ``executor`` picks where the bag
sums run, resolved as ``TransformerLM`` resolves it: "kernel" the
hand-written CUDA embedding-bag kernel (``ops.embedding_bag(...,
use_kernel=True)``), "reference" JAX's code line for line (``jnp.take``'s
rows summed), "auto" the kernel on CUDA and the reference on the CPU. The
bag sums are the two-tower pooling (weights = mask, then divided by
max(sum mask, 1)), DIN's interest pooling (weights = the masked attention
weights) and xDeepFM's linear term (a bag of width 1 with weight 1).
SASRec has no bag: both executors run the same code, and its masked
attention stays plain (the flash kernel takes no key-padding mask).

Gathers that are not bag sums use ``ref.take``, ``jnp.take``'s semantics
(an index outside [-V, V) gives NaN). The kernel drops an index outside
[0, V) instead, as the TPU kernel does, so the executors agree on ids in
range.

Over a mesh of ranks (``from_params(..., mesh=)``, weights from
``convert.init_params(..., mesh=)``), each table whose rows divide the
model axis holds only the rank's row range (``recsys_param_pspec``); the
rest is replicated. A bag sum runs on the rank's rows, ids shifted by the
range's start (an id outside the range adds 0, the kernel's own rule; it
goes in as -1 with weight 0, so the kernel reads no row for it), and the
partial bags are all-reduced over the model axis. A plain gather
(``take``) takes the rank's rows, 0 elsewhere, all-reduced: exact, since
one rank gives each element; an id outside the table's [-V, V) still
gives ``ref.take``'s NaN. Batches are the rank's block (split over the
data axes by ``RecsysFamily.input_pspec``), and so are the outputs.

Training: ``from_params(..., trainable=True)`` keeps the weights
trainable, and each model's ``loss(batch) -> (loss, metrics)`` is JAX's
line for line (two-tower: in-batch softmax with the logQ correction;
SASRec: masked BCE over positives and sampled negatives; xDeepFM and DIN:
stable BCE). The serving methods run under ``torch.inference_mode``; the
losses run the same code with grad enabled. At the kernel executor the bag
sums take their gradient from the bag kernel's backward
(``kernels/embedding_bag.py``): the table's dense, DIN's attention
weights' too. ``RecsysFamily.step_fn`` (``configs/families.py``) trains
them.

Over a mesh they train too (``from_params(..., trainable=True, mesh=)``):
the model-axis sums of the takes and bags pass their gradient on as it is,
so each rank's rows of a table get their whole gradient; the bag's weights
(DIN's attention weights, replicated over the model axis) go through
``copy_to``, since each rank's bag gives their gradient only at the slots
of its own rows. The losses are JAX's over the global batch: a mean is a
sum over the data axes divided by the global count, SASRec's masked mean
the two sums; two-tower's in-batch softmax gathers the item embeddings and
``log_q`` over the data axes (the gather reduce-scatters the embeddings'
gradient), each rank's rows against every item of the batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

__all__ = [
    "TwoTowerConfig",
    "TwoTower",
    "SASRecConfig",
    "SASRec",
    "XDeepFMConfig",
    "XDeepFM",
    "DINConfig",
    "DIN",
    "RECSYS_MODELS",
    "serve_step",
]


def _mlp_layers(dims: tuple[int, ...]) -> nn.ModuleList:
    return nn.ModuleList(L.Dense(dims[i], dims[i + 1], bias=True) for i in range(len(dims) - 1))


def _mlp(layers: nn.ModuleList, x: torch.Tensor, final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1 or final_act:
            x = F.relu(x)
    return x


def _table(vocab: int, dim: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(vocab, dim))


class _Recsys(nn.Module):
    """Executor resolution and construction shared by the four models;
    each resolves its executor at the end of its constructor."""

    def __init__(self, cfg, *, executor: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.executor = executor
        self.mesh = None
        self._row_range: dict = {}  # table name -> (first row, rows of the full table)

    @classmethod
    def from_params(cls, cfg, params: dict, *, executor: str = "auto", trainable: bool = False,
                    mesh=None):
        """A model that takes ``params`` (a state dict in the module's names)
        as its parameters without copying them: two models of one set of
        weights (one per executor) share the tensors. Serving weights are
        frozen. ``trainable=True`` leaves them trainable; where ``params``
        holds ``nn.Parameter``s (``train.TrainState``'s), the model's
        parameters are those very objects, so gradients land on them.
        With ``mesh``, ``params`` are this rank's blocks (see the module)."""
        with torch.device("meta"):
            model = cls(cfg, executor="reference")
        if mesh is None:
            model.load_state_dict(params, strict=True, assign=True)
        else:
            model._place(params, mesh, trainable)
        if not trainable:
            model.requires_grad_(False)
        model.executor = executor
        model._resolve_executor()
        return model

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _resolve_executor(self) -> None:
        self.executor = L.resolve_executor(
            self.executor, self.device, "the CUDA embedding-bag kernel"
        )

    def _place(self, params: dict, mesh, trainable: bool = False) -> None:
        """Take this rank's blocks as the parameters (``L.assign_blocks``),
        and note each table held by row range."""
        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import MODEL_AXIS
        from repro_torch.models.convert import param_specs

        specs = param_specs(self.cfg, mesh)
        rows = {k: v.shape[0] for k, v in self.state_dict().items()}
        L.assign_blocks(self, params, lambda name, shape: sharding.local_shape(
            shape, specs[name], mesh), trainable)
        for name, spec in specs.items():
            if spec[0] is not None and mesh.size_of(spec[0]) > 1:
                local = params[name].shape[0]
                self._row_range[name] = (mesh.index_of(MODEL_AXIS) * local, rows[name])
        self.mesh = mesh

    def take(self, name: str, ids) -> torch.Tensor:
        """``ref.take(table, ids)`` of the table ``name``; over a mesh, of
        its rows wherever they are held (see the module)."""
        table = getattr(self, name)
        if name not in self._row_range:
            return ref.take(table, ids)
        from repro_torch.launch.mesh import MODEL_AXIS

        start, v = self._row_range[name]
        rows = table.shape[0]
        idx = ids.long()
        idx = torch.where(idx < 0, idx + v, idx)
        valid = (idx >= 0) & (idx < v)
        local = idx - start
        own = (local >= 0) & (local < rows)
        shape = (*own.shape, *[1] * (table.dim() - 1))
        part = torch.where(own.reshape(shape), table[local.clamp(0, rows - 1)], 0.0)
        out = self.mesh.all_reduce(part, MODEL_AXIS)
        return out.masked_fill_(~valid.reshape(shape), math.nan)

    def _bag(self, name: str, ids, weights) -> torch.Tensor:
        """sum_l weights[b, l] * table[ids[b, l]] of the table ``name``
        through the kernel (differentiable in the table and the weights);
        over a mesh, on the rank's rows, all-reduced."""
        table = getattr(self, name)
        if name not in self._row_range:
            return ops.embedding_bag(table, bag_indices=ids, bag_weights=weights, use_kernel=True)
        from repro_torch.launch.mesh import MODEL_AXIS

        start, _ = self._row_range[name]
        local = ids.long() - start
        own = (local >= 0) & (local < table.shape[0])
        local = torch.where(own, local, -1).to(ids.dtype)
        weights = self.mesh.copy_to(weights, MODEL_AXIS)
        part = ops.embedding_bag(table, bag_indices=local,
                                 bag_weights=torch.where(own, weights, 0.0), use_kernel=True)
        return self.mesh.all_reduce(part, MODEL_AXIS)


def _data(mesh):
    """The data axes of ``mesh`` when they hold more than one rank, else None."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import data_axes

    data = data_axes(mesh)
    return data if mesh.size_of(data) > 1 else None


def _global_mean(x, mesh):
    """The mean of x over the global batch: over the data axes, the sum of
    the ranks' sums over the global count (each rank's gradient is its own
    rows' share)."""
    data = _data(mesh)
    if data is None:
        return torch.mean(x)
    return mesh.all_reduce(torch.sum(x), data) / (x.numel() * mesh.size_of(data))


def _bce(logit, labels, mesh=None):
    """Mean stable BCE with logits (JAX's recsys losses), over the global
    batch."""
    y = labels.float()
    bce = _global_mean(
        torch.clamp_min(logit, 0) - logit * y + torch.log1p(torch.exp(-torch.abs(logit))), mesh)
    return bce, {"bce": bce}


# ===================================================== Two-tower retrieval
@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """Sampled-softmax retrieval (YouTube two-tower, RecSys'19)."""

    embed_dim: int = 256
    tower_mlp: tuple[int, ...] = (1024, 512, 256)
    user_vocab: int = 5_000_000
    item_vocab: int = 2_000_000
    user_fields: int = 8  # multi-hot user feature slots (bag)
    item_fields: int = 4
    temperature: float = 0.05


class TwoTower(_Recsys):
    """State dict: ``user_table`` [Vu, D], ``item_table`` [Vi, D],
    ``{user,item}_mlp.{i}.{weight,bias}``."""

    def __init__(self, cfg: TwoTowerConfig, *, executor: str = "auto"):
        super().__init__(cfg, executor=executor)
        d = cfg.embed_dim
        self.user_table = _table(cfg.user_vocab, d)
        self.item_table = _table(cfg.item_vocab, d)
        self.user_mlp = _mlp_layers((d,) + cfg.tower_mlp)
        self.item_mlp = _mlp_layers((d,) + cfg.tower_mlp)
        self._resolve_executor()

    def _tower(self, table, mlp, ids, mask):
        """EmbeddingBag(mean) over feature slots + MLP + L2 norm; ``table``
        is the table's name."""
        mask = mask.to(getattr(self, table).dtype)
        denom = torch.clamp_min(mask.sum(-1, keepdim=True), 1.0)
        if self.executor == "kernel":
            pooled = self._bag(table, ids, mask) / denom
        else:
            bags = self.take(table, ids)  # [B, F, D]
            pooled = torch.sum(bags * mask.unsqueeze(-1), dim=1) / denom
        out = _mlp(mlp, pooled)
        return out * torch.rsqrt(torch.sum(out * out, -1, keepdim=True) + 1e-12)

    @torch.inference_mode()
    def user_embed(self, user_ids, user_mask):
        return self._tower("user_table", self.user_mlp, user_ids, user_mask)

    @torch.inference_mode()
    def item_embed(self, item_ids, item_mask):
        return self._tower("item_table", self.item_mlp, item_ids, item_mask)

    def loss(self, batch: dict):
        """In-batch sampled softmax with logQ correction."""
        u = self._tower("user_table", self.user_mlp, batch["user_ids"], batch["user_mask"])
        v = self._tower("item_table", self.item_mlp, batch["item_ids"], batch["item_mask"])
        log_q, labels = batch["log_q"], torch.arange(u.shape[0], device=u.device)
        data = _data(self.mesh)
        if data is not None:  # this rank's rows against every item of the global batch
            v = self.mesh.all_gather(v, data, 0, backward="sum")
            log_q = self.mesh.all_gather(log_q, data, 0)
            labels = labels + self.mesh.index_of(data) * u.shape[0]
        logits = (u @ v.T) / self.cfg.temperature  # [B, B]
        logits = logits - log_q[None, :]  # sampling correction
        logp = torch.log_softmax(logits, dim=-1)
        loss = -_global_mean(torch.take_along_dim(logp, labels[:, None], dim=-1), self.mesh)
        return loss, {"softmax": loss}

    @torch.inference_mode()
    def retrieval_scores(self, user_ids, user_mask, cand_emb):
        """One (or few) users vs precomputed candidate embeddings [N, D]."""
        return self.user_embed(user_ids, user_mask) @ cand_emb.T  # [B, N]


# ================================================================= SASRec
@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    item_vocab: int = 500_000
    dropout: float = 0.0  # inference-style determinism


class _SASRecBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (L.Dense(d, d) for _ in range(4))
        self.ff1 = L.Dense(d, d, bias=True)
        self.ff2 = L.Dense(d, d, bias=True)
        self.ln1 = nn.Parameter(torch.empty(d))
        self.ln2 = nn.Parameter(torch.empty(d))


class SASRec(_Recsys):
    """State dict: ``item_table`` [V, D], ``pos_table`` [S, D],
    ``blocks.{i}.{wq,wk,wv,wo}.weight``, ``blocks.{i}.{ff1,ff2}.{weight,
    bias}``, ``blocks.{i}.{ln1,ln2}``."""

    def __init__(self, cfg: SASRecConfig, *, executor: str = "auto"):
        super().__init__(cfg, executor=executor)
        d = cfg.embed_dim
        self.item_table = _table(cfg.item_vocab, d)
        self.pos_table = _table(cfg.seq_len, d)
        self.blocks = nn.ModuleList(_SASRecBlock(d) for _ in range(cfg.n_blocks))
        self._resolve_executor()

    @staticmethod
    def _ln(scale, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-6) * scale

    @torch.inference_mode()
    def hidden(self, seq_ids, seq_mask):
        """seq_ids int[B, S] -> causal self-attn hidden states [B, S, D]."""
        return self._hidden(seq_ids, seq_mask)

    def _hidden(self, seq_ids, seq_mask):
        b, s = seq_ids.shape
        d, h = self.cfg.embed_dim, self.cfg.n_heads
        seq_mask = seq_mask.float()
        x = self.take("item_table", seq_ids)
        x = x + self.pos_table[None, :s, :]
        x = x * seq_mask.unsqueeze(-1)
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))
        attn_mask = causal[None, None] & (seq_mask > 0)[:, None, None, :]
        for blk in self.blocks:
            q = blk.wq(self._ln(blk.ln1, x)).reshape(b, s, h, d // h)
            k = blk.wk(x).reshape(b, s, h, d // h)
            v = blk.wv(x).reshape(b, s, h, d // h)
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d // h)
            logits = torch.where(attn_mask, logits, -1e30)
            p = torch.softmax(logits, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, d)
            x = x + blk.wo(o)
            hdd = self._ln(blk.ln2, x)
            x = x + blk.ff2(F.relu(blk.ff1(hdd)))
            x = x * seq_mask.unsqueeze(-1)
        return x

    def loss(self, batch: dict):
        """Next-item BCE with sampled negatives (the paper's training loss)."""
        hid = self._hidden(batch["seq_ids"], batch["seq_mask"])
        pos_emb = self.take("item_table", batch["pos_ids"])
        neg_emb = self.take("item_table", batch["neg_ids"])
        pos_logit = torch.sum(hid * pos_emb, -1)
        neg_logit = torch.sum(hid * neg_emb, -1)
        mask = batch["seq_mask"]
        bce = -F.logsigmoid(pos_logit) - F.logsigmoid(-neg_logit)
        num, count = torch.sum(bce * mask), torch.sum(mask)
        data = _data(self.mesh)
        if data is not None:
            num, count = self.mesh.all_reduce(num, data), self.mesh.all_reduce(count, data)
        loss = num / torch.clamp_min(count, 1)
        return loss, {"bce": loss}

    @torch.inference_mode()
    def score_candidates(self, seq_ids, seq_mask, cand_ids):
        """User state (last position) vs candidate items [N] -> [B, N]."""
        last = self.hidden(seq_ids, seq_mask)[:, -1, :]
        return last @ self.take("item_table", cand_ids).T


# ================================================================ xDeepFM
@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    n_fields: int = 39
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp: tuple[int, ...] = (400, 400)
    vocab: int = 10_000_000  # single hashed table, field offsets in ids


class XDeepFM(_Recsys):
    """State dict: ``table`` [V, D], ``linear`` [V, 1], ``cin.{i}``
    [H_i, H_{i-1} * F] (JAX's layout), ``mlp.{i}.{weight,bias}``,
    ``cin_out.{weight,bias}``."""

    def __init__(self, cfg: XDeepFMConfig, *, executor: str = "auto"):
        super().__init__(cfg, executor=executor)
        f, d = cfg.n_fields, cfg.embed_dim
        self.table = _table(cfg.vocab, d)
        self.linear = _table(cfg.vocab, 1)
        prev = (f,) + cfg.cin_layers[:-1]
        self.cin = nn.ParameterList(
            nn.Parameter(torch.empty(h, hp * f)) for h, hp in zip(cfg.cin_layers, prev)
        )
        self.mlp = _mlp_layers((f * d,) + cfg.mlp + (1,))
        self.cin_out = L.Dense(sum(cfg.cin_layers), 1, bias=True)
        self._resolve_executor()

    @torch.inference_mode()
    def logits(self, field_ids):
        """field_ids int[B, F] (field offsets pre-added) -> logit [B]."""
        return self._logits(field_ids)

    def loss(self, batch: dict):
        return _bce(self._logits(batch["field_ids"]), batch["labels"], self.mesh)

    def _logits(self, field_ids):
        x0 = self.take("table", field_ids)  # [B, F, D]
        b, f, d = x0.shape

        # CIN: x^k[h] = W_k[h] . vec(x^{k-1} (outer) x^0), per embedding dim.
        xs = []
        xk = x0
        for w in self.cin:
            z = torch.einsum("bhd,bmd->bhmd", xk, x0)  # [B, Hk-1, F, D]
            z = z.reshape(b, -1, d)  # [B, Hk-1*F, D]
            xk = torch.einsum("hp,bpd->bhd", w, z)  # [B, Hk, D]
            xs.append(torch.sum(xk, dim=-1))  # sum-pool over D
        cin_feat = torch.cat(xs, dim=-1)  # [B, sum(H)]
        cin_logit = self.cin_out(cin_feat)[:, 0]

        dnn_logit = _mlp(self.mlp, x0.reshape(b, f * d))[:, 0]
        if self.executor == "kernel":
            ones = torch.ones(field_ids.shape, dtype=torch.float32, device=field_ids.device)
            lin_logit = self._bag("linear", field_ids, ones)[:, 0]
        else:
            lin_logit = torch.sum(self.take("linear", field_ids), dim=(1, 2))
        return cin_logit + dnn_logit + lin_logit


# ==================================================================== DIN
@dataclasses.dataclass(frozen=True)
class DINConfig:
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple[int, ...] = (80, 40)
    mlp: tuple[int, ...] = (200, 80)
    item_vocab: int = 1_000_000


class DIN(_Recsys):
    """State dict: ``table`` [V, D], ``attn.{i}.{weight,bias}``,
    ``mlp.{i}.{weight,bias}``."""

    def __init__(self, cfg: DINConfig, *, executor: str = "auto"):
        super().__init__(cfg, executor=executor)
        d = cfg.embed_dim
        self.table = _table(cfg.item_vocab, d)
        self.attn = _mlp_layers((4 * d,) + cfg.attn_mlp + (1,))
        self.mlp = _mlp_layers((3 * d,) + cfg.mlp + (1,))
        self._resolve_executor()

    @torch.inference_mode()
    def logits(self, target_ids, hist_ids, hist_mask):
        """target int[B], hist int[B, S], mask [B, S] -> logit [B]."""
        return self._logits(target_ids, hist_ids, hist_mask)

    def loss(self, batch: dict):
        return _bce(
            self._logits(batch["target_ids"], batch["hist_ids"], batch["hist_mask"]),
            batch["labels"], self.mesh,
        )

    def _logits(self, target_ids, hist_ids, hist_mask):
        t = self.take("table", target_ids)  # [B, D]
        h = self.take("table", hist_ids)  # [B, S, D]
        tb = t.unsqueeze(1).expand_as(h)
        feat = torch.cat([h, tb, h - tb, h * tb], dim=-1)  # [B, S, 4D]
        w = _mlp(self.attn, feat)[..., 0]  # [B, S] activation weights
        w = w * hist_mask  # DIN: no softmax, masked sigmoid-free weights
        if self.executor == "kernel":
            interest = self._bag("table", hist_ids, w)
        else:
            interest = torch.sum(h * w.unsqueeze(-1), dim=1)  # [B, D]
        z = torch.cat([interest, t, interest * t], dim=-1)
        return _mlp(self.mlp, z)[:, 0]


RECSYS_MODELS = {
    TwoTowerConfig: TwoTower,
    SASRecConfig: SASRec,
    XDeepFMConfig: XDeepFM,
    DINConfig: DIN,
}


def serve_step(model: _Recsys, shape):
    """The serve and retrieval steps of ``RecsysFamily.step_fn``: a function
    of the batch dict (JAX's input names) for a ``RecsysShape`` of kind
    "serve" or "retrieval", run under ``torch.inference_mode``. Two-tower
    serves u . v per user and retrieves one user against ``cand_emb``;
    SASRec scores the last position against ``target_ids`` or ``cand_ids``;
    xDeepFM gives logits; DIN gives logits, broadcasting one history over
    every target at retrieval."""
    if shape.kind == "train":
        raise ValueError(
            "serve_step serves; a train shape trains through RecsysFamily.step_fn "
            "(configs/families.py), on a state of trainable parameters"
        )
    if shape.kind not in ("serve", "retrieval"):
        raise ValueError(f"shape kind {shape.kind!r} not in ('serve', 'retrieval', 'train')")
    retrieval = shape.kind == "retrieval"

    if isinstance(model, TwoTower):
        def step(batch):
            if retrieval:
                return model.retrieval_scores(
                    batch["user_ids"], batch["user_mask"], batch["cand_emb"]
                )
            u = model.user_embed(batch["user_ids"], batch["user_mask"])
            v = model.item_embed(batch["item_ids"], batch["item_mask"])
            return torch.sum(u * v, dim=-1)
    elif isinstance(model, SASRec):
        def step(batch):
            if retrieval:
                return model.score_candidates(
                    batch["seq_ids"], batch["seq_mask"], batch["cand_ids"]
                )
            hid = model.hidden(batch["seq_ids"], batch["seq_mask"])
            tgt = model.take("item_table", batch["target_ids"])
            return torch.sum(hid[:, -1, :] * tgt, dim=-1)
    elif isinstance(model, XDeepFM):
        def step(batch):
            return model.logits(batch["field_ids"])
    elif isinstance(model, DIN):
        def step(batch):
            hist, mask, tgt = batch["hist_ids"], batch["hist_mask"], batch["target_ids"]
            if retrieval:
                hist = hist.expand(tgt.shape[0], hist.shape[1])
                mask = mask.expand(tgt.shape[0], mask.shape[1])
            return model.logits(tgt, hist, mask)
    else:
        raise TypeError(f"not a recsys model: {type(model).__name__}")
    return torch.inference_mode()(step)
