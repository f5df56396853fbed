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
range. Training (the ``loss`` functions) is not ported yet.
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

    @classmethod
    def from_params(cls, cfg, params: dict, *, executor: str = "auto"):
        """A model that takes ``params`` (a state dict in the module's names)
        as its parameters without copying them: two models of one set of
        weights (one per executor) share the tensors. The weights are
        frozen: training is not ported."""
        with torch.device("meta"):
            model = cls(cfg, executor="reference")
        model.load_state_dict(params, strict=True, assign=True)
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

    def _bag(self, table, ids, weights) -> torch.Tensor:
        """sum_l weights[b, l] * table[ids[b, l]] through the kernel."""
        return ops.embedding_bag(table, bag_indices=ids, bag_weights=weights, use_kernel=True)


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
        """EmbeddingBag(mean) over feature slots + MLP + L2 norm."""
        mask = mask.to(table.dtype)
        denom = torch.clamp_min(mask.sum(-1, keepdim=True), 1.0)
        if self.executor == "kernel":
            pooled = self._bag(table, ids, mask) / denom
        else:
            bags = ref.take(table, ids)  # [B, F, D]
            pooled = torch.sum(bags * mask.unsqueeze(-1), dim=1) / denom
        out = _mlp(mlp, pooled)
        return out * torch.rsqrt(torch.sum(out * out, -1, keepdim=True) + 1e-12)

    @torch.inference_mode()
    def user_embed(self, user_ids, user_mask):
        return self._tower(self.user_table, self.user_mlp, user_ids, user_mask)

    @torch.inference_mode()
    def item_embed(self, item_ids, item_mask):
        return self._tower(self.item_table, self.item_mlp, item_ids, item_mask)

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
        b, s = seq_ids.shape
        d, h = self.cfg.embed_dim, self.cfg.n_heads
        seq_mask = seq_mask.float()
        x = ref.take(self.item_table, seq_ids)
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

    @torch.inference_mode()
    def score_candidates(self, seq_ids, seq_mask, cand_ids):
        """User state (last position) vs candidate items [N] -> [B, N]."""
        last = self.hidden(seq_ids, seq_mask)[:, -1, :]
        return last @ ref.take(self.item_table, cand_ids).T


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
        x0 = ref.take(self.table, field_ids)  # [B, F, D]
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
            lin_logit = self._bag(self.linear, field_ids, ones)[:, 0]
        else:
            lin_logit = torch.sum(ref.take(self.linear, field_ids), dim=(1, 2))
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
        t = ref.take(self.table, target_ids)  # [B, D]
        h = ref.take(self.table, hist_ids)  # [B, S, D]
        tb = t.unsqueeze(1).expand_as(h)
        feat = torch.cat([h, tb, h - tb, h * tb], dim=-1)  # [B, S, 4D]
        w = _mlp(self.attn, feat)[..., 0]  # [B, S] activation weights
        w = w * hist_mask  # DIN: no softmax, masked sigmoid-free weights
        if self.executor == "kernel":
            interest = self._bag(self.table, hist_ids, w)
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
        raise NotImplementedError(
            "recsys training is not yet ported: the recsys loss functions wait for a "
            "later slice of the port"
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
            tgt = ref.take(model.item_table, batch["target_ids"])
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
