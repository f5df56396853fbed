"""Decoder-only transformer LM of the port (dense FFN), with prefill and
decode over a KV cache. Counterpart of ``repro/models/transformer.py``.

``TransformerConfig`` keeps every field and default of the JAX config, so
the two compare field by field. The fields that shard or rematerialize
(``remat``, ``attn_batch_axes``, ``fused_ce``, ``cast_params_once``,
``remat_attn_chunks``, ``embed_out_axes``, ``embed_shard``,
``tp_constraints``, ``moe_weight_mode``) shape a multi-chip TPU program and
do not act on one card; ``aux_loss_coef`` waits for training.

``TransformerLM`` is an ``nn.Module`` whose layers run as a Python loop.
Its ``executor`` picks where attention over a prompt's own keys runs:
"kernel" the hand-written CUDA flash kernel (``kernels/ops.py::
flash_attention``), "reference" its plain version, "auto" the kernel on
CUDA and the plain version on the CPU. That function is the JAX prefill's
attention over an empty cache and the JAX forward's causal self-attention.
Prefill onto a non-empty cache (chunked prefill at an offset) attends to
the cache through ``layers.chunked_attention``, and decode through
``layers.decode_attention``, as in JAX: no kernel in either package
computes those.

The KV cache is updated in place (JAX returns a new one): ``prefill`` and
``decode_step`` return a ``KVCache`` that shares the updated tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L

__all__ = ["TransformerConfig", "TransformerLM", "KVCache"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None
    rope_theta: float = 10000.0
    moe: Any = None  # MoE is not ported: a config with one is refused
    tie_embeddings: bool = False
    remat: bool = False
    attn_chunk: int = 1024
    compute_dtype: str = "bfloat16"
    aux_loss_coef: float = 0.01
    attn_batch_axes: tuple[str, ...] | None = None
    fused_ce: bool = False
    cast_params_once: bool = False
    remat_attn_chunks: bool = False
    embed_out_axes: tuple[str, ...] | None = None
    embed_shard: str = "d"
    tp_constraints: bool = False
    moe_weight_mode: str = "fsdp"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        dh = self.resolved_head_dim
        attn = self.d_model * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        per_layer = attn + 3 * self.d_model * self.d_ff + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, S, Hkv, Dh] in the cache dtype
    v: torch.Tensor  # [L, B, S, Hkv, Dh]
    length: torch.Tensor  # int32[B] tokens currently cached

    @staticmethod
    def empty(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
        """A zero cache; ``device=None`` is the card."""
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros(batch, dtype=torch.int32, device=device),
        )


class _Layer(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        dh = cfg.resolved_head_dim
        self.attn_norm = L.RMSNorm(cfg.d_model)
        self.ffn_norm = L.RMSNorm(cfg.d_model)
        self.wq = L.Dense(cfg.d_model, cfg.n_heads * dh, bias=cfg.qkv_bias)
        self.wk = L.Dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias)
        self.wv = L.Dense(cfg.d_model, cfg.n_kv_heads * dh, bias=cfg.qkv_bias)
        self.wo = L.Dense(cfg.n_heads * dh, cfg.d_model)
        if cfg.qk_norm:
            self.q_norm = L.RMSNorm(dh)
            self.k_norm = L.RMSNorm(dh)
        self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff)


def _cache_slots(start: torch.Tensor, s: int, s_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows [B, 1], slots [B, s]) that ``cache[rows, slots] = new`` writes:
    slots start[b] .. start[b] + s - 1, the start clamped so they fit, as
    ``lax.dynamic_update_slice`` clamps."""
    start = start.long().clamp(max=s_max - s)
    rows = torch.arange(start.shape[0], device=start.device).unsqueeze(-1)
    return rows, start.unsqueeze(-1) + torch.arange(s, device=start.device)


class TransformerLM(nn.Module):
    """Build one with ``TransformerLM.from_params`` (the constructor leaves
    the weights uninitialized). State-dict names: ``embed`` [V, D],
    ``layers.{i}.{attn_norm,ffn_norm,q_norm,k_norm}.scale``,
    ``layers.{i}.{wq,wk,wv,wo}.{weight,bias}``,
    ``layers.{i}.ffn.{gate,up,down}.weight``, ``final_norm.scale`` and,
    untied, ``lm_head.weight`` [V, D]. Weights are [d_out, d_in]."""

    def __init__(self, cfg: TransformerConfig, *, executor: str = "auto"):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError(
                "MoE not yet ported: repro_torch.models.TransformerLM runs the "
                "dense FFN only (models/moe.py waits for a later slice of the port)"
            )
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = L.Dense(cfg.d_model, cfg.vocab)
        self.executor = executor
        self._resolve_executor()

    @classmethod
    def from_params(cls, cfg: TransformerConfig, params: dict, *, executor: str = "auto"):
        """A model that takes ``params`` (a state dict, see the class, from
        ``convert.init_params`` or ``convert.params_from_jax``) as its
        parameters without copying them: two models of one set of weights
        (say, one per executor) share the tensors. The weights are frozen:
        training is not ported."""
        with torch.device("meta"):
            model = cls(cfg, executor="reference")
        model.load_state_dict(params, strict=True, assign=True)
        model.requires_grad_(False)
        model.executor = executor
        model._resolve_executor()
        return model

    def _resolve_executor(self) -> None:
        self.executor = L.resolve_executor(self.executor, self.embed.device, "the CUDA flash kernel")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------- layer body
    def _attention(self, lp: _Layer, x, positions, rope, cache=None, layer=0, slots=None, empty=False):
        """x [B, S, D]. Without a cache: causal self-attention over x. With
        one: write k/v at ``slots`` and attend to the cache (a prompt over
        an empty cache attends to its own k/v, rounded to the cache dtype)."""
        cfg = self.cfg
        b, s, _ = x.shape
        dh = cfg.resolved_head_dim
        q = lp.wq(x).reshape(b, s, cfg.n_heads, dh)
        k = lp.wk(x).reshape(b, s, cfg.n_kv_heads, dh)
        v = lp.wv(x).reshape(b, s, cfg.n_kv_heads, dh)
        if cfg.qk_norm:
            q, k = lp.q_norm(q), lp.k_norm(k)
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
        if cache is not None:
            kv_len = cache.length
            k_cache, v_cache = cache.k[layer], cache.v[layer]
            k_cache[slots] = k.to(k_cache.dtype)
            v_cache[slots] = v.to(v_cache.dtype)
        if cache is None or empty:
            if cache is not None:  # what the cache holds
                k = k.to(k_cache.dtype).to(q.dtype)
                v = v.to(v_cache.dtype).to(q.dtype)
            out = ops.flash_attention(
                q, k, v, causal=True, window=cfg.sliding_window,
                use_kernel=self.executor == "kernel",
            )
        elif s == 1:
            out = L.decode_attention(q, k_cache, v_cache, kv_len + 1, window=cfg.sliding_window)
        else:
            # Chunked prefill against the cache: causal over absolute
            # positions; slots beyond kv_len + s are hidden.
            s_max = k_cache.shape[1]
            kv_pos = torch.arange(s_max, device=x.device).expand(b, s_max)
            kv_pos = torch.where(kv_pos < (kv_len + s).unsqueeze(-1), kv_pos, -(10**9))
            out = L.chunked_attention(
                q, k_cache, v_cache, causal=True, window=cfg.sliding_window,
                q_positions=positions, kv_positions=kv_pos,
                chunk_size=min(cfg.attn_chunk, s_max),
            )
        return lp.wo(out.reshape(b, s, cfg.n_heads * dh))

    def _run(self, tokens, positions, cache=None, empty=False):
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.dtype)
        freqs = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta, device=x.device)
        rope = L.rope_tables(positions, freqs)  # shared by every layer's q and k
        slots = None
        if cache is not None:
            slots = _cache_slots(cache.length, tokens.shape[1], cache.k.shape[2])
        for i, lp in enumerate(self.layers):
            x = x + self._attention(lp, lp.attn_norm(x), positions, rope, cache, i, slots, empty)
            x = x + lp.ffn(lp.ffn_norm(x))
        return self.final_norm(x)

    # ---------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens int[B, S] -> (hidden [B, S, D] in the compute dtype, the
        MoE aux loss: 0 for the dense FFN)."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        hidden = self._run(tokens, positions)
        return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return L.dense(hidden, self.embed)
        return self.lm_head(hidden)

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """Write a prompt into the cache; returns (last-position logits
        [B, V], the cache with its length advanced)."""
        b, s = tokens.shape
        positions = cache.length.unsqueeze(-1) + torch.arange(s, device=tokens.device)
        empty = not bool(cache.length.any())
        hidden = self._run(tokens, positions, cache, empty)
        logits = self.logits(hidden[:, -1:, :])[:, 0, :]
        return logits, KVCache(cache.k, cache.v, cache.length + s)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """tokens int[B], one new token per row -> (logits [B, V], the
        cache with its length advanced by one)."""
        positions = cache.length.unsqueeze(-1)
        hidden = self._run(tokens.unsqueeze(-1), positions, cache)
        logits = self.logits(hidden)[:, 0, :]
        return logits, KVCache(cache.k, cache.v, cache.length + 1)
