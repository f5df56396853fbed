"""Decoder-only transformer LM of the port (dense and MoE FFN), with the
causal LM loss for training and prefill and decode over a KV cache.
Counterpart of ``repro/models/transformer.py``.

``TransformerConfig`` keeps every field and default of the JAX config, so
the two compare field by field. ``remat`` checkpoints each layer under
autograd (``torch.utils.checkpoint``, as ``jax.checkpoint`` wraps JAX's
layer body); the other fields that shard or rematerialize
(``attn_batch_axes``, ``cast_params_once``, ``remat_attn_chunks``,
``embed_out_axes``, ``embed_shard``, ``tp_constraints``,
``moe_weight_mode``) shape a multi-chip TPU program and do not act on one
card. ``fused_ce`` takes the loss's label term as ``logsumexp`` minus the
label's logit, which is the value of JAX's one-hot contraction.

``TransformerLM`` is an ``nn.Module`` whose layers run as a Python loop.
Its ``executor`` picks where attention over a prompt's own keys runs when
nothing is differentiated: "kernel" the hand-written CUDA flash kernel
(``kernels/ops.py::flash_attention``, forward only), "reference" its plain
version, "auto" the kernel on CUDA and the plain version on the CPU. That
function is the JAX prefill's attention over an empty cache and the JAX
forward's causal self-attention. ``loss``, and ``forward`` with grad
enabled, take JAX's own training route instead, ``layers.gqa_attention``
(plain chunked attention, differentiable), at either executor. Prefill
onto a non-empty cache (chunked prefill at an offset) attends to the
cache through ``layers.chunked_attention``, and decode through
``layers.decode_attention``, as in JAX: no kernel in either package
computes those.

The KV cache is updated in place (JAX returns a new one): ``prefill`` and
``decode_step`` return a ``KVCache`` that shares the updated tensors.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.types import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.moe import MoE, MoEConfig

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
    moe: MoEConfig | None = None
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

    def _count(self, experts: int) -> int:
        dh = self.resolved_head_dim
        attn = self.d_model * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = experts * 3 * self.d_model * self.d_ff
        if self.moe is not None:
            ffn += self.d_model * self.moe.n_experts
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + embed + self.d_model

    def param_count(self) -> int:
        return self._count(1 if self.moe is None else self.moe.n_experts)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        return self._count(1 if self.moe is None else self.moe.top_k)


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
        if cfg.moe is None:
            self.ffn = L.SwiGLU(cfg.d_model, cfg.d_ff)
        else:
            self.moe = MoE(cfg.moe, cfg.d_model, cfg.d_ff)


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
    ``layers.{i}.ffn.{gate,up,down}.weight`` (MoE layers:
    ``layers.{i}.moe.router.weight`` [E, D] and ``layers.{i}.moe.{gate,up}``
    [E, D, F], ``layers.{i}.moe.down`` [E, F, D]), ``final_norm.scale`` and,
    untied, ``lm_head.weight`` [V, D]. Dense weights are [d_out, d_in]."""

    def __init__(self, cfg: TransformerConfig, *, executor: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model)
        if not cfg.tie_embeddings:
            self.lm_head = L.Dense(cfg.d_model, cfg.vocab)
        self.executor = executor
        self._resolve_executor()

    @classmethod
    def from_params(cls, cfg: TransformerConfig, params: dict, *, executor: str = "auto",
                    trainable: bool = False):
        """A model that takes ``params`` (a state dict, see the class, from
        ``convert.init_params`` or ``convert.params_from_jax``) as its
        parameters without copying them: two models of one set of weights
        (say, one per executor) share the tensors. Serving weights are
        frozen. ``trainable=True`` leaves them trainable; where ``params``
        holds ``nn.Parameter``s (``train.TrainState``'s), the model's
        parameters are those very objects, so gradients land on them."""
        with torch.device("meta"):
            model = cls(cfg, executor="reference")
        model.load_state_dict(params, strict=True, assign=True)
        if not trainable:
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
    def _attention(self, lp: _Layer, x, positions, rope, cache=None, layer=0, slots=None,
                   empty=False, train=False):
        """x [B, S, D]. Without a cache: causal self-attention over x (JAX's
        differentiable ``gqa_attention`` when ``train``). With one: write
        k/v at ``slots`` and attend to the cache (a prompt over an empty
        cache attends to its own k/v, rounded to the cache dtype)."""
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
        if cache is None and train:
            out = L.gqa_attention(
                q, k, v, causal=True, window=cfg.sliding_window, chunk_size=cfg.attn_chunk
            )
        elif cache is None or empty:
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

    def _layer(self, i, x, positions, rope, cache, slots, empty, train):
        """Layer ``i`` -> (x, its MoE aux loss: 0 for the dense FFN)."""
        lp = self.layers[i]
        x = x + self._attention(lp, lp.attn_norm(x), positions, rope, cache, i, slots, empty, train)
        h = lp.ffn_norm(x)
        if self.cfg.moe is None:
            return x + lp.ffn(h), torch.zeros((), dtype=torch.float32, device=x.device)
        b, s, d = h.shape
        y, aux = lp.moe(h.reshape(b * s, d))
        return x + y.reshape(b, s, d), aux

    def _run(self, tokens, positions, cache=None, empty=False, train=False):
        """-> (final-normed hidden, the MoE aux loss summed over layers)."""
        cfg = self.cfg
        x = self.embed[tokens].to(cfg.dtype)
        freqs = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta, device=x.device)
        rope = L.rope_tables(positions, freqs)  # shared by every layer's q and k
        slots = None
        if cache is not None:
            slots = _cache_slots(cache.length, tokens.shape[1], cache.k.shape[2])
        remat = cfg.remat and train and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            args = (i, x, positions, rope, cache, slots, empty, train)
            if remat:
                x, a = checkpoint(self._layer, *args, use_reentrant=False)
            else:
                x, a = self._layer(*args)
            aux = aux + a
        return self.final_norm(x), aux

    # ---------------------------------------------------------- forward
    def forward(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """tokens int[B, S] -> (hidden [B, S, D] in the compute dtype, the
        MoE aux loss summed over layers: 0 for the dense FFN). With grad
        enabled, attention takes the training route (see the module)."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        return self._run(tokens, positions, train=torch.is_grad_enabled())

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return L.dense(hidden, self.embed)
        return self.lm_head(hidden)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor):
        """Causal LM loss over float32 logits, labels < 0 masked out, plus
        ``aux_loss_coef`` x the MoE aux loss -> (loss, {"ce", "aux"}).
        Labels are not shifted (JAX's are not). Attention takes the
        training route whether or not grad is enabled, so the loss under
        ``torch.no_grad`` is the one a train step differentiates."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        hidden, aux = self._run(tokens, positions, train=True)
        logits = self.logits(hidden).float()
        mask = labels >= 0
        safe = labels.clamp(min=0).long().unsqueeze(-1)
        if self.cfg.fused_ce:
            nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, safe)[..., 0]
        else:
            nll = -torch.gather(F.log_softmax(logits, -1), -1, safe)[..., 0]
        ce = torch.sum(nll * mask) / mask.sum().clamp(min=1)
        return ce + self.cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """Write a prompt into the cache; returns (last-position logits
        [B, V], the cache with its length advanced)."""
        b, s = tokens.shape
        positions = cache.length.unsqueeze(-1) + torch.arange(s, device=tokens.device)
        empty = not bool(cache.length.any())
        hidden, _ = self._run(tokens, positions, cache, empty)
        logits = self.logits(hidden[:, -1:, :])[:, 0, :]
        return logits, KVCache(cache.k, cache.v, cache.length + s)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """tokens int[B], one new token per row -> (logits [B, V], the
        cache with its length advanced by one)."""
        positions = cache.length.unsqueeze(-1)
        hidden, _ = self._run(tokens.unsqueeze(-1), positions, cache)
        logits = self.logits(hidden)[:, 0, :]
        return logits, KVCache(cache.k, cache.v, cache.length + 1)
