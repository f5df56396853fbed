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

Over a mesh of ranks (``from_params(..., mesh=)``, weights from
``convert.init_params(..., mesh=)``: each rank holds its blocks by
``launch/sharding.py::lm_param_pspec``), the forward follows the rules:
wq, wk and wv are column-split over the model axis by heads, so each rank
attends over its own heads (the flash kernel, on a prompt, at the rank's
head counts) and wo is row-split, its partial products all-reduced; the
FFN's gate and up likewise, down row-split; the MoE experts split along
d_ff (``moe.moe_apply``); weights split over the data axes (FSDP) are
all-gathered just before their layer runs, a layer's in one collective. The embedding is D-split (a
local row gather, then an all-gather over the model axis), V-split
("vocab": the rank's rows, the others 0, all-reduced) or replicated;
``lm_head`` is V-split, its logits all-gathered (tied with the D-split
embedding: the table's columns gathered where there are more positions
than columns, else the D-split product all-reduced). Norms are replicated. Tokens and the KV cache are
the rank's block of the batch (``kv_cache_pspec``), and the cache keeps
only the kv heads the rank's attention reads (``sharding.kv_heads_of_rank``:
where Hkv < model, one kv head, replicated over the ranks that share it).
A cache split by sequence over the data axes (``KVCache.seq_split``, JAX's
``shard_seq`` for batch-1 decode) decodes one token at a time, each rank
over its positions, the partial softmaxes merged by their log-sum-exp; it
comes from the caller (``shard_cache``), as JAX's ``long_500k`` cache is
an input: the port does not prefill into one.

Such a model also trains (``from_params(..., trainable=True, mesh=)`` on
``TrainState``'s blocks): every collective carries the backward its
consumers need (``launch/mesh.py``). A tensor replicated over the model
axis goes through ``copy_to`` before each block split over it (wq/wk/wv,
gate/up, the experts, a V-split or tied head, and the q/k norms' scales,
which the rank's heads alone read), the row-parallel sums pass
their gradient on as it is, the FSDP gathers reduce-scatter theirs, and
the D-split embedding's and V-split logits' gathers keep the rank's own
block. ``loss`` is JAX's over the global batch: the numerator and the
count of unmasked labels are each summed over the data axes, so every rank
holds the global loss and its backward its own rows' share; a gathered
MoE dispatch's aux loss, computed alike on every data rank, counts once
(each rank's gradient of it is divided by the data axes' size).
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
from repro_torch.models.moe import MoE, MoEConfig, moe_apply

__all__ = ["TransformerConfig", "TransformerLM", "KVCache", "shard_cache"]


class _ScaleGrad(torch.autograd.Function):
    """x itself; its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


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
    seq_split: bool = False  # over a mesh: S is this rank's block of the positions

    @staticmethod
    def empty(cfg: TransformerConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None,
              mesh=None):
        """A zero cache; ``device=None`` is the card. With ``mesh``: this
        rank's block of a cache of ``batch`` rows (split over the data
        axes), with its own kv heads."""
        device = resolve_device(device)
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        if mesh is not None:
            from repro_torch.launch import sharding

            spec = sharding.kv_cache_pspec({"k": (shape, dtype)}, mesh, shard_seq=False)["k"]
            heads = sharding.kv_heads_of_rank(cfg, mesh)[1]
            shape = sharding.local_shape(shape, spec, mesh)[:3] + (heads, shape[4])
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros(shape[1], dtype=torch.int32, device=device),
        )


def shard_cache(cache: KVCache, cfg: TransformerConfig, mesh, *, shard_seq: bool = False,
                device=None) -> KVCache:
    """This rank's block of a full cache (``kv_cache_pspec``: batch over the
    data axes, or with ``shard_seq`` the sequence), with the kv heads its
    attention reads, copied to ``device`` (None: the cache's)."""
    from repro_torch.launch import sharding

    full = {"k": cache.k, "v": cache.v, "length": cache.length}
    specs = sharding.kv_cache_pspec(full, mesh, shard_seq=shard_seq)
    first, count = sharding.kv_heads_of_rank(cfg, mesh)
    dev = cache.k.device if device is None else device
    out = {}
    for name, t in full.items():
        t = sharding.local_block(t, specs[name], mesh)
        if t.dim() == 5:
            t = t.narrow(3, first, count)
        out[name] = t.to(dev, copy=True)
    return KVCache(out["k"], out["v"], out["length"], seq_split=shard_seq)


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
        self.mesh = None
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads  # this rank's
        self._fsdp: dict = {}  # id(parameter) -> its spec, for those split over the data axes
        self._gathered: dict = {}  # id(parameter) -> the layer running's joined FSDP weights

    @classmethod
    def from_params(cls, cfg: TransformerConfig, params: dict, *, executor: str = "auto",
                    trainable: bool = False, mesh=None):
        """A model that takes ``params`` (a state dict, see the class, from
        ``convert.init_params`` or ``convert.params_from_jax``) as its
        parameters without copying them: two models of one set of weights
        (say, one per executor) share the tensors. Serving weights are
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

    def _place(self, params: dict, mesh, trainable: bool = False) -> None:
        """Take this rank's blocks as the parameters (``L.assign_blocks``),
        and note those split over the data axes, which the forward joins."""
        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import data_axes
        from repro_torch.models.convert import param_specs

        cfg = self.cfg
        specs = param_specs(cfg, mesh)
        L.assign_blocks(self, params, lambda name, shape: sharding.lm_local_shape(
            name, shape, specs[name], mesh, cfg), trainable)
        data = set(data_axes(mesh))
        for name, p in self.named_parameters():
            if any(a in data for part in specs[name] if part for a in part):
                self._fsdp[id(p)] = specs[name]
        self.mesh = mesh
        self.n_heads = cfg.n_heads // mesh.shape["model"]
        self.n_kv_heads = sharding.kv_heads_of_rank(cfg, mesh)[1]

    def _resolve_executor(self) -> None:
        self.executor = L.resolve_executor(self.executor, self.embed.device, "the CUDA flash kernel")

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _split_in(self, x: torch.Tensor) -> torch.Tensor:
        """x (replicated over the model axis) as a block split over that
        axis reads it: its gradient summed over the axis."""
        from repro_torch.launch.mesh import MODEL_AXIS

        return x if self.mesh is None else self.mesh.copy_to(x, MODEL_AXIS)

    def _full(self, w: torch.Tensor) -> torch.Tensor:
        """A weight as its layer uses it: joined over the data axes where
        it is split over them (FSDP), else itself. The blocks travel in the
        compute dtype, the layer's cast moved ahead of the gather (the same
        values; half the bytes of a float32 training state)."""
        if id(w) in self._gathered:
            return self._gathered[id(w)]
        spec = self._fsdp.get(id(w))
        return w if spec is None else L.gather_fsdp(w.to(self.cfg.dtype), spec, self.mesh)

    def _gather_layer(self, lp: _Layer) -> dict:
        """The layer's FSDP weights joined in one collective
        (``gather_fsdp_many``), by id: what ``_full`` gives the layer."""
        ws = [p for p in lp.parameters() if id(p) in self._fsdp]
        if not ws:
            return {}
        full = L.gather_fsdp_many([w.to(self.cfg.dtype) for w in ws],
                                  [self._fsdp[id(w)] for w in ws], self.mesh)
        return {id(w): f for w, f in zip(ws, full)}

    # ------------------------------------------------------- layer body
    def _attention(self, lp: _Layer, x, positions, rope, cache=None, layer=0, slots=None,
                   empty=False, train=False):
        """x [B, S, D]. Without a cache: causal self-attention over x (JAX's
        differentiable ``gqa_attention`` when ``train``). With one: write
        k/v at ``slots`` and attend to the cache (a prompt over an empty
        cache attends to its own k/v, rounded to the cache dtype)."""
        cfg, h, hkv = self.cfg, self.n_heads, self.n_kv_heads
        b, s, _ = x.shape
        dh = cfg.resolved_head_dim
        x = self._split_in(x)
        q = L.dense(x, self._full(lp.wq.weight), lp.wq.bias).reshape(b, s, h, dh)
        k = L.dense(x, self._full(lp.wk.weight), lp.wk.bias).reshape(b, s, hkv, dh)
        v = L.dense(x, self._full(lp.wv.weight), lp.wv.bias).reshape(b, s, hkv, dh)
        if cfg.qk_norm:  # over a mesh the scales are read by the rank's heads alone
            q = L.rms_norm(q, self._split_in(lp.q_norm.scale))
            k = L.rms_norm(k, self._split_in(lp.k_norm.scale))
        q, k = L.rotate(q, *rope), L.rotate(k, *rope)
        if cache is not None and cache.seq_split:
            out = self._decode_seq_split(q, k, v, cache, layer)
        else:
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
        out = out.reshape(b, s, h * dh)
        if self.mesh is None:
            return lp.wo(out)
        return L.row_dense(out, self._full(lp.wo.weight), self.mesh, lp.wo.bias)

    def _decode_seq_split(self, q, k, v, cache: KVCache, layer: int):
        """One decode step over a cache whose positions are split over the
        data axes: the rank that holds position ``length`` writes k/v
        there, every rank attends over its own positions, and the partial
        softmaxes are merged by their log-sum-exp."""
        from repro_torch.launch.mesh import data_axes

        if q.shape[1] != 1:
            raise ValueError("a sequence-split cache decodes one token at a time; the port "
                             "does not prefill into one (split a prefilled cache: shard_cache)")
        data = data_axes(self.mesh)
        k_cache, v_cache = cache.k[layer], cache.v[layer]
        s_loc = k_cache.shape[1]
        start = self.mesh.index_of(data) * s_loc
        local = cache.length.long() - start
        own = ((local >= 0) & (local < s_loc)).view(-1, 1, 1)
        rows = torch.arange(local.shape[0], device=local.device)
        at = local.clamp(0, s_loc - 1)
        k_cache[rows, at] = torch.where(own, k[:, 0].to(k_cache.dtype), k_cache[rows, at])
        v_cache[rows, at] = torch.where(own, v[:, 0].to(v_cache.dtype), v_cache[rows, at])
        positions = start + torch.arange(s_loc, device=local.device)
        out, lse = L.decode_attention_partial(q, k_cache, v_cache, cache.length + 1, positions,
                                              window=self.cfg.sliding_window)
        return L.merge_attention(out, lse, self.mesh, data, v_cache.dtype)

    def _ffn(self, lp: _Layer, h):
        """The dense FFN; over a mesh gate/up column-split, down row-split."""
        if self.mesh is None:
            return lp.ffn(h)
        f = lp.ffn
        h = self._split_in(h)
        act = F.silu(L.dense(h, self._full(f.gate.weight))) * L.dense(h, self._full(f.up.weight))
        return L.row_dense(act, self._full(f.down.weight), self.mesh)

    def _moe(self, lp: _Layer, h, tokens_split: bool):
        """The MoE FFN of h [T, D] -> (y, aux); ``tokens_split``: h is the
        rank's rows of a batch split over the data axes."""
        if self.mesh is None:
            return lp.moe(h)
        m = lp.moe
        params = {"router": m.router.weight, "gate": self._full(m.gate),
                  "up": self._full(m.up), "down": self._full(m.down)}
        return moe_apply(params, self.cfg.moe, h, mesh=self.mesh, tokens_split=tokens_split)

    def _layer(self, i, x, positions, rope, cache, slots, empty, train):
        """Layer ``i`` -> (x, its MoE aux loss: 0 for the dense FFN). Over
        a mesh its FSDP weights are joined first, in one collective (again
        when remat recomputes the layer)."""
        lp = self.layers[i]
        self._gathered = {} if self.mesh is None else self._gather_layer(lp)
        try:
            x = x + self._attention(lp, lp.attn_norm(x), positions, rope, cache, i, slots, empty,
                                    train)
            h = lp.ffn_norm(x)
            if self.cfg.moe is None:
                return x + self._ffn(lp, h), torch.zeros((), dtype=torch.float32, device=x.device)
            b, s, d = h.shape
            y, aux = self._moe(lp, h.reshape(b * s, d), cache is None or not cache.seq_split)
            return x + y.reshape(b, s, d), aux
        finally:
            self._gathered = {}

    def _embed(self, tokens):
        """The embedding rows of ``tokens`` in the compute dtype."""
        cfg, mesh = self.cfg, self.mesh
        if mesh is None or cfg.embed_shard == "replicated":
            return self.embed[tokens].to(cfg.dtype)
        from repro_torch.launch.mesh import MODEL_AXIS

        if cfg.embed_shard == "d":
            return mesh.all_gather(self.embed[tokens].to(cfg.dtype), MODEL_AXIS, -1,
                                   backward="slice")
        rows = self.embed.shape[0]  # "vocab": this rank's rows, the others 0
        local = tokens.long() - mesh.index_of(MODEL_AXIS) * rows
        own = (local >= 0) & (local < rows)
        x = torch.where(own.unsqueeze(-1), self.embed[local.clamp(0, rows - 1)], 0.0)
        return mesh.all_reduce(x, MODEL_AXIS).to(cfg.dtype)

    def _run(self, tokens, positions, cache=None, empty=False, train=False):
        """-> (final-normed hidden, the MoE aux loss summed over layers)."""
        cfg = self.cfg
        x = self._embed(tokens)
        freqs = L.rope_frequencies(cfg.resolved_head_dim, cfg.rope_theta, device=x.device)
        rope = L.rope_tables(positions, freqs)  # shared by every layer's q and k
        slots = None
        if cache is not None and not cache.seq_split:
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
        enabled, attention takes the training route (see the module). Over
        a mesh, the rank's rows; a local dispatch's aux loss is averaged
        over the data axes."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        hidden, aux = self._run(tokens, positions, train=torch.is_grad_enabled())
        return hidden, self._global_aux(aux)

    def _global_aux(self, aux: torch.Tensor) -> torch.Tensor:
        """The aux loss of the global batch from this rank's: a local
        dispatch's averaged over the data axes; a gathered dispatch's is
        the same on every data rank, and its gradient is divided among
        them so that the gradients' sum over the data axes counts it once."""
        mesh, moe = self.mesh, self.cfg.moe
        if mesh is None or moe is None:
            return aux
        from repro_torch.launch.mesh import data_axes

        data = data_axes(mesh)
        n = mesh.size_of(data)
        if n == 1:
            return aux
        if moe.local_dispatch:
            return mesh.all_reduce(aux, data) / n
        return _ScaleGrad.apply(aux, 1.0 / n) if aux.requires_grad else aux

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh is None:
            if self.cfg.tie_embeddings:
                return L.dense(hidden, self.embed)
            return self.lm_head(hidden)
        from repro_torch.launch.mesh import MODEL_AXIS

        cfg = self.cfg
        if cfg.embed_shard == "replicated" and cfg.tie_embeddings:
            return L.dense(hidden, self.embed)
        if cfg.tie_embeddings and cfg.embed_shard == "d" and hidden.shape[:-1].numel() > cfg.d_model:
            # More positions than columns (a prompt, a train step): the
            # table's D-split columns gathered over the model axis are
            # smaller than the partial logits' sum, and every rank's logits
            # come from the whole table, as one device's do.
            table = mesh.all_gather(self.embed.to(hidden.dtype), MODEL_AXIS, -1, backward="slice")
            return L.dense(hidden, table)
        hidden = self._split_in(hidden)
        if not cfg.tie_embeddings:  # V-split
            return mesh.all_gather(L.dense(hidden, self._full(self.lm_head.weight)), MODEL_AXIS, -1,
                                   backward="slice")
        if cfg.embed_shard == "vocab":
            return mesh.all_gather(L.dense(hidden, self.embed), MODEL_AXIS, -1, backward="slice")
        d = self.embed.shape[1]  # "d", a decode step: this rank's columns of the hidden state
        part = hidden.narrow(-1, mesh.index_of(MODEL_AXIS) * d, d)
        return mesh.all_reduce(L.dense(part, self.embed), MODEL_AXIS)

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor):
        """Causal LM loss over float32 logits, labels < 0 masked out, plus
        ``aux_loss_coef`` x the MoE aux loss -> (loss, {"ce", "aux"}).
        Labels are not shifted (JAX's are not). Attention takes the
        training route whether or not grad is enabled, so the loss under
        ``torch.no_grad`` is the one a train step differentiates. Over a
        mesh: the rank's rows; the loss, ce and aux of the global batch
        (see the module)."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device).expand(b, s)
        hidden, aux = self._run(tokens, positions, train=True)
        aux = self._global_aux(aux)
        logits = self.logits(hidden).float()
        mask = labels >= 0
        safe = labels.clamp(min=0).long().unsqueeze(-1)
        if self.cfg.fused_ce:
            nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, safe)[..., 0]
        else:
            nll = -torch.gather(F.log_softmax(logits, -1), -1, safe)[..., 0]
        num, count = torch.sum(nll * mask), mask.sum()
        if self.mesh is not None:
            from repro_torch.launch.mesh import data_axes

            data = data_axes(self.mesh)
            num, count = self.mesh.all_reduce(num, data), self.mesh.all_reduce(count, data)
        ce = num / count.clamp(min=1)
        return ce + self.cfg.aux_loss_coef * aux, {"ce": ce, "aux": aux}

    # ---------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """Write a prompt into the cache; returns (last-position logits
        [B, V], the cache with its length advanced). Over a mesh: the
        rank's rows of the batch and its cache block."""
        b, s = tokens.shape
        positions = cache.length.unsqueeze(-1) + torch.arange(s, device=tokens.device)
        empty = not bool(cache.length.any())
        hidden, _ = self._run(tokens, positions, cache, empty)
        logits = self.logits(hidden[:, -1:, :])[:, 0, :]
        return logits, dataclasses.replace(cache, length=cache.length + s)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: KVCache) -> tuple[torch.Tensor, KVCache]:
        """tokens int[B], one new token per row -> (logits [B, V], the
        cache with its length advanced by one)."""
        positions = cache.length.unsqueeze(-1)
        hidden, _ = self._run(tokens.unsqueeze(-1), positions, cache)
        logits = self.logits(hidden)[:, 0, :]
        return logits, dataclasses.replace(cache, length=cache.length + 1)
