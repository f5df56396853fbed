"""XTR-style token encoder: a bidirectional transformer with a 128-d
projection. Counterpart of ``repro/models/encoder.py``.

The output contract is the paper's query encoder's: f32[B, S, out_dim],
each valid row L2-normalised with ``rsqrt(sum x^2 + 1e-12)``, padding rows
exactly 0. Padding keys sit at position -10^9, which the attention hides.
Attention is plain ``layers.chunked_attention`` (non-causal), as in JAX:
it needs a key-padding mask the flash kernel does not take, and no TPU
kernel runs here. The JAX package scans a ``vmap``-stacked layer tree;
the port keeps one module per layer (``models/convert.py`` carries the
stacked tree across).

``forward`` is differentiable, as JAX's ``TokenEncoder.encode`` is: a
module from ``from_params(..., trainable=True)`` trains the parameters
it was given (``examples/train_encoder_torch.py`` trains it with the XTR
in-batch objective). ``encode`` is the serving route: the same ops under
``torch.no_grad``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import layers as L

__all__ = ["EncoderConfig", "TokenEncoder"]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 2048
    vocab: int = 32128
    out_dim: int = 128
    query_maxlen: int = 32
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def param_count(self) -> int:
        d = self.d_model
        per_layer = 4 * d * d + 3 * d * self.d_ff + 2 * d
        return self.vocab * d + self.n_layers * per_layer + d + d * self.out_dim


class _EncoderLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        d = cfg.d_model
        self.attn_norm = L.RMSNorm(d)
        self.ffn_norm = L.RMSNorm(d)
        self.wq = L.Dense(d, d)
        self.wk = L.Dense(d, d)
        self.wv = L.Dense(d, d)
        self.wo = L.Dense(d, d)
        self.ffn = L.SwiGLU(d, cfg.d_ff)


class TokenEncoder(nn.Module):
    """Build one with ``TokenEncoder.from_params`` (the constructor leaves
    the weights uninitialised). State-dict names: ``embed`` [V, D],
    ``layers.{i}.{attn_norm,ffn_norm}.scale``,
    ``layers.{i}.{wq,wk,wv,wo}.weight``, ``layers.{i}.ffn.{gate,up,down}.weight``,
    ``final_norm.scale``, ``proj.weight`` [out_dim, D]. Weights are
    [d_out, d_in]."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model))
        self.layers = nn.ModuleList(_EncoderLayer(cfg) for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model)
        self.proj = L.Dense(cfg.d_model, cfg.out_dim)

    @classmethod
    def from_params(cls, cfg: EncoderConfig, params: dict, *, trainable: bool = False
                    ) -> "TokenEncoder":
        """A module that takes ``params`` (``convert.init_params`` or
        ``convert.params_from_jax``) as its parameters without copying
        them. Serving weights are frozen, and freezing leaves the tensors
        it was given as they were. ``trainable=True`` leaves them
        trainable; where ``params`` holds ``nn.Parameter``s
        (``train.TrainState``'s), the module's parameters are those very
        objects, so gradients land on them."""
        if not trainable:
            params = {k: v.detach() for k, v in params.items()}
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(params, strict=True, assign=True)
        return model if trainable else model.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def encode(self, tokens, mask) -> torch.Tensor:
        """tokens i32[B, S], mask bool[B, S] -> f32[B, S, out_dim], with no
        autograd graph (serving)."""
        return self.forward(tokens, mask)

    def forward(self, tokens, mask) -> torch.Tensor:
        """``encode``, differentiable with respect to the parameters."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        mask = torch.as_tensor(mask, device=self.device).bool()
        x = self.embed.to(cfg.dtype)[tokens]
        b, s, _ = x.shape
        h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        positions = torch.arange(s, device=self.device).expand(b, s)
        kv_positions = torch.where(mask, positions, -(10**9))  # hide padding
        cos, sin = L.rope_tables(positions, L.rope_frequencies(dh, device=self.device))
        for lay in self.layers:
            hx = lay.attn_norm(x)
            q = L.rotate(lay.wq(hx).reshape(b, s, h, dh), cos, sin)
            k = L.rotate(lay.wk(hx).reshape(b, s, h, dh), cos, sin)
            v = lay.wv(hx).reshape(b, s, h, dh)
            out = L.chunked_attention(
                q, k, v, causal=False, q_positions=positions, kv_positions=kv_positions,
                chunk_size=min(1024, s),
            )
            x = x + lay.wo(out.reshape(b, s, -1))
            x = x + lay.ffn(lay.ffn_norm(x))
        emb = self.proj(self.final_norm(x)).float()
        emb = emb * torch.rsqrt((emb * emb).sum(-1, keepdim=True) + 1e-12)
        return emb * mask.unsqueeze(-1)
