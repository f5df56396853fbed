"""Weights for the port's models: carried across from the JAX package's
parameter pytree, or drawn anew from a ``torch.Generator``.

Both dispatch on the config's type (``TransformerConfig``,
``EncoderConfig`` or one of the four recsys configs) and return a state
dict in the module's names (see ``TransformerLM``, ``TokenEncoder`` and
``models/recsys.py``), for the model's ``from_params``. The JAX trees of
the LM and the encoder stack their layers on a leading axis; the port
keeps one module per layer. Dense weights are stored [d_out, d_in] (``nn.Linear``'s
layout), the transpose of the JAX [d_in, d_out]; embedding tables and
xDeepFM's CIN matrices keep the JAX layout.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.encoder import EncoderConfig
from repro_torch.models.moe import moe_init
from repro_torch.models.recsys import DINConfig, SASRecConfig, TwoTowerConfig, XDeepFMConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["params_from_jax", "init_params"]

_NORMS = ("attn_norm", "ffn_norm", "q_norm", "k_norm")
_DENSE = ("wq", "wk", "wv", "wo")
_FFN = ("gate", "up", "down")


def params_from_jax(tree, cfg, *, device=None, dtype=torch.float32) -> dict:
    """The JAX ``init`` pytree of ``cfg``'s model (arrays as numpy or
    anything ``np.asarray`` takes) -> the port's state dict on ``device`` in
    ``dtype``. ``device=None`` is the card."""
    dev = resolve_device(device)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a)).to(dev, dtype)

    if isinstance(cfg, TransformerConfig):
        return _lm_from_jax(tree, cfg, t)
    if isinstance(cfg, EncoderConfig):
        return _encoder_from_jax(tree, cfg, t)

    def dense(prefix, p):
        out = {f"{prefix}.weight": t(p["w"], transpose=True)}
        if "b" in p:
            out[f"{prefix}.bias"] = t(p["b"])
        return out

    def mlp(prefix, layers):
        return {k: v for i, p in enumerate(layers) for k, v in dense(f"{prefix}.{i}", p).items()}

    if isinstance(cfg, TwoTowerConfig):
        return {
            "user_table": t(tree["user_table"]), "item_table": t(tree["item_table"]),
            **mlp("user_mlp", tree["user_mlp"]), **mlp("item_mlp", tree["item_mlp"]),
        }
    if isinstance(cfg, SASRecConfig):
        out = {"item_table": t(tree["item_table"]), "pos_table": t(tree["pos_table"])}
        for i, blk in enumerate(tree["blocks"]):
            for name in ("wq", "wk", "wv", "wo", "ff1", "ff2"):
                out.update(dense(f"blocks.{i}.{name}", blk[name]))
            out[f"blocks.{i}.ln1"], out[f"blocks.{i}.ln2"] = t(blk["ln1"]), t(blk["ln2"])
        return out
    if isinstance(cfg, XDeepFMConfig):
        return {
            "table": t(tree["table"]), "linear": t(tree["linear"]),
            **{f"cin.{i}": t(w) for i, w in enumerate(tree["cin"])},
            **mlp("mlp", tree["mlp"]), **dense("cin_out", tree["cin_out"]),
        }
    if isinstance(cfg, DINConfig):
        return {"table": t(tree["table"]), **mlp("attn", tree["attn"]), **mlp("mlp", tree["mlp"])}
    raise TypeError(f"no port of a model with config {type(cfg).__name__}")


def _lm_from_jax(tree, cfg: TransformerConfig, t) -> dict:
    """The JAX ``TransformerLM.init`` pytree (stacked ``layers`` with a
    leading L axis, dense ``w`` [d_in, d_out] and ``b``, norm ``scale``,
    ``embed``, optional ``lm_head``; MoE layers: ``moe.router.w``
    [L, D, E] and the expert stacks ``moe.{gate,up}`` [L, E, D, F],
    ``moe.down`` [L, E, F, D]), each array converted by ``t``."""
    lay = tree["layers"]
    out = {"embed": t(tree["embed"]), "final_norm.scale": t(tree["final_norm"]["scale"])}
    if "lm_head" in tree:
        out["lm_head.weight"] = t(tree["lm_head"]["w"], transpose=True)
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for name in _NORMS:
            if name in lay:
                out[pre + f"{name}.scale"] = t(lay[name]["scale"][i])
        for name in _DENSE:
            out[pre + f"{name}.weight"] = t(lay[name]["w"][i], transpose=True)
            if "b" in lay[name]:
                out[pre + f"{name}.bias"] = t(lay[name]["b"][i])
        if cfg.moe is not None:
            moe = lay["moe"]
            out[pre + "moe.router.weight"] = t(moe["router"]["w"][i], transpose=True)
            for name in _FFN:
                out[pre + f"moe.{name}"] = t(moe[name][i])
            continue
        for name in _FFN:
            out[pre + f"ffn.{name}.weight"] = t(lay["ffn"][name]["w"][i], transpose=True)
    return out


def _encoder_from_jax(tree, cfg: EncoderConfig, t) -> dict:
    """The JAX ``TokenEncoder.init`` pytree (``embed``, ``layers`` stacked
    on a leading L axis, ``final_norm``, ``proj``), each array converted
    by ``t``."""
    lay = tree["layers"]
    out = {
        "embed": t(tree["embed"]),
        "final_norm.scale": t(tree["final_norm"]["scale"]),
        "proj.weight": t(tree["proj"]["w"], transpose=True),
    }
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for name in ("attn_norm", "ffn_norm"):
            out[pre + f"{name}.scale"] = t(lay[name]["scale"][i])
        for name in _DENSE:
            out[pre + f"{name}.weight"] = t(lay[name]["w"][i], transpose=True)
        for name in _FFN:
            out[pre + f"ffn.{name}.weight"] = t(lay["ffn"][name]["w"][i], transpose=True)
    return out


def init_params(
    cfg, generator: torch.Generator | None = None, *, device=None, dtype=torch.float32,
) -> dict:
    """Random weights for ``cfg``'s model with its JAX ``init``'s
    distributions, drawn in float32 from ``generator`` (one on ``device``;
    seed 0 when None), stored in ``dtype``. ``device=None`` is the card."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if isinstance(cfg, TransformerConfig):
        return _lm_init(cfg, generator, dev, dtype)
    if isinstance(cfg, EncoderConfig):
        return _encoder_init(cfg, generator, dev, dtype)
    return _recsys_init(cfg, generator, dev, dtype)


def _encoder_init(cfg: EncoderConfig, generator, dev, dtype) -> dict:
    """Random weights with ``TokenEncoder.init``'s distributions: the
    embedding normal * 1/sqrt(d_model), dense weights normal *
    1/sqrt(d_in), norm scales 1."""
    d = cfg.d_model

    def normal(d_out, d_in):
        w = torch.randn(d_out, d_in, generator=generator, device=dev)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    def ones():
        return torch.ones(d, dtype=dtype, device=dev)

    out = {
        "embed": (torch.randn(cfg.vocab, d, generator=generator, device=dev)
                  * (1.0 / math.sqrt(d))).to(dtype),
        "final_norm.scale": ones(),
    }
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        out[pre + "attn_norm.scale"] = ones()
        out[pre + "ffn_norm.scale"] = ones()
        for name in _DENSE:
            out[pre + f"{name}.weight"] = normal(d, d)
        out[pre + "ffn.gate.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.up.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.down.weight"] = normal(d, cfg.d_ff)
    out["proj.weight"] = normal(cfg.out_dim, d)
    return out


def _recsys_init(cfg, generator, dev, dtype) -> dict:
    """Tables normal * 1/sqrt(D), dense weights normal * 1/sqrt(d_in) with
    zero biases, xDeepFM's CIN matrices normal * 1/sqrt(H_prev * F),
    SASRec's layer-norm scales 1 (``repro/models/recsys.py``'s ``init``)."""

    def normal(rows, cols, fan):
        w = torch.randn(rows, cols, generator=generator, device=dev)
        return w.mul_(1.0 / math.sqrt(fan)).to(dtype)

    def dense(prefix, d_in, d_out, bias=True):
        out = {f"{prefix}.weight": normal(d_out, d_in, d_in)}
        if bias:
            out[f"{prefix}.bias"] = torch.zeros(d_out, dtype=dtype, device=dev)
        return out

    def mlp(prefix, dims):
        out = {}
        for i in range(len(dims) - 1):
            out.update(dense(f"{prefix}.{i}", dims[i], dims[i + 1]))
        return out

    if isinstance(cfg, TwoTowerConfig):
        d = cfg.embed_dim
        return {
            "user_table": normal(cfg.user_vocab, d, d),
            "item_table": normal(cfg.item_vocab, d, d),
            **mlp("user_mlp", (d,) + cfg.tower_mlp), **mlp("item_mlp", (d,) + cfg.tower_mlp),
        }
    if isinstance(cfg, SASRecConfig):
        d = cfg.embed_dim
        out = {"item_table": normal(cfg.item_vocab, d, d), "pos_table": normal(cfg.seq_len, d, d)}
        for i in range(cfg.n_blocks):
            pre = f"blocks.{i}."
            for name in ("wq", "wk", "wv", "wo"):
                out.update(dense(pre + name, d, d, bias=False))
            out.update(dense(pre + "ff1", d, d))
            out.update(dense(pre + "ff2", d, d))
            out[pre + "ln1"] = torch.ones(d, dtype=dtype, device=dev)
            out[pre + "ln2"] = torch.ones(d, dtype=dtype, device=dev)
        return out
    if isinstance(cfg, XDeepFMConfig):
        f, d = cfg.n_fields, cfg.embed_dim
        out = {"table": normal(cfg.vocab, d, d), "linear": normal(cfg.vocab, 1, 1)}
        h_prev = f
        for i, h in enumerate(cfg.cin_layers):
            out[f"cin.{i}"] = normal(h, h_prev * f, h_prev * f)
            h_prev = h
        out.update(mlp("mlp", (f * d,) + cfg.mlp + (1,)))
        out.update(dense("cin_out", sum(cfg.cin_layers), 1))
        return out
    if isinstance(cfg, DINConfig):
        d = cfg.embed_dim
        return {
            "table": normal(cfg.item_vocab, d, d),
            **mlp("attn", (4 * d,) + cfg.attn_mlp + (1,)),
            **mlp("mlp", (3 * d,) + cfg.mlp + (1,)),
        }
    raise TypeError(f"no port of a model with config {type(cfg).__name__}")


def _lm_init(cfg: TransformerConfig, generator, dev, dtype) -> dict:
    """Random weights with ``TransformerLM.init``'s distributions: dense
    weights normal * 1/sqrt(d_in), biases 0, norm scales 1, the embedding
    normal * 1/sqrt(d_model); MoE layers as ``moe.moe_init`` draws them."""
    dh, d = cfg.resolved_head_dim, cfg.d_model

    def normal(d_out, d_in):
        w = torch.randn(d_out, d_in, generator=generator, device=dev)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    out = {
        "embed": (torch.randn(cfg.vocab, d, generator=generator, device=dev)
                  * (1.0 / math.sqrt(d))).to(dtype),
        "final_norm.scale": const(d, 1.0),
    }
    shapes = {
        "wq": cfg.n_heads * dh, "wk": cfg.n_kv_heads * dh, "wv": cfg.n_kv_heads * dh,
    }
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        out[pre + "attn_norm.scale"] = const(d, 1.0)
        out[pre + "ffn_norm.scale"] = const(d, 1.0)
        for name, d_out in shapes.items():
            out[pre + f"{name}.weight"] = normal(d_out, d)
            if cfg.qkv_bias:
                out[pre + f"{name}.bias"] = const(d_out, 0.0)
        out[pre + "wo.weight"] = normal(d, cfg.n_heads * dh)
        if cfg.qk_norm:
            out[pre + "q_norm.scale"] = const(dh, 1.0)
            out[pre + "k_norm.scale"] = const(dh, 1.0)
        if cfg.moe is not None:
            moe = moe_init(generator, cfg.moe, d, cfg.d_ff, device=dev, dtype=dtype)
            out.update({pre + f"moe.{name}": w for name, w in moe.items()})
            continue
        out[pre + "ffn.gate.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.up.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.down.weight"] = normal(d, cfg.d_ff)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = normal(cfg.vocab, d)
    return out
