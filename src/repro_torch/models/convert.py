"""Weights for the port's models: carried across from the JAX package's
parameter pytree, or drawn anew from a ``torch.Generator``.

Both dispatch on the config's type (``TransformerConfig``,
``EncoderConfig``, ``GINConfig`` or one of the four recsys configs) and
return a state dict in the module's names (see ``TransformerLM``,
``TokenEncoder``, ``GIN`` and ``models/recsys.py``), for the model's
``from_params``. Given a ``mesh`` (``launch/mesh.py``), both return this
rank's blocks only, placed by the family's rule (``launch/sharding.py``):
the LM's weights are cut one tensor at a time, so no rank holds the whole
model; float32 weights go into ``train.TrainState.create`` as
they are, and train as its ``nn.Parameter``s. The JAX trees of
the LM and the encoder stack their layers on a leading axis; the port
keeps one module per layer. Dense weights are stored [d_out, d_in] (``nn.Linear``'s
layout), the transpose of the JAX [d_in, d_out]; embedding tables and
xDeepFM's CIN matrices keep the JAX layout. ``state_from_jax`` carries a
whole JAX ``TrainState`` (parameters, moments, step, error feedback)
across, to one process or to a rank's blocks (``train_layout``: ZeRO-1
moments where the LM's experts are ``tp_only``, as JAX's ``state_pspec``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.encoder import EncoderConfig
from repro_torch.models.gnn import GINConfig
from repro_torch.models.moe import moe_init
from repro_torch.models.recsys import DINConfig, SASRecConfig, TwoTowerConfig, XDeepFMConfig
from repro_torch.models.transformer import TransformerConfig

__all__ = ["params_from_jax", "init_params", "jax_leaf", "port_layout", "param_specs",
           "train_layout", "state_from_jax"]

_NORMS = ("attn_norm", "ffn_norm", "q_norm", "k_norm")
_DENSE = ("wq", "wk", "wv", "wo")
_FFN = ("gate", "up", "down")


def jax_leaf(name: str, *, stacked: bool = True) -> tuple[tuple, int | None, bool]:
    """The JAX leaf of the port's parameter ``name``: (its path of keys,
    its layer on the leading axis of JAX's stacked ``layers`` or None,
    whether the port stores it transposed). Dense ``weight`` is JAX's
    ``w`` transposed, ``bias`` its ``b``; a number is a list index.
    ``stacked`` is False for trees whose ``layers`` are a list (GIN)."""
    parts = name.split(".")
    layer = None
    if stacked and parts[0] == "layers":
        layer, parts = int(parts[1]), ["layers", *parts[2:]]
    path, transpose = [], False
    for p in parts:
        if p == "weight":
            path.append("w")
            transpose = True
        elif p == "bias":
            path.append("b")
        else:
            path.append(int(p) if p.isdigit() else p)
    return tuple(path), layer, transpose


def port_layout(parts, name: str, *, stacked: bool = True) -> tuple:
    """A JAX leaf's per-dimension tuple (its shape, or its partition
    spec's entries) in the port's layout of ``name``: the stacked layer
    axis dropped, a Dense weight's two dims swapped."""
    _, layer, transpose = jax_leaf(name, stacked=stacked)
    parts = tuple(parts)
    if layer is not None:
        parts = parts[1:]
    return parts[::-1] if transpose else parts


def param_specs(cfg, mesh) -> dict:
    """name -> ``PartitionSpec`` of ``cfg``'s parameters on ``mesh``: the
    LM's by ``lm_param_pspec`` (its config's ``embed_shard`` and
    ``moe_weight_mode``), the recsys models' by ``recsys_param_pspec``,
    GIN's replicated."""
    from repro_torch.launch import sharding

    shapes = {k: (tuple(v.shape), v.dtype)
              for k, v in init_params(cfg, torch.Generator(), device="meta").items()}
    if isinstance(cfg, TransformerConfig):
        return sharding.lm_param_pspec(shapes, mesh, embed_shard=cfg.embed_shard,
                                       moe_weight_mode=cfg.moe_weight_mode)
    if isinstance(cfg, GINConfig):
        return sharding.replicated(shapes)
    if isinstance(cfg, EncoderConfig):
        raise TypeError("the token encoder is not placed on a mesh")
    return sharding.recsys_param_pspec(shapes, mesh)


def train_layout(cfg, mesh):
    """The ``TrainLayout`` of ``cfg``'s ``TrainState`` on ``mesh``: its
    ``param_specs``, the moments ZeRO-1 (``zero1_opt_pspec``) where JAX's
    ``state_pspec`` makes them so (an LM with ``tp_only`` experts), and the
    LM config for its kv heads."""
    from repro_torch.launch import sharding

    specs = param_specs(cfg, mesh)
    lm = isinstance(cfg, TransformerConfig)
    opt = specs
    if lm and cfg.moe_weight_mode == "tp_only":
        shapes = {k: (tuple(v.shape), v.dtype)
                  for k, v in init_params(cfg, torch.Generator(), device="meta").items()}
        opt = sharding.zero1_opt_pspec(specs, shapes, mesh)
    return sharding.TrainLayout(mesh, specs, opt, cfg if lm else None)


def state_from_jax(state, cfg, *, device=None, mesh=None):
    """A JAX ``TrainState`` of ``cfg``'s model (its ``params``, ``opt``
    {"m", "v", "step"} and ``error_fb``, as attributes or dict keys, arrays
    as numpy) -> the port's ``TrainState`` on ``device``; with ``mesh``, this
    rank's blocks (``train_layout``). The moments and error feedback are
    trees shaped like the parameters, converted alike (error feedback where
    JAX's state carries it)."""
    from torch import nn

    from repro_torch.train.loop import TrainState

    def get(obj, key):
        return obj[key] if isinstance(obj, dict) else getattr(obj, key)

    dev = resolve_device(device)
    layout = None if mesh is None else train_layout(cfg, mesh)

    def tree(t, prefix):
        full = params_from_jax(t, cfg, device="cpu")
        if layout is None:
            return {k: v.to(dev) for k, v in full.items()}
        return {k: layout.cut(f"{prefix}.{k}", v).to(dev, copy=True) for k, v in full.items()}

    opt = get(state, "opt")
    err = get(state, "error_fb")
    params = {k: nn.Parameter(v) for k, v in tree(get(state, "params"), "params").items()}
    step = torch.as_tensor(np.asarray(get(opt, "step")), dtype=torch.int32).to(dev)
    return TrainState(params=params, opt={"m": tree(get(opt, "m"), "opt.m"),
                                          "v": tree(get(opt, "v"), "opt.v"), "step": step},
                      error_fb=None if err is None else tree(err, "error_fb"))


def _placer(cfg, mesh):
    """``place(name, full) -> this rank's block`` (a copy, so the full
    tensor can be freed), or None without a mesh."""
    if mesh is None:
        return None
    from repro_torch.launch import sharding

    specs = param_specs(cfg, mesh)
    if isinstance(cfg, TransformerConfig):
        sharding.kv_heads_of_rank(cfg, mesh)  # raises where the heads do not divide
        return lambda name, t: sharding.lm_local_block(name, t, specs[name], mesh, cfg).clone()
    return lambda name, t: sharding.local_block(t, specs[name], mesh).clone()


def params_from_jax(tree, cfg, *, device=None, dtype=torch.float32, mesh=None) -> dict:
    """The JAX ``init`` pytree of ``cfg``'s model (arrays as numpy or
    anything ``np.asarray`` takes) -> the port's state dict on ``device`` in
    ``dtype``; with ``mesh``, this rank's blocks of it. ``device=None`` is
    the card."""
    dev = resolve_device(device)
    place = _placer(cfg, mesh)
    if place is not None:
        full = params_from_jax(tree, cfg, device="cpu", dtype=dtype)
        return {k: place(k, v).to(dev) for k, v in full.items()}

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

    if isinstance(cfg, GINConfig):
        out = dense("head", tree["head"])
        for i, lp in enumerate(tree["layers"]):
            out.update(dense(f"layers.{i}.mlp1", lp["mlp1"]))
            out.update(dense(f"layers.{i}.mlp2", lp["mlp2"]))
            out[f"layers.{i}.eps"] = t(lp["eps"])
        return out
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
    mesh=None,
) -> dict:
    """Random weights for ``cfg``'s model with its JAX ``init``'s
    distributions, drawn in float32 from ``generator`` (one on ``device``;
    seed 0 when None), stored in ``dtype``. ``device=None`` is the card.
    With ``mesh``, every rank draws the same numbers in the same order and
    keeps its own blocks: the LM one tensor at a time, the recsys and GNN
    models after the whole draw."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    place = _placer(cfg, mesh)
    if isinstance(cfg, TransformerConfig):
        return _lm_init(cfg, generator, dev, dtype, place)
    if isinstance(cfg, EncoderConfig):
        return _encoder_init(cfg, generator, dev, dtype)
    out = (_gin_init if isinstance(cfg, GINConfig) else _recsys_init)(cfg, generator, dev, dtype)
    return out if place is None else {k: place(k, v) for k, v in out.items()}


def _gin_init(cfg: GINConfig, generator, dev, dtype) -> dict:
    """Random weights with ``GIN.init``'s distributions: dense weights
    normal * 1/sqrt(d_in), biases 0, each layer's eps 0."""

    def dense(prefix, d_in, d_out):
        w = torch.randn(d_out, d_in, generator=generator, device=dev) * (1.0 / math.sqrt(d_in))
        return {f"{prefix}.weight": w.to(dtype),
                f"{prefix}.bias": torch.zeros(d_out, dtype=dtype, device=dev)}

    out, d_in = {}, cfg.d_feat
    for i in range(cfg.n_layers):
        out.update(dense(f"layers.{i}.mlp1", d_in, cfg.d_hidden))
        out.update(dense(f"layers.{i}.mlp2", cfg.d_hidden, cfg.d_hidden))
        out[f"layers.{i}.eps"] = torch.zeros((), dtype=dtype, device=dev)
        d_in = cfg.d_hidden
    out.update(dense("head", cfg.d_hidden, cfg.n_classes))
    return out


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


def _lm_init(cfg: TransformerConfig, generator, dev, dtype, place=None) -> dict:
    """Random weights with ``TransformerLM.init``'s distributions: dense
    weights normal * 1/sqrt(d_in), biases 0, norm scales 1, the embedding
    normal * 1/sqrt(d_model); MoE layers as ``moe.moe_init`` draws them.
    ``place(name, full)`` keeps each tensor's block as it is drawn."""
    dh, d = cfg.resolved_head_dim, cfg.d_model
    out = _Kept(place)

    def normal(d_out, d_in):
        w = torch.randn(d_out, d_in, generator=generator, device=dev)
        return (w * (1.0 / math.sqrt(d_in))).to(dtype)

    def const(n, value):
        return torch.full((n,), value, dtype=dtype, device=dev)

    out["embed"] = (torch.randn(cfg.vocab, d, generator=generator, device=dev)
                    * (1.0 / math.sqrt(d))).to(dtype)
    out["final_norm.scale"] = const(d, 1.0)
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
            for name in list(moe):
                out[pre + f"moe.{name}"] = moe.pop(name)
            continue
        out[pre + "ffn.gate.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.up.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.down.weight"] = normal(d, cfg.d_ff)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = normal(cfg.vocab, d)
    return dict(out)


class _Kept(dict):
    """A state dict that keeps ``place(name, tensor)`` of each tensor set
    in it (None: the tensor itself)."""

    def __init__(self, place):
        super().__init__()
        self._place = place

    def __setitem__(self, name, t):
        if self._place is not None:
            t = self._place(name, t)
        super().__setitem__(name, t)
