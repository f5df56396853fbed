"""Weights for the port's ``TransformerLM``: carried across from the JAX
package's parameter pytree, or drawn anew from a ``torch.Generator``.

Both return a state dict in the module's names (see ``TransformerLM``),
for ``TransformerLM.from_params``. Dense weights are stored [d_out, d_in]
(``nn.Linear``'s layout), the transpose of the JAX [d_in, d_out].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models.transformer import TransformerConfig

__all__ = ["params_from_jax", "init_params"]

_NORMS = ("attn_norm", "ffn_norm", "q_norm", "k_norm")
_DENSE = ("wq", "wk", "wv", "wo")
_FFN = ("gate", "up", "down")


def params_from_jax(tree, cfg: TransformerConfig, *, device=None, dtype=torch.float32) -> dict:
    """The JAX ``TransformerLM.init`` pytree (arrays as numpy or anything
    ``np.asarray`` takes: stacked ``layers`` with a leading L axis, dense
    ``w`` [d_in, d_out] and ``b``, norm ``scale``, ``embed``, optional
    ``lm_head``) -> the port's state dict on ``device`` in ``dtype``.
    ``device=None`` is the card."""
    dev = resolve_device(device)

    def t(a, transpose=False):
        a = np.asarray(a, dtype=np.float32)
        return torch.from_numpy(np.array(a.T if transpose else a)).to(dev, dtype)

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
        for name in _FFN:
            out[pre + f"ffn.{name}.weight"] = t(lay["ffn"][name]["w"][i], transpose=True)
    return out


def init_params(
    cfg: TransformerConfig, generator: torch.Generator | None = None, *, device=None,
    dtype=torch.float32,
) -> dict:
    """Random weights with ``TransformerLM.init``'s distributions: dense
    weights normal * 1/sqrt(d_in), biases 0, norm scales 1, the embedding
    normal * 1/sqrt(d_model). Drawn in float32 from ``generator`` (one on
    ``device``; seed 0 when None), stored in ``dtype``. ``device=None`` is
    the card."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
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
        out[pre + "ffn.gate.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.up.weight"] = normal(cfg.d_ff, d)
        out[pre + "ffn.down.weight"] = normal(d, cfg.d_ff)
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = normal(cfg.vocab, d)
    return out
