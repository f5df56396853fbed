"""LM generation of the port: prefill, then a decode loop over the KV
cache. Counterpart of ``repro/serving/generate.py::generate``.

Greedy decoding takes ``argmax`` (the first maximal index, as
``jnp.argmax`` does), so it matches the JAX ``generate`` token for token.
Sampling at a temperature draws with ``torch.multinomial`` from the given
``torch.Generator``: reproducible per seed, but not the numbers
``jax.random`` would draw.

Over a mesh (a model from ``TransformerLM.from_params(..., mesh=)``),
every rank runs the same loop on the same prompt: it prefills and decodes
its rows of the batch (split over the data axes, its cache block with its
own kv heads), its logits are the whole vocabulary's (gathered over the
model axis), and the tokens of every row are gathered over the data axes
at the end, so every rank returns the same tokens.
"""

from __future__ import annotations

import torch

from repro_torch.models.transformer import KVCache, TransformerLM

__all__ = ["generate"]


def _pick(logits: torch.Tensor, temperature: float, generator) -> torch.Tensor:
    if temperature == 0.0:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


@torch.no_grad()
def generate(
    model: TransformerLM,
    prompt,
    *,
    max_new_tokens: int,
    max_len: int | None = None,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    cache_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """prompt int[B, S_prompt] (a tensor or anything ``torch.as_tensor``
    takes) -> int32[B, max_new_tokens] continuations, on the model's
    device. ``generator`` (on that device) drives sampling; None is seed 0.
    Over a mesh every rank passes the whole prompt and gets every row's
    tokens."""
    dev, mesh = model.device, model.mesh
    prompt = torch.as_tensor(prompt, device=dev).long()
    b, s_prompt = prompt.shape
    max_len = max_len or (s_prompt + max_new_tokens)
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    if mesh is not None:
        from repro_torch.launch import sharding

        spec = sharding.batch_pspec({"prompt": prompt}, mesh)["prompt"]
        prompt = sharding.local_block(prompt, spec, mesh)
    cache = KVCache.empty(model.cfg, b, max_len, cache_dtype, device=dev, mesh=mesh)
    logits, cache = model.prefill(prompt, cache)
    nxt = _pick(logits, temperature, generator)
    out = [nxt]
    for _ in range(max_new_tokens - 1):
        logits, cache = model.decode_step(nxt.long(), cache)
        nxt = _pick(logits, temperature, generator)
        out.append(nxt)
    tokens = torch.stack(out, dim=1)
    return tokens if mesh is None else sharding.gather_block(tokens, spec, mesh)
