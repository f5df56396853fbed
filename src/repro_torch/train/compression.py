"""Gradient compression of the port: the int8 round trip with error
feedback. Counterpart of ``repro/train/compression.py``.

JAX applies it across the ``pod`` axis of a multi-pod mesh, to make the
cross-pod all-reduce 4x smaller. One card has no such axis, so here it is
a gradient transform between the backward and the optimizer, with the
same arithmetic: ``torch.round`` rounds half to even, as ``jnp.round``
does.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "init_error_state"]


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads_like: dict) -> dict:
    return {k: torch.zeros_like(g, dtype=torch.float32) for k, g in grads_like.items()}


@torch.no_grad()
def compress_grads(grads: dict, error_state: dict, *, enabled: bool = True) -> tuple[dict, dict]:
    """Error-feedback int8 round trip -> (decompressed grads, new error
    state): each gradient plus its carried error is quantized per tensor,
    and what the quantization lost is carried to the next step."""
    if not enabled:
        return grads, error_state
    out, err = {}, {}
    for k, g in grads.items():
        g32 = g.float() + error_state[k]
        deq = dequantize_int8(*quantize_int8(g32))
        out[k], err[k] = deq.to(g.dtype), g32 - deq
    return out, err
