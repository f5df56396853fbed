"""Gradient compression of the port: the int8 round trip with error
feedback. Counterpart of ``repro/train/compression.py``.

JAX applies it across the ``pod`` axis of a multi-pod mesh, to make the
cross-pod all-reduce 4x smaller. One card has no such axis, so here it is
a gradient transform between the backward and the optimizer, with the
same arithmetic: ``torch.round`` rounds half to even, as ``jnp.round``
does.

Over a mesh (``layout``) each rank compresses its blocks of the synced
gradients: the scale is the max over the whole tensor (one all-reduce of
every block's max over the mesh), so the blocks quantize as the whole
tensor does, bit for bit; the error feedback stays per block.
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compress_grads", "init_error_state"]


def quantize_int8(x: torch.Tensor, amax: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 codes and the scale of ``x``; ``amax`` is max |x| where the
    caller has it (a tensor's over all its blocks)."""
    scale = (x.abs().max() if amax is None else amax) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads_like: dict, layout=None) -> dict:
    """Zeros in the gradient blocks' shapes (with ``layout``, the ZeRO-1
    slices a rank updates)."""
    from repro_torch.train.optimizer import zero1_slice

    return {k: torch.zeros_like(zero1_slice(g, k, layout), dtype=torch.float32)
            for k, g in grads_like.items()}


@torch.no_grad()
def compress_grads(grads: dict, error_state: dict, *, enabled: bool = True,
                   layout=None) -> tuple[dict, dict]:
    """Error-feedback int8 round trip -> (decompressed grads, new error
    state): each gradient plus its carried error is quantized per tensor,
    and what the quantization lost is carried to the next step. With
    ``layout``, over the rank's blocks (see the module)."""
    if not enabled:
        return grads, error_state
    g32 = {k: g.float() + error_state[k] for k, g in grads.items()}
    amax = None
    if layout is not None:
        mesh = layout.mesh
        local = torch.stack([x.abs().max() for x in g32.values()])
        amax = dict(zip(g32, mesh.all_reduce_max(local, mesh.axis_names)))
    out, err = {}, {}
    for k, g in grads.items():
        deq = dequantize_int8(*quantize_int8(g32[k], None if amax is None else amax[k]))
        out[k], err[k] = deq.to(g.dtype), g32[k] - deq
    return out, err
