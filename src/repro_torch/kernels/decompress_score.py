"""Selective-sum kernel wrapper (gather="materialize").

``selective_sum`` scores pre-gathered packed code rows against the
per-query-token v-tables: the CUDA kernel ``csrc/selective_sum.cu`` on a
CUDA tensor, the plain version ``ref.selective_sum`` on a CPU tensor.
Counterpart of ``repro/kernels/decompress_score.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["selective_sum", "selective_sum_cuda"]


def selective_sum(
    packed: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    """packed u8[Q, N, PB], v f32[Q, D, 2^b] -> f32[Q, N]."""
    if packed.device.type == "cpu":
        return ref.selective_sum(packed, v, nbits=nbits, dim=dim)
    return selective_sum_cuda(packed, v, nbits=nbits, dim=dim)


def selective_sum_cuda(
    packed: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    dev = _build.cuda_device(packed)
    q, n, pb = packed.shape
    _build.require_codec(dim, nbits, pb)
    _build.require(packed, "packed", torch.uint8, dev)
    _build.require(v, "v", torch.float32, dev, (q, dim, 1 << nbits))
    out = torch.empty((q, n), dtype=torch.float32, device=dev)
    if q == 0 or n == 0:
        return out
    lib = _build.library("selective_sum")
    rc = lib.warp_selective_sum(
        packed.data_ptr(), v.data_ptr(), out.data_ptr(),
        q, n, pb, dim, nbits, _build.stream_ptr(dev),
    )
    _build.check("selective_sum", rc)
    _build.LAUNCHES["selective_sum"] += 1
    return out
