"""b-bit residual codes: packing, unpacking and explicit decompression.

Layout (shared with the CUDA kernels): dimension ``d`` lives in byte
``d // per_byte`` at bit offset ``(d % per_byte) * b``; when ``D`` is not a
multiple of ``per_byte`` the trailing byte is zero-padded in its high bits.
Counterpart of ``repro/core/quantization.py``.
"""

from __future__ import annotations

import torch

__all__ = ["pack_codes", "packed_bytes", "unpack_codes", "decompress"]

_SUPPORTED_NBITS = (2, 4, 8)


def _check_nbits(nbits: int) -> None:
    if nbits not in _SUPPORTED_NBITS:
        raise ValueError(f"nbits must be one of {_SUPPORTED_NBITS}, got {nbits}")


def packed_bytes(dim: int, nbits: int) -> int:
    """Bytes per token row: ceil(dim * nbits / 8)."""
    _check_nbits(nbits)
    return -(-dim * nbits // 8)


def pack_codes(codes: torch.Tensor, nbits: int) -> torch.Tensor:
    """u8[..., D] bucket indices -> u8[..., ceil(D * nbits / 8)]."""
    _check_nbits(nbits)
    if nbits == 8:
        return codes.to(torch.uint8)
    per_byte = 8 // nbits
    d = codes.shape[-1]
    pb = -(-d // per_byte)
    pad = pb * per_byte - d
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    grouped = codes.reshape(*codes.shape[:-1], pb, per_byte).to(torch.int32)
    shifts = torch.arange(per_byte, dtype=torch.int32, device=codes.device) * nbits
    return (grouped << shifts).sum(dim=-1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, nbits: int, dim: int) -> torch.Tensor:
    """u8[..., ceil(D * nbits / 8)] -> u8[..., D] bucket indices."""
    _check_nbits(nbits)
    if nbits == 8:
        return packed
    per_byte = 8 // nbits
    shifts = torch.arange(per_byte, dtype=torch.uint8, device=packed.device) * nbits
    expanded = (packed.unsqueeze(-1) >> shifts) & ((1 << nbits) - 1)
    flat = expanded.reshape(*packed.shape[:-1], packed.shape[-1] * per_byte)
    return flat[..., :dim]


def decompress(
    packed: torch.Tensor,
    centroid_vecs: torch.Tensor,
    weights: torch.Tensor,
    *,
    nbits: int,
    dim: int,
) -> torch.Tensor:
    """Explicit decompression: centroid + bucket weight per dimension."""
    codes = unpack_codes(packed, nbits, dim)
    return centroid_vecs + weights[codes.long()]
