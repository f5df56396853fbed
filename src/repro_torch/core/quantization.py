"""Quantile-based b-bit residual codec (paper §4.1): bucket boundaries,
encoding, packing, unpacking and explicit decompression.

Layout (shared with the CUDA kernels): dimension ``d`` lives in byte
``d // per_byte`` at bit offset ``(d % per_byte) * b``; when ``D`` is not a
multiple of ``per_byte`` the trailing byte is zero-padded in its high bits.
Counterpart of ``repro/core/quantization.py``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "compute_buckets",
    "encode_residuals",
    "pack_codes",
    "packed_bytes",
    "unpack_codes",
    "decompress",
]

_SUPPORTED_NBITS = (2, 4, 8)


def _check_nbits(nbits: int) -> None:
    if nbits not in _SUPPORTED_NBITS:
        raise ValueError(f"nbits must be one of {_SUPPORTED_NBITS}, got {nbits}")


def _quantiles(s: torch.Tensor, q: np.ndarray) -> torch.Tensor:
    """``jnp.quantile``'s linear method at float32 ``q`` over sorted ``s``,
    bit for bit: pos = q * (n - 1) in float32, lo / hi its floor and ceil,
    hw = pos - lo, lw = 1 - hw, and s[hi] * hw + (s[lo] * lw) with one
    rounding to float32, as XLA on the CPU fuses it (a multiply-add). The
    products and sum of 2^b values run in numpy on the host."""
    n = s.numel()
    pos = q * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = pos - lo
    lw = np.float32(1) - hw
    idx = torch.from_numpy(np.concatenate([lo, hi]).astype(np.int64)).clamp_(0, n - 1)
    vals = s[idx.to(s.device)].cpu().numpy()
    v_lo, v_hi = vals[: len(q)], vals[len(q) :]
    out = v_hi.astype(np.float64) * hw + (v_lo * lw).astype(np.float64)
    return torch.from_numpy(out.astype(np.float32)).to(s.device)


def compute_buckets(residuals: torch.Tensor, nbits: int):
    """Quantile bucket boundaries and representative weights ->
    (cutoffs f32[2^b - 1], weights f32[2^b]): the k/2^b and (k + 0.5)/2^b
    quantiles of the residual values, bit-identical to the JAX package's
    ``jnp.quantile`` (``torch.quantile`` differs from it in the last ulp,
    and refuses more than 2^24 values)."""
    _check_nbits(nbits)
    nb = 1 << nbits
    s = torch.sort(residuals.reshape(-1).float()).values
    if s.numel() == 0:
        raise ValueError("compute_buckets needs at least one residual value")
    if torch.isnan(s[-1]):  # jnp.quantile: any NaN makes every quantile NaN
        s = torch.full_like(s, float("nan"))
    cut_q = np.arange(1, nb, dtype=np.float32) / np.float32(nb)
    w_q = (np.arange(nb, dtype=np.float32) + np.float32(0.5)) / np.float32(nb)
    return _quantiles(s, cut_q), _quantiles(s, w_q)


def encode_residuals(residuals: torch.Tensor, cutoffs: torch.Tensor) -> torch.Tensor:
    """Bucket index per dimension, the number of cutoffs strictly below the
    value (``searchsorted`` side "left"): u8[..., D] in [0, 2^b)."""
    return torch.searchsorted(cutoffs, residuals.contiguous(), right=False).to(torch.uint8)


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
