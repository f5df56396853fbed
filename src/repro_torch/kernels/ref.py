"""Plain PyTorch versions of the scoring kernels: the semantics contract.

Counterparts of ``repro/kernels/ref.py``. Every CUDA kernel in this
package is held against the function here of the same name; the CPU
tests hold these against the JAX references. They gather — they are the
contract, not the fast path.

``v`` is the per-query-token table ``v[q, d, code] = q_d * bucket_weight
[code]`` (f32[Q, D, 2^b]); a token row's score is ``sum_d v[q, d,
code_d]`` (paper Eq. 5, the centroid term added by the caller or, in the
fused versions, here).
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import unpack_codes
from repro_torch.core.worklist import TileWorklist, per_slot, worklist_slot_positions

__all__ = [
    "selective_sum",
    "selective_sum_lut",
    "ragged_selective_sum",
    "ragged_selective_sum_lut",
    "fused_gather_score",
    "ragged_fused_gather_score",
]

# Dimensions scored per gather step; bounds the gathered intermediate at
# [..., N, D_CHUNK] floats.
D_CHUNK = 32


def _chunks(dim: int):
    step = D_CHUNK if dim % D_CHUNK == 0 else dim
    return range(0, dim, step), step


def selective_sum(
    packed: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    """packed u8[Q, N, PB], v f32[Q, D, 2^b] -> f32[Q, N],
    out[q, n] = sum_d v[q, d, code(q, n, d)]."""
    q, n, _ = packed.shape
    nb = 1 << nbits
    codes = unpack_codes(packed, nbits, dim)  # u8[Q, N, D]
    v_flat = v.float().reshape(q, 1, dim * nb)
    out = torch.zeros((q, n), dtype=torch.float32, device=packed.device)
    starts, step = _chunks(dim)
    for d0 in starts:
        d_idx = torch.arange(d0, d0 + step, device=packed.device) * nb
        idx = codes[..., d0 : d0 + step].long() + d_idx  # [Q, N, step]
        out += torch.gather(v_flat.expand(q, n, dim * nb), 2, idx).sum(-1)
    return out


def _byte_lut(v: torch.Tensor, nbits: int) -> torch.Tensor:
    """lut[q, j, byte] = sum over the dims packed into byte j of
    v[q, dim, digit(byte)] — f32[Q, PB, 256]."""
    q, dim, nb = v.shape
    per_byte = 8 // nbits
    pb = dim // per_byte
    byte_vals = torch.arange(256, device=v.device)
    vg = v.float().reshape(q, pb, per_byte, nb)
    lut = torch.zeros((q, pb, 256), dtype=torch.float32, device=v.device)
    for slot in range(per_byte):
        digits = (byte_vals >> (slot * nbits)) & (nb - 1)
        lut = lut + vg[:, :, slot, digits]
    return lut


def selective_sum_lut(
    packed: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    """Byte-LUT selective sum: out[q, n] = sum_j lut[q, j, packed[q, n, j]]."""
    q, n, pb = packed.shape
    lut = _byte_lut(v, nbits)  # [Q, PB, 256]
    idx = packed.long() + torch.arange(pb, device=packed.device) * 256
    return torch.gather(
        lut.reshape(q, 1, pb * 256).expand(q, n, pb * 256), 2, idx
    ).sum(-1)


def ragged_selective_sum(
    packed: torch.Tensor, qtok: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    """packed u8[N, PB], qtok i32[N], v f32[Q, D, 2^b] -> f32[N],
    out[n] = sum_d v[qtok[n], d, code(n, d)]."""
    n = packed.shape[0]
    nb = 1 << nbits
    codes = unpack_codes(packed, nbits, dim)  # u8[N, D]
    v_flat = v.float().reshape(-1)
    base = qtok.long().unsqueeze(-1) * (dim * nb)  # [N, 1]
    out = torch.zeros((n,), dtype=torch.float32, device=packed.device)
    starts, step = _chunks(dim)
    for d0 in starts:
        d_idx = torch.arange(d0, d0 + step, device=packed.device) * nb
        idx = base + d_idx + codes[:, d0 : d0 + step].long()
        out += v_flat[idx].sum(-1)
    return out


def ragged_selective_sum_lut(
    packed: torch.Tensor, qtok: torch.Tensor, v: torch.Tensor, *, nbits: int, dim: int
) -> torch.Tensor:
    """Byte-LUT variant: out[n] = sum_j lut[qtok[n], j, packed[n, j]]."""
    pb = packed.shape[1]
    lut = _byte_lut(v, nbits).reshape(-1)
    idx = (
        qtok.long().unsqueeze(-1) * (pb * 256)
        + torch.arange(pb, device=packed.device) * 256
        + packed.long()
    )
    return lut[idx].sum(-1)


def fused_gather_score(
    packed_codes: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    probe_scores: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    cap: int,
) -> torch.Tensor:
    """packed_codes u8[N, PB], starts/sizes [Q, P], probe_scores f32[Q, P],
    v f32[Q, D, 2^b] -> f32[Q, P, cap]: slot (q, p, c) is
    ``probe_scores[q, p] + score(row starts[q, p] + c)`` when
    ``c < sizes[q, p]`` and exactly 0 otherwise."""
    qm, p = starts.shape
    n = packed_codes.shape[0]
    lane = torch.arange(cap, device=packed_codes.device)
    pos = (starts.long().unsqueeze(-1) + lane).clamp(0, max(0, n - 1))
    valid = lane < sizes.long().unsqueeze(-1)
    gathered = packed_codes[pos]  # [Q, P, cap, PB]
    scores = selective_sum(
        gathered.reshape(qm, p * cap, -1), v, nbits=nbits, dim=dim
    ).reshape(qm, p, cap)
    return torch.where(valid, scores + probe_scores.float().unsqueeze(-1), 0.0)


def ragged_fused_gather_score(
    packed_codes: torch.Tensor,
    row0: torch.Tensor,
    nvalid: torch.Tensor,
    qtok: torch.Tensor,
    pscore: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    tile_c: int,
) -> torch.Tensor:
    """packed_codes u8[N, PB], worklist row0/nvalid/qtok i32[W] + pscore
    f32[W], v f32[Q, D, 2^b] -> f32[W * tile_c]: slot (w, c) is
    ``pscore[w] + sum_d v[qtok[w], d, code_d]`` of row ``row0[w] + c``
    when ``c < nvalid[w]`` and exactly 0 otherwise."""
    wl = TileWorklist(row0=row0, nvalid=nvalid, qtok=qtok, pscore=pscore)
    pos, valid = worklist_slot_positions(
        wl, tile_c=tile_c, n_tokens=packed_codes.shape[0]
    )
    gathered = packed_codes[pos]  # [W * tile_c, PB]
    qtok_slot = per_slot(qtok, tile_c)
    scores = ragged_selective_sum(gathered, qtok_slot, v, nbits=nbits, dim=dim)
    scores = scores + per_slot(pscore.float(), tile_c)
    return torch.where(valid, scores, 0.0)
