"""Fused gather–score kernel wrappers (gather="fused").

``fused_gather_score`` scores the dense ``[Q, P, cap]`` probe grid and
``ragged_fused_gather_score`` a flat tile worklist, both reading the
resident packed codes directly (no gathered copy). On a CUDA tensor each
launches its kernel (``csrc/fused_gather_score.cu``,
``csrc/ragged_fused_gather_score.cu``); on a CPU tensor each runs its plain
version in ``ref``. Invalid slots come out exactly 0 either way.
Counterpart of ``repro/kernels/fused_gather_score.py``; the TPU's DMA
schedules (``buffering``) and measurement carve-outs (``probe``) have no
counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = [
    "fused_gather_score",
    "fused_gather_score_cuda",
    "ragged_fused_gather_score",
    "ragged_fused_gather_score_cuda",
    "DEFAULT_TILE_C",
    "DEFAULT_RAGGED_TILE_C",
]

DEFAULT_TILE_C = 128
DEFAULT_RAGGED_TILE_C = 32


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
    v f32[Q, D, 2^b] -> f32[Q, P, cap] (slots c >= sizes exactly 0)."""
    if packed_codes.device.type == "cpu":
        return ref.fused_gather_score(
            packed_codes, starts, sizes, probe_scores, v,
            nbits=nbits, dim=dim, cap=cap,
        )
    return fused_gather_score_cuda(
        packed_codes, starts, sizes, probe_scores, v, nbits=nbits, dim=dim, cap=cap
    )


def fused_gather_score_cuda(packed_codes, starts, sizes, probe_scores, v, *, nbits, dim, cap):
    dev = _build.cuda_device(packed_codes)
    n, pb = packed_codes.shape
    qm, p = starts.shape
    _build.require_codec(dim, nbits, pb)
    _build.require(packed_codes, "packed_codes", torch.uint8, dev)
    _build.require(starts, "starts", torch.int32, dev)
    _build.require(sizes, "sizes", torch.int32, dev, (qm, p))
    _build.require(probe_scores, "probe_scores", torch.float32, dev, (qm, p))
    _build.require(v, "v", torch.float32, dev, (qm, dim, 1 << nbits))
    out = torch.empty((qm, p, cap), dtype=torch.float32, device=dev)
    if qm == 0 or p == 0 or cap == 0:
        return out
    lib = _build.library("fused_gather_score")
    rc = lib.warp_fused_gather_score(
        packed_codes.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
        probe_scores.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, qm, p, cap, pb, dim, nbits, _build.stream_ptr(dev),
    )
    _build.check("fused_gather_score", rc)
    _build.LAUNCHES["fused_gather_score"] += 1
    return out


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
    """packed_codes u8[N, PB], row0/nvalid/qtok i32[W], pscore f32[W],
    v f32[Q, D, 2^b] -> f32[W * tile_c] (slots c >= nvalid exactly 0)."""
    if packed_codes.device.type == "cpu":
        return ref.ragged_fused_gather_score(
            packed_codes, row0, nvalid, qtok, pscore, v,
            nbits=nbits, dim=dim, tile_c=tile_c,
        )
    return ragged_fused_gather_score_cuda(
        packed_codes, row0, nvalid, qtok, pscore, v, nbits=nbits, dim=dim, tile_c=tile_c
    )


def ragged_fused_gather_score_cuda(
    packed_codes, row0, nvalid, qtok, pscore, v, *, nbits, dim, tile_c
):
    dev = _build.cuda_device(packed_codes)
    n, pb = packed_codes.shape
    (w,) = row0.shape
    qm = v.shape[0]
    _build.require_codec(dim, nbits, pb)
    _build.require(packed_codes, "packed_codes", torch.uint8, dev)
    _build.require(row0, "row0", torch.int32, dev)
    _build.require(nvalid, "nvalid", torch.int32, dev, (w,))
    _build.require(qtok, "qtok", torch.int32, dev, (w,))
    _build.require(pscore, "pscore", torch.float32, dev, (w,))
    _build.require(v, "v", torch.float32, dev, (qm, dim, 1 << nbits))
    out = torch.empty((w * tile_c,), dtype=torch.float32, device=dev)
    if w == 0 or tile_c == 0:
        return out
    lib = _build.library("ragged_fused_gather_score")
    rc = lib.warp_ragged_fused_gather_score(
        packed_codes.data_ptr(), row0.data_ptr(), nvalid.data_ptr(),
        qtok.data_ptr(), pscore.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, w, tile_c, qm, pb, dim, nbits, _build.stream_ptr(dev),
    )
    _build.check("ragged_fused_gather_score", rc)
    _build.LAUNCHES["ragged_fused_gather_score"] += 1
    return out
