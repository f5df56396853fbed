"""Dispatch of the scoring stage, flash attention and the embedding bag:
CUDA kernel or plain version.

Counterpart of ``repro/kernels/ops.py``. ``use_kernel=True`` (the resolved
``executor="kernel"``) goes through the kernel wrappers, which launch the
CUDA kernel on a CUDA tensor and run the plain version only on a CPU
tensor; ``use_kernel=False`` (``executor="reference"``) runs the plain
versions in ``ref`` on whatever device the tensors are on. Unlike the TPU
dispatch there is no route from the kernel path to the plain version for
nbits = 8, cap = 0 or an index smaller than one tile: the CUDA kernels
take all of those.

Tile resolution keeps the JAX package's "config" and "heuristic" sources
(the autotune table is not ported), so resolved configs agree.

Every scoring wrapper consults the ``engine.kernel_call`` fault injection
point (``repro_torch.fault``) at its entry, on both executors and every
call: the JAX package consults it at trace time, once per compilation,
and only on its kernel path; the port compiles nothing, and firing on the
CPU's plain path lets the CPU tests drive the failure. A firing point
raises to the caller: there is no fallback.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.fault import FAULTS as _FAULTS
from repro_torch.kernels import ref
from repro_torch.kernels.decompress_score import selective_sum as _selective_sum_kernel
from repro_torch.kernels.embedding_bag import embedding_bag as _embedding_bag_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.fused_gather_score import (
    DEFAULT_RAGGED_TILE_C,
    DEFAULT_TILE_C,
    fused_gather_score,
    ragged_fused_gather_score,
    segmented_ragged_fused_gather_score,
)

__all__ = [
    "selective_sum",
    "fused_gather_selective_sum",
    "ragged_selective_sum",
    "ragged_fused_gather_selective_sum",
    "segmented_ragged_fused_gather_selective_sum",
    "flash_attention",
    "embedding_bag",
    "resolve_tile_c",
    "resolve_tile_choice",
    "validate_tile_c",
    "TileChoice",
]

# The JAX package's default DMA schedule; resolved configs record it so
# they compare equal across packages. It selects nothing on CUDA.
DEFAULT_BUFFERING = "double"


def _check_packable_dim(dim: int, nbits: int, *, byte_wise: bool) -> None:
    """Byte-wise code consumers (the kernels, the byte-LUT path) cannot
    skip the zero-padded trailing byte an odd ``dim`` produces."""
    per_byte = 8 // nbits
    if byte_wise and dim % per_byte:
        raise ValueError(
            f"dim={dim} does not fill whole {nbits}-bit packed bytes "
            f"({8 // nbits} dims/byte): the CUDA kernels and sum_impl="
            "'lut' index codes byte-wise and cannot skip the padded "
            "trailing byte — use executor='reference' with "
            "sum_impl='gather' (and gather='materialize') for this index"
        )


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """A resolved candidate-tile decision: the tile, its source ("config"
    or "heuristic") and the recorded schedule name."""

    tile_c: int
    source: str
    buffering: str


def validate_tile_c(tile_c: int, *, where: str = "tile_c") -> int:
    if not isinstance(tile_c, int) or isinstance(tile_c, bool):
        raise ValueError(f"{where}={tile_c!r} must be an int")
    if tile_c < 8 or tile_c % 8:
        raise ValueError(f"{where}={tile_c} must be a positive multiple of 8")
    return tile_c


def resolve_tile_choice(
    cap: int,
    tile_c: int | None = None,
    *,
    layout: str = "dense",
    buffering: str = "auto",
) -> TileChoice:
    """An explicit ``tile_c`` wins (source "config"); else a power of two
    >= 8 capped at the layout default (dense 128, ragged 32) and at the
    padded cap (source "heuristic")."""
    schedule = DEFAULT_BUFFERING if buffering == "auto" else buffering
    if tile_c is not None:
        chosen = TileChoice(tile_c, "config", schedule)
    else:
        default = DEFAULT_RAGGED_TILE_C if layout == "ragged" else DEFAULT_TILE_C
        tile = min(default, 1 << max(3, (cap - 1).bit_length() if cap > 1 else 3))
        chosen = TileChoice(tile, "heuristic", schedule)
    validate_tile_c(chosen.tile_c, where=f"tile_c ({chosen.source})")
    return chosen


def _fault_kernel_call(op: str) -> None:
    """The ``engine.kernel_call`` injection point; disabled cost: one
    attribute check."""
    if _FAULTS.plan is not None:
        _FAULTS.plan.check("engine.kernel_call", op=op)


def resolve_tile_c(cap: int, tile_c: int | None = None, *, layout: str = "dense") -> int:
    return resolve_tile_choice(cap, tile_c, layout=layout).tile_c


def selective_sum(
    packed: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    use_kernel: bool = True,
    impl: str = "gather",
) -> torch.Tensor:
    """packed u8[Q, N, PB], v f32[Q, D, 2^b] -> f32[Q, N].
    impl (plain path only): "gather" (per dim) | "lut" (byte LUT)."""
    _fault_kernel_call("selective_sum")
    _check_packable_dim(dim, nbits, byte_wise=use_kernel or impl == "lut")
    if use_kernel:
        return _selective_sum_kernel(packed, v, nbits=nbits, dim=dim)
    if impl == "lut":
        return ref.selective_sum_lut(packed, v, nbits=nbits, dim=dim)
    return ref.selective_sum(packed, v, nbits=nbits, dim=dim)


def fused_gather_selective_sum(
    packed_codes: torch.Tensor,
    cluster_offsets: torch.Tensor,
    cluster_sizes: torch.Tensor,
    probe_cids: torch.Tensor,
    probe_scores: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    cap: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """CSR probe + implicit decompression + scoring in one pass:
    probe_cids [Q, P] -> cand_scores f32[Q, P, cap] (invalid slots 0)."""
    _fault_kernel_call("fused_gather_score")
    _check_packable_dim(dim, nbits, byte_wise=use_kernel)
    starts = cluster_offsets[probe_cids].to(torch.int32).contiguous()
    sizes = cluster_sizes[probe_cids].to(torch.int32).contiguous()
    pscores = probe_scores.to(torch.float32).contiguous()
    if not use_kernel:
        return ref.fused_gather_score(
            packed_codes, starts, sizes, pscores, v, nbits=nbits, dim=dim, cap=cap
        )
    return fused_gather_score(
        packed_codes, starts, sizes, pscores, v.contiguous(),
        nbits=nbits, dim=dim, cap=cap,
    )


def ragged_selective_sum(
    packed: torch.Tensor,
    qtok: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    impl: str = "gather",
) -> torch.Tensor:
    """Plain selective sum over a flat worklist-ordered stream:
    packed u8[N, PB], qtok [N] -> f32[N]."""
    _fault_kernel_call("ragged_selective_sum")
    _check_packable_dim(dim, nbits, byte_wise=impl == "lut")
    if impl == "lut":
        return ref.ragged_selective_sum_lut(packed, qtok, v, nbits=nbits, dim=dim)
    return ref.ragged_selective_sum(packed, qtok, v, nbits=nbits, dim=dim)


def ragged_fused_gather_selective_sum(
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
    use_kernel: bool = True,
) -> torch.Tensor:
    """Worklist probe + implicit decompression + scoring in one pass:
    row0/nvalid/qtok [W], pscore [W] -> flat f32[W * tile_c] (invalid
    slots 0)."""
    _fault_kernel_call("ragged_fused_gather_score")
    _check_packable_dim(dim, nbits, byte_wise=use_kernel)
    validate_tile_c(tile_c)
    args = (
        packed_codes,
        row0.to(torch.int32).contiguous(),
        nvalid.to(torch.int32).contiguous(),
        qtok.to(torch.int32).contiguous(),
        pscore.to(torch.float32).contiguous(),
        v.contiguous(),
    )
    if not use_kernel:
        return ref.ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile_c)
    return ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile_c)


def segmented_ragged_fused_gather_selective_sum(
    packed_list,
    row0: torch.Tensor,
    nvalid: torch.Tensor,
    seg: torch.Tensor,
    qtok: torch.Tensor,
    pscore: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    tile_c: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Worklist probe + implicit decompression + scoring across the
    segments of a segmented index: ``packed_list`` holds each segment's
    u8[N_s, PB] codes (base first), row0 (segment-local)/nvalid/seg/qtok
    [W], pscore [W] -> flat f32[W * tile_c] (invalid slots 0). The kernel
    takes every segment in one launch, whatever their sizes (the JAX op
    replays its kernel once per segment and sends segments smaller than a
    tile to its reference)."""
    _fault_kernel_call("segmented_ragged_fused_gather_score")
    _check_packable_dim(dim, nbits, byte_wise=use_kernel)
    validate_tile_c(tile_c)
    args = (
        tuple(packed_list),
        row0.to(torch.int32).contiguous(),
        nvalid.to(torch.int32).contiguous(),
        seg.to(torch.int32).contiguous(),
        qtok.to(torch.int32).contiguous(),
        pscore.to(torch.float32).contiguous(),
        v.contiguous(),
    )
    if not use_kernel:
        return ref.segmented_ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile_c)
    return segmented_ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile_c)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    tq: int = 128,
    tk: int = 128,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Flash-attention forward. q [B, Sq, H, Dh], k/v [B, Skv, Hkv, Dh]
    (the layers' layout) -> [B, Sq, H, Dh]. Pads S to the tile size as the
    JAX dispatch does; GQA reads kv head h // (H / Hkv) instead of
    repeating heads. ``use_kernel=False`` runs the plain version on any
    device."""
    sq, skv = q.shape[1], k.shape[1]
    tq = min(tq, max(8, sq))
    tk = min(tk, max(8, skv))
    sq_p, skv_p = _round_up(sq, tq), _round_up(skv, tk)
    if skv_p != skv and not causal:
        # Padded key positions (> Sq - 1) are hidden only by causality;
        # without it they would contribute — the caller must pre-pad.
        raise ValueError("non-causal flash_attention requires Skv % tk == 0")
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, sq_p - sq))
    if skv_p != skv:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
    args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if use_kernel:
        out = _flash_kernel(*args, causal=causal, window=window)
    else:
        out = ref.flash_attention(*args, causal=causal, window=window, tk=tk)
    return out.transpose(1, 2)[:, :sq]


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor | None = None,
    segment_ids: torch.Tensor | None = None,
    *,
    num_segments: int | None = None,
    weights: torch.Tensor | None = None,
    use_kernel: bool = False,
    bag_indices: torch.Tensor | None = None,
    bag_weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """EmbeddingBag(sum), in the JAX dispatch's two call forms:

    - flat: (table, indices [N], segment_ids [N], num_segments) ->
      ``ref.embedding_bag`` (gather + ``index_add_``), as JAX runs it
      outside any kernel;
    - padded: (table, bag_indices [S, L], bag_weights [S, L]) -> [S, D].
      ``use_kernel=True`` runs the embedding-bag kernel (an index outside
      [0, V) contributes 0, as in the TPU kernel); one launch takes any S,
      L and V, so nothing is padded. ``use_kernel=False`` is JAX's dense
      path: ``jnp.take``'s rows (NaN for an index outside [-V, V), a
      negative one in range wraps) times the weights, summed over L.
    """
    if bag_indices is not None:
        if bag_weights is None:
            raise ValueError("the padded form needs bag_weights beside bag_indices")
        if use_kernel:
            return _embedding_bag_kernel(
                table, bag_indices.contiguous(), bag_weights.to(torch.float32).contiguous()
            )
        s, l = bag_indices.shape
        rows = ref.take(table, bag_indices.reshape(-1)).reshape(s, l, -1)
        return torch.sum(rows * bag_weights.unsqueeze(-1), dim=1)
    if indices is None or segment_ids is None or num_segments is None:
        raise ValueError("the flat form needs indices, segment_ids and num_segments")
    return ref.embedding_bag(
        table, indices, segment_ids, num_segments=num_segments, weights=weights
    )
