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

Tile resolution follows the JAX package: an explicit ``tile_c``
("config"), then the autotune table (``kernels/autotune.py``, entries
matched to the kind of the planned index's device: "autotune"), then the
heuristic ("heuristic"), so resolved configs agree.

Every scoring wrapper consults the ``engine.kernel_call`` fault injection
point (``repro_torch.fault``) at its entry, on both executors and every
call: the JAX package consults it at trace time, once per compilation,
and only on its kernel path; the port compiles nothing, and firing on the
CPU's plain path lets the CPU tests drive the failure. A firing point
raises to the caller: there is no fallback.

Each wrapper's kernel route reports the kernel's ``work(...)`` to the
step counter of ``launch/cost.py``, once per call that launches (on the
card) or would launch (the plain version on a CPU tensor), under the
kernel's ``_build.LAUNCHES`` name; the ATen ops inside that call are not
counted, so both devices count the same work for the same call.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.fault import FAULTS as _FAULTS
from repro_torch.kernels import _build, autotune, decompress_score, ref
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import fused_gather_score as _fused
from repro_torch.kernels.decompress_score import selective_sum as _selective_sum_kernel
from repro_torch.kernels.embedding_bag import embedding_bag as _embedding_bag_kernel
from repro_torch.kernels.flash_attention import flash_attention as _flash_kernel
from repro_torch.kernels.fused_gather_score import (
    BUFFERINGS,
    DEFAULT_RAGGED_TILE_C,
    DEFAULT_TILE_C,
    PROBES,
    fused_gather_score,
    fused_gather_score_cuda,
    ragged_fused_gather_score,
    ragged_fused_gather_score_cuda,
    segmented_ragged_fused_gather_score,
    validate_tile_c,
)
from repro_torch.launch import cost

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
    """A resolved candidate-tile decision: the tile, its source ("config",
    "autotune" or "heuristic") and the recorded schedule name."""

    tile_c: int
    source: str
    buffering: str


def resolve_tile_choice(
    cap: int,
    tile_c: int | None = None,
    *,
    layout: str = "dense",
    n_tokens: int | None = None,
    nbits: int | None = None,
    dim: int | None = None,
    buffering: str = "auto",
    table: "autotune.AutotuneTable | None" = None,
    device=None,
) -> TileChoice:
    """The candidate tile, with its source. An explicit ``tile_c`` wins
    ("config"). With the full geometry (``n_tokens``, ``nbits``, ``dim``)
    the table (``table``, else the process default) is consulted for an
    entry measured on the kind of ``device`` ("autotune"; it also gives
    the schedule). Else a power of two >= 8 capped at the layout default
    (dense 128, ragged 32) and at the padded cap ("heuristic"). An
    explicit ``buffering`` overrides the tuned one."""
    schedule = DEFAULT_BUFFERING if buffering == "auto" else buffering
    if tile_c is not None:
        chosen = TileChoice(tile_c, "config", schedule)
    else:
        tuned = None
        if n_tokens is not None and nbits is not None and dim is not None:
            tuned = (table if table is not None else autotune.get_default_table()).lookup(
                "ragged" if layout == "ragged" else "dense",
                nbits=nbits, dim=dim, cap=cap, n_tokens=n_tokens,
                backend=autotune.backend_kind(device),
            )
        if tuned is not None:
            chosen = TileChoice(
                tuned.tile_c, "autotune", tuned.buffering if buffering == "auto" else buffering
            )
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
    """The explicit tile or the heuristic's, never a table's: plan
    resolution writes the full choice into the config, so by run time
    ``tile_c`` is concrete."""
    return resolve_tile_choice(cap, tile_c, layout=layout).tile_c


def _check_probe(probe, buffering: str, use_kernel: bool, device, where: str) -> bool:
    """JAX's probe errors: an unknown probe, "compute" without the
    double-buffered schedule, and any carve-out but "full" on the plain
    path (the use_kernel=False executor, or CPU tensors) raise ValueError.
    Returns whether the call is a measurement launch of the CUDA kernel
    (a named probe on the kernel path of a CUDA tensor)."""
    if buffering not in ("auto", *BUFFERINGS):
        raise ValueError(f"buffering={buffering!r} is not one of {('auto', *BUFFERINGS)}")
    if probe is None:
        return False
    if probe not in PROBES:
        raise ValueError(f"probe={probe!r} is not a kernel carve-out; expected one of {PROBES}")
    if probe == "compute" and buffering == "single":
        raise ValueError(
            "probe='compute' skips the row copies, which only the double-buffered "
            "schedule can do; use buffering='double'"
        )
    on_card = use_kernel and device.type == "cuda"
    if probe != "full" and not on_card:
        raise ValueError(
            f"probe={probe!r} requires the CUDA kernel, but {where} runs its plain "
            f"version here (use_kernel={use_kernel}, tensors on {device})"
        )
    return on_card


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
        q, n, pb = packed.shape
        with _counted(q * n, "selective_sum", decompress_score.work,
                      q=q, n=n, pb=pb, dim=dim, nbits=nbits):
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
    buffering: str = "auto",
    probe: str | None = None,
) -> torch.Tensor:
    """CSR probe + implicit decompression + scoring in one pass:
    probe_cids [Q, P] -> cand_scores f32[Q, P, cap] (invalid slots 0).
    ``buffering`` is recorded only (the card has one schedule). ``probe``
    None is the product call; a carve-out of ``PROBES`` on the card is a
    measurement launch, counted apart (``_build.LAUNCHES``): "full" runs
    the product kernel, "dma" and "compute" split its time and give no
    scores. "full" on the plain path is the product call."""
    _fault_kernel_call("fused_gather_score")
    measure = _check_probe(probe, buffering, use_kernel, packed_codes.device, "fused_gather_score")
    _check_packable_dim(dim, nbits, byte_wise=use_kernel)
    starts = cluster_offsets[probe_cids].to(torch.int32).contiguous()
    sizes = cluster_sizes[probe_cids].to(torch.int32).contiguous()
    pscores = probe_scores.to(torch.float32).contiguous()
    if not use_kernel:
        return ref.fused_gather_score(
            packed_codes, starts, sizes, pscores, v, nbits=nbits, dim=dim, cap=cap
        )
    qm, p = starts.shape
    with _counted(qm * p * cap, _build.launch_key("fused_gather_score", probe if measure else None),
                  _fused.work, q=qm, p=p, cap=cap, rows=lambda: sizes.clamp(0, cap).sum(),
                  pb=packed_codes.shape[1], dim=dim, nbits=nbits):
        if measure:
            return fused_gather_score_cuda(
                packed_codes, starts, sizes, pscores, v.contiguous(),
                nbits=nbits, dim=dim, cap=cap, probe=probe,
            )
        return fused_gather_score(
            packed_codes, starts, sizes, pscores, v.contiguous(), nbits=nbits, dim=dim, cap=cap
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
    buffering: str = "auto",
    probe: str | None = None,
) -> torch.Tensor:
    """Worklist probe + implicit decompression + scoring in one pass:
    row0/nvalid/qtok [W], pscore [W] -> flat f32[W * tile_c] (invalid
    slots 0). ``buffering`` and ``probe`` as in
    ``fused_gather_selective_sum``."""
    _fault_kernel_call("ragged_fused_gather_score")
    measure = _check_probe(
        probe, buffering, use_kernel, packed_codes.device, "ragged_fused_gather_score"
    )
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
    w = args[2].shape[0]
    with _counted(w * tile_c,
                  _build.launch_key("ragged_fused_gather_score", probe if measure else None),
                  _fused.ragged_work, w=w, tile_c=tile_c, q=v.shape[0],
                  rows=lambda: args[2].sum(), pb=packed_codes.shape[1], dim=dim, nbits=nbits):
        if measure:
            return ragged_fused_gather_score_cuda(
                *args, nbits=nbits, dim=dim, tile_c=tile_c, probe=probe
            )
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
    w = args[2].shape[0]
    with _counted(w * tile_c, "segmented_ragged_fused_gather_score", _fused.segmented_work,
                  w=w, tile_c=tile_c, q=v.shape[0], rows=lambda: args[2].sum(),
                  n_segments=len(args[0]), pb=args[0][0].shape[1], dim=dim, nbits=nbits):
        return segmented_ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile_c)


def _counted(size: int, name: str, work, **shapes):
    """``cost.kernel`` around a call that launches (``size`` > 0: the
    wrappers launch nothing for an empty output)."""
    return cost.kernel(name, work, **shapes) if size else contextlib.nullcontext()


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
        b, _, h, dh = q.shape
        with _counted(q.numel(), "flash_attention", _flash.work, b=b, h=h, hkv=k.shape[2],
                      sq=sq, skv=skv, dh=dh, itemsize=q.element_size(), causal=causal,
                      window=window):
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
      L and V, so nothing is padded. It is differentiable in the table and
      the weights, through the bag's backward kernels. ``use_kernel=False`` is JAX's dense
      path: ``jnp.take``'s rows (NaN for an index outside [-V, V), a
      negative one in range wraps) times the weights, summed over L.
    """
    if bag_indices is not None:
        if bag_weights is None:
            raise ValueError("the padded form needs bag_weights beside bag_indices")
        s, l = bag_indices.shape
        if use_kernel:
            with _counted(s * l * table.shape[1], "embedding_bag", _bag.work, s=s, l=l,
                          d=table.shape[1], needed=lambda: (bag_weights != 0).sum(),
                          index_bytes=bag_indices.element_size()):
                return _embedding_bag_kernel(
                    table, bag_indices.contiguous(), bag_weights.to(torch.float32).contiguous()
                )
        rows = ref.take(table, bag_indices.reshape(-1)).reshape(s, l, -1)
        return torch.sum(rows * bag_weights.unsqueeze(-1), dim=1)
    if indices is None or segment_ids is None or num_segments is None:
        raise ValueError("the flat form needs indices, segment_ids and num_segments")
    return ref.embedding_bag(
        table, indices, segment_ids, num_segments=num_segments, weights=weights
    )
