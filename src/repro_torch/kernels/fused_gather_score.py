"""Fused gather–score kernel wrappers (gather="fused").

``fused_gather_score`` scores the dense ``[Q, P, cap]`` probe grid,
``ragged_fused_gather_score`` a flat tile worklist and
``segmented_ragged_fused_gather_score`` a worklist spanning the segments
of a segmented index (one launch over all of them), all reading the
resident packed codes directly (no gathered copy). On a CUDA tensor each
launches its kernel (``csrc/fused_gather_score.cu``,
``csrc/ragged_fused_gather_score.cu`` and its segmented entry); on a CPU
tensor each runs its plain version in ``ref``. Invalid slots come out exactly 0 either way.
Counterpart of ``repro/kernels/fused_gather_score.py``. The TPU's DMA
schedules (``buffering``) have no counterpart: the card has one, the
cp.async ring of ``csrc/score_rows.cuh``.

The two single-array CUDA wrappers also launch the TPU kernels'
measurement carve-outs (``probe``, one of ``PROBES``, which
``ops.fused_gather_selective_sum`` and
``ops.ragged_fused_gather_selective_sum`` check), each a compile-time
mode of the CUDA kernel: "full" is the product kernel, "dma" stages every
row through the ring and reads it into a sink in place of the v-table
lookups (``ref.fused_gather_score_dma`` gives its output bit for bit),
"compute" issues no copies and scores what the ring holds. All three
write the zero tails. ``probe=None`` is the product path, counted under
the kernel's name in ``_build.LAUNCHES``; a named probe is a measurement
launch, counted under ``"<name>:<probe>"``, so the launches of the
product path count it alone.

``work``, ``ragged_work`` and ``segmented_work`` give the least work of
one call of each kernel, (flops, bytes), which the step counter
(``launch/cost.py``) and each kernel's bound read: the valid code rows,
each tile's or probe's arrays and the v-tables read once, every output
slot written once; one add per (valid row, dim).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = [
    "fused_gather_score",
    "fused_gather_score_cuda",
    "ragged_fused_gather_score",
    "ragged_fused_gather_score_cuda",
    "segmented_ragged_fused_gather_score",
    "segmented_ragged_fused_gather_score_cuda",
    "DEFAULT_TILE_C",
    "DEFAULT_RAGGED_TILE_C",
    "BUFFERINGS",
    "PROBES",
    "validate_tile_c",
    "dense_dims_per_chunk",
    "ragged_dims_per_chunk",
    "work",
    "ragged_work",
    "segmented_work",
]

DEFAULT_TILE_C = 128
DEFAULT_RAGGED_TILE_C = 32
# Shared-memory bytes of a segmented ragged block's per-tile segment code
# bases and row counts (csrc/ragged_fused_gather_score.cu, kSegTileBytes).
SEGMENT_TILE_BYTES = 12 * ref.RAGGED_MAX_TILES + 8
# The JAX package's DMA schedules, recorded in resolved configs and
# autotune entries; they select nothing on the card.
BUFFERINGS = ("double", "single")
# Measurement carve-outs; the C probe entries take the last two by their
# template argument (score_rows::Probe), "full" is the product entry.
PROBES = ("full", "dma", "compute")
_CARVE_OUT = {"dma": 1, "compute": 2}
# Shared-memory bytes of a ragged block's tile arrays (pre, row0, qtok,
# pscore) beside the v-table.
RAGGED_TILE_BYTES = 4 * (4 * ref.RAGGED_MAX_TILES + 1)


def validate_tile_c(tile_c: int, *, where: str = "tile_c") -> int:
    if not isinstance(tile_c, int) or isinstance(tile_c, bool):
        raise ValueError(f"{where}={tile_c!r} must be an int")
    if tile_c < 8 or tile_c % 8:
        raise ValueError(f"{where}={tile_c} must be a positive multiple of 8")
    return tile_c


def _vtable_bytes(q: int, dim: int, nbits: int) -> int:
    return q * dim * (1 << nbits) * 4


def work(*, q: int, p: int, cap: int, rows: int, pb: int, dim: int, nbits: int):
    """The dense kernel over q tokens x p probes: ``rows`` valid code rows
    (sum of min(size, cap)), each probe's start, size and score (12
    bytes), the [q, p, cap] scores written."""
    return (float(rows * dim),
            float(rows * pb + q * p * 12 + _vtable_bytes(q, dim, nbits) + 4 * q * p * cap))


def ragged_work(*, w: int, tile_c: int, q: int, rows: int, pb: int, dim: int, nbits: int):
    """The ragged kernel over a worklist of ``w`` tiles: ``rows`` valid
    rows (sum of nvalid), each tile's row0, nvalid, qtok and score (16
    bytes), the [w * tile_c] scores written."""
    return (float(rows * dim),
            float(rows * pb + w * 16 + _vtable_bytes(q, dim, nbits) + 4 * w * tile_c))


def segmented_work(*, w: int, tile_c: int, q: int, rows: int, n_segments: int, pb: int,
                   dim: int, nbits: int):
    """The segmented entry: as ``ragged_work`` plus each tile's segment
    index (20 bytes a tile) and each segment's code base and row count
    (16 bytes a segment)."""
    return (float(rows * dim),
            float(rows * pb + w * 20 + _vtable_bytes(q, dim, nbits) + 4 * w * tile_c
                  + 16 * n_segments))


def dense_dims_per_chunk(dim: int, nbits: int, n_probes: int) -> int:
    """V-table dims per chunk of the dense kernel at ``n_probes`` probes
    per token (its probe arrays sit beside the table)."""
    return _build.vtable_chunk(dim, nbits, 4 * (3 * n_probes + 1))


def ragged_dims_per_chunk(dim: int, nbits: int) -> int:
    """V-table dims per chunk of the ragged kernels."""
    return _build.vtable_chunk(dim, nbits, RAGGED_TILE_BYTES)


def _launch(lib, name: str, product: str, args, probe, dev) -> None:
    """Launch ``name``'s product entry (``probe`` None or "full") or its
    probe entry at carve-out ``probe``, and count it."""
    if probe is None or probe == "full":
        rc = getattr(lib, product)(*args, _build.stream_ptr(dev))
    else:
        rc = getattr(lib, f"{product}_probe")(*args, _CARVE_OUT[probe], _build.stream_ptr(dev))
    _build.check(name, rc)
    _build.LAUNCHES[_build.launch_key(name, probe)] += 1


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


def fused_gather_score_cuda(
    packed_codes, starts, sizes, probe_scores, v, *, nbits, dim, cap, probe=None
):
    dev = _build.cuda_device(packed_codes)
    n, pb = packed_codes.shape
    qm, p = starts.shape
    _build.require_codec(dim, nbits, pb)
    dense_dims_per_chunk(dim, nbits, p)
    _build.require(packed_codes, "packed_codes", torch.uint8, dev)
    _build.require(starts, "starts", torch.int32, dev)
    _build.require(sizes, "sizes", torch.int32, dev, (qm, p))
    _build.require(probe_scores, "probe_scores", torch.float32, dev, (qm, p))
    _build.require(v, "v", torch.float32, dev, (qm, dim, 1 << nbits))
    out = torch.empty((qm, p, cap), dtype=torch.float32, device=dev)
    if qm == 0 or p == 0 or cap == 0:
        return out
    lib = _build.library("fused_gather_score")
    args = (
        packed_codes.data_ptr(), starts.data_ptr(), sizes.data_ptr(),
        probe_scores.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, qm, p, cap, pb, dim, nbits,
    )
    _launch(lib, "fused_gather_score", "warp_fused_gather_score", args, probe, dev)
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
    packed_codes, row0, nvalid, qtok, pscore, v, *, nbits, dim, tile_c, probe=None
):
    dev = _build.cuda_device(packed_codes)
    n, pb = packed_codes.shape
    w = nvalid.shape[0]
    qm = v.shape[0]
    _build.require_codec(dim, nbits, pb)
    ragged_dims_per_chunk(dim, nbits)
    _build.require(packed_codes, "packed_codes", torch.uint8, dev)
    _build.require(row0, "row0", torch.int32, dev, (w,))
    _build.require(nvalid, "nvalid", torch.int32, dev, (w,))
    _build.require(qtok, "qtok", torch.int32, dev, (w,))
    _build.require(pscore, "pscore", torch.float32, dev, (w,))
    _build.require(v, "v", torch.float32, dev, (qm, dim, 1 << nbits))
    out = torch.empty((w * tile_c,), dtype=torch.float32, device=dev)
    if w == 0 or tile_c == 0:
        return out
    lib = _build.library("ragged_fused_gather_score")
    args = (
        packed_codes.data_ptr(), row0.data_ptr(), nvalid.data_ptr(),
        qtok.data_ptr(), pscore.data_ptr(), v.data_ptr(), out.data_ptr(),
        n, w, tile_c, qm, pb, dim, nbits,
    )
    _launch(lib, "ragged_fused_gather_score", "warp_ragged_fused_gather_score", args, probe, dev)
    return out


def segmented_ragged_fused_gather_score(
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
) -> torch.Tensor:
    """packed_list: each segment's u8[N_s, PB] codes (base first);
    row0 (segment-local)/nvalid/seg/qtok i32[W], pscore f32[W], v f32[Q,
    D, 2^b] -> f32[W * tile_c] (slots c >= nvalid exactly 0)."""
    if row0.device.type == "cpu":
        return ref.segmented_ragged_fused_gather_score(
            packed_list, row0, nvalid, seg, qtok, pscore, v,
            nbits=nbits, dim=dim, tile_c=tile_c,
        )
    return segmented_ragged_fused_gather_score_cuda(
        packed_list, row0, nvalid, seg, qtok, pscore, v, nbits=nbits, dim=dim, tile_c=tile_c
    )


def segment_table(packed_list, device) -> torch.Tensor:
    """The segmented kernel's table int64[2 S] on ``device``: each
    segment's code base address, then its row count (a new tensor)."""
    addrs = [int(c.data_ptr()) for c in packed_list]
    rows = [int(c.shape[0]) for c in packed_list]
    return torch.tensor(addrs + rows, dtype=torch.int64).to(device)


# Device tables by content (device, addresses, row counts): a retrieve
# over the same segments copies no table to the card. An entry is valid
# whatever happens to the memory, since it holds exactly its key.
_TABLES: dict = {}
_TABLES_MAX = 64


def _cached_segment_table(packed_list, device) -> torch.Tensor:
    key = (str(device), *(int(c.data_ptr()) for c in packed_list),
           *(int(c.shape[0]) for c in packed_list))
    table = _TABLES.get(key)
    if table is None:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.clear()
        table = _TABLES[key] = segment_table(packed_list, device)
    return table


def segmented_ragged_fused_gather_score_cuda(
    packed_list, row0, nvalid, seg, qtok, pscore, v, *, nbits, dim, tile_c
):
    dev = _build.cuda_device(row0)
    if not packed_list:
        raise ValueError("packed_list holds no segment")
    pb = packed_list[0].shape[1]
    w = nvalid.shape[0]
    qm = v.shape[0]
    _build.require_codec(dim, nbits, pb)
    # The single-array kernel's v-table chunk (so sums run in its order),
    # beside a block's further arrays of segment bases and row counts.
    dc = ragged_dims_per_chunk(dim, nbits)
    if not _build._vtable_fits(dc, nbits, RAGGED_TILE_BYTES + SEGMENT_TILE_BYTES):
        raise ValueError(
            f"a v-table chunk of {dc} dims at nbits={nbits} leaves no room for a "
            "segmented block's tile arrays"
        )
    for i, codes in enumerate(packed_list):
        _build.require(codes, f"packed_list[{i}]", torch.uint8, dev)
        if codes.dim() != 2 or codes.shape[1] != pb:
            raise ValueError(f"packed_list[{i}] has shape {tuple(codes.shape)}, expected [N, {pb}]")
    _build.require(row0, "row0", torch.int32, dev, (w,))
    _build.require(nvalid, "nvalid", torch.int32, dev, (w,))
    _build.require(seg, "seg", torch.int32, dev, (w,))
    _build.require(qtok, "qtok", torch.int32, dev, (w,))
    _build.require(pscore, "pscore", torch.float32, dev, (w,))
    _build.require(v, "v", torch.float32, dev, (qm, dim, 1 << nbits))
    out = torch.empty((w * tile_c,), dtype=torch.float32, device=dev)
    if w == 0 or tile_c == 0:
        return out
    table = _cached_segment_table(packed_list, dev)
    aligned = all(int(c.data_ptr()) % 16 == 0 for c in packed_list)
    lib = _build.library("ragged_fused_gather_score")
    rc = lib.warp_segmented_ragged_fused_gather_score(
        row0.data_ptr(), nvalid.data_ptr(), seg.data_ptr(), qtok.data_ptr(),
        pscore.data_ptr(), v.data_ptr(), out.data_ptr(), table.data_ptr(),
        len(packed_list), int(aligned), w, tile_c, qm, pb, dim, nbits, _build.stream_ptr(dev),
    )
    _build.check("ragged_fused_gather_score", rc)
    _build.LAUNCHES["segmented_ragged_fused_gather_score"] += 1
    return out
