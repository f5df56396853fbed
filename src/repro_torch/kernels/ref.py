"""Plain PyTorch versions of the scoring kernels: the semantics contract.

Counterparts of ``repro/kernels/ref.py`` (and, for ``flash_attention`` and
``embedding_bag_bags``, of the functions ``repro/kernels/flash_attention.py``
and ``repro/kernels/embedding_bag.py`` compute). Every CUDA
kernel in this package is held against the function here of the same
name; the CPU tests hold these against the JAX references. They gather
and materialize — they are the contract, not the fast path.

``v`` is the per-query-token table ``v[q, d, code] = q_d * bucket_weight
[code]`` (f32[Q, D, 2^b]); a token row's score is ``sum_d v[q, d,
code_d]`` (paper Eq. 5, the centroid term added by the caller or, in the
fused versions, here).
"""

from __future__ import annotations

import math

import torch


__all__ = [
    "selective_sum",
    "selective_sum_lut",
    "ragged_selective_sum",
    "ragged_selective_sum_lut",
    "fused_gather_score",
    "score_blocks_per_token",
    "score_split",
    "fused_gather_score_split",
    "staged_row_sink",
    "fused_gather_score_dma",
    "ragged_fused_gather_score",
    "ragged_fused_gather_score_dma",
    "segmented_ragged_gather_codes",
    "segmented_ragged_fused_gather_score",
    "ragged_blocks",
    "ragged_split",
    "ragged_fused_gather_score_split",
    "flash_attention",
    "flash_schedule",
    "flash_attention_tiled",
    "take",
    "embedding_bag_bags",
    "embedding_bag_error_bound",
    "bag_sort",
    "bag_sort_plan",
    "bag_csr",
    "embedding_bag_bags_backward",
    "embedding_bag_backward_error_bound",
    "embedding_bag",
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
    from repro_torch.core.quantization import unpack_codes  # core's package imports kernels
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
    from repro_torch.core.quantization import unpack_codes  # core's package imports kernels
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


ROWS_PER_CHUNK = 32  # rows a warp of the scoring kernels takes per step


def score_blocks_per_token(n_q: int, resident: int, rows: int | None = None) -> int:
    """Blocks per query token of ``csrc/selective_sum.cu`` and
    ``csrc/fused_gather_score.cu`` (``score_rows::blocks_per_token``): as
    many as fill the card's ``resident`` blocks in one wave, at least 1;
    selective_sum also takes no more than its ``rows`` make chunks of 32."""
    s = max(1, resident // max(n_q, 1))
    if rows is not None:
        s = min(s, -(-rows // ROWS_PER_CHUNK))
    return s


def score_split(
    sizes: torch.Tensor, cap: int, blocks: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The work split of ``csrc/fused_gather_score.cu``: which block scores
    which slot of the [Q, P, cap] grid and which zeroes it.

    Token q's probed rows are flattened in probe order: with m[p] =
    min(max(sizes[q, p], 0), cap) and pre[p] its prefix sums, flat row f
    is slot c = f - pre[p] of the probe p with pre[p] <= f < pre[p + 1]
    (the largest p with pre[p] <= f). The T = pre[P] rows split into
    ``blocks`` ranges, block s taking [T*s // blocks, T*(s+1) // blocks).
    The zero tails flatten alike: tail slot z of probe p starts at
    p * cap - pre[p] and is slot m[p] + z - (p * cap - pre[p]); the P*cap
    - T of them split into ``blocks`` ranges the same way.

    Returns (scored, zeroed), int64 [*, 4] rows of (q, s, p, c)."""
    qm, p = sizes.shape
    m = sizes.long().clamp(0, cap)
    pre = torch.zeros((qm, p + 1), dtype=torch.long)
    pre[:, 1:] = m.cumsum(1)
    parts: tuple[list, list] = ([], [])
    for q in range(qm):
        total = int(pre[q, p])
        tail_start = torch.arange(p) * cap - pre[q, :p]
        for kind, n, key, slot in (
            (0, total, pre[q, :p], lambda f, pp: f - pre[q, pp]),
            (1, p * cap - total, tail_start, lambda z, pp: m[q, pp] + z - tail_start[pp]),
        ):
            f = torch.arange(n)
            bounds = torch.tensor([n * s // blocks for s in range(blocks + 1)])
            blk = torch.searchsorted(bounds, f, right=True) - 1
            pp = torch.searchsorted(key, f, right=True) - 1
            parts[kind].append(torch.stack([torch.full_like(f, q), blk, pp, slot(f, pp)], 1))
    return tuple(
        torch.cat(x) if x else torch.zeros((0, 4), dtype=torch.long) for x in parts
    )


def fused_gather_score_split(
    packed_codes: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    probe_scores: torch.Tensor,
    v: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    cap: int,
    blocks: int,
) -> torch.Tensor:
    """``fused_gather_score`` computed the way ``csrc/fused_gather_score.cu``
    splits it (``score_split``): each block's flat rows scored, each
    block's tail slots zeroed, every other slot left NaN. A row outside
    [0, n_tokens) scores 0, as in the kernel."""
    qm, p = starts.shape
    n = packed_codes.shape[0]
    scored, zeroed = score_split(sizes.cpu(), cap, blocks)
    scored, zeroed = scored.to(packed_codes.device), zeroed.to(packed_codes.device)
    out = torch.full((qm, p, cap), math.nan, dtype=torch.float32, device=packed_codes.device)
    q, pp, c = scored[:, 0], scored[:, 2], scored[:, 3]
    row = starts.long()[q, pp] + c
    ok = (row >= 0) & (row < n)
    s = ragged_selective_sum(
        packed_codes[row.clamp(0, max(n - 1, 0))], q, v, nbits=nbits, dim=dim
    )
    out[q, pp, c] = torch.where(ok, s + probe_scores.float()[q, pp], 0.0)
    out[zeroed[:, 0], zeroed[:, 2], zeroed[:, 3]] = 0.0
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
    """packed_codes u8[N, PB], worklist row0/nvalid/qtok i32[W] + pscore
    f32[W], v f32[Q, D, 2^b] -> f32[W * tile_c]: slot (w, c) is
    ``pscore[w] + sum_d v[qtok[w], d, code_d]`` of row ``row0[w] + c``
    when ``c < nvalid[w]`` and exactly 0 otherwise."""
    from repro_torch.core.worklist import TileWorklist, per_slot, worklist_slot_positions
    wl = TileWorklist(row0=row0, nvalid=nvalid, qtok=qtok, pscore=pscore)
    pos, valid = worklist_slot_positions(
        wl, tile_c=tile_c, n_tokens=packed_codes.shape[0]
    )
    gathered = packed_codes[pos]  # [W * tile_c, PB]
    qtok_slot = per_slot(qtok, tile_c)
    scores = ragged_selective_sum(gathered, qtok_slot, v, nbits=nbits, dim=dim)
    scores = scores + per_slot(pscore.float(), tile_c)
    return torch.where(valid, scores, 0.0)


def staged_row_sink(rows: torch.Tensor) -> torch.Tensor:
    """rows u8[M, B] -> f32[M]: what the fused kernels' "dma" carve-out
    reads out of each staged row in place of its score
    (``score_rows::sink_staged``): the XOR of its little-endian 32-bit
    words over its whole 16-byte units, then of its remaining bytes, the
    upper half folded onto the lower, as a float."""
    m, b = rows.shape
    full = b >> 4 << 4
    words = rows[:, :full].contiguous().view(torch.int32)
    x = torch.zeros(m, dtype=torch.int32, device=rows.device)
    for k in range(words.shape[1]):
        x ^= words[:, k]
    for j in range(full, b):
        x ^= rows[:, j].int()
    return ((x ^ (x >> 16)) & 0xFFFF).float()


def _sink_chain(rows, base, *, nbits: int, dim: int, dims_per_chunk: int):
    """rows u8[..., PB], base f32 broadcast to rows' leading shape -> the
    "dma" carve-out's sum: the first v-table chunk's sink plus ``base``,
    then each further chunk's sink added, in the kernel's order."""
    lead = rows.shape[:-1]
    acc = None
    for d0 in range(0, dim, dims_per_chunk):
        b0, b1 = d0 * nbits // 8, min(dim, d0 + dims_per_chunk) * nbits // 8
        s = staged_row_sink(rows[..., b0:b1].reshape(-1, b1 - b0)).reshape(lead)
        acc = s + base if acc is None else acc + s
    return acc


def fused_gather_score_dma(
    packed_codes: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    probe_scores: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    cap: int,
    dims_per_chunk: int,
) -> torch.Tensor:
    """What ``csrc/fused_gather_score.cu`` returns at probe "dma", bit for
    bit: ``fused_gather_score`` with each row's score replaced by its
    ``staged_row_sink`` per v-table chunk of ``dims_per_chunk`` dims
    (``_build.vtable_chunk``); the tails and rows outside [0, N) exactly 0.
    A slot holds it only if its row was staged."""
    n = packed_codes.shape[0]
    lane = torch.arange(cap, device=packed_codes.device)
    row = starts.long().unsqueeze(-1) + lane
    valid = (lane < sizes.long().clamp(0, cap).unsqueeze(-1)) & (row >= 0) & (row < n)
    acc = _sink_chain(
        packed_codes[row.clamp(0, max(n - 1, 0))], probe_scores.float().unsqueeze(-1),
        nbits=nbits, dim=dim, dims_per_chunk=dims_per_chunk,
    )
    return torch.where(valid, acc, 0.0)


def ragged_fused_gather_score_dma(
    packed_codes: torch.Tensor,
    row0: torch.Tensor,
    nvalid: torch.Tensor,
    qtok: torch.Tensor,
    pscore: torch.Tensor,
    *,
    nbits: int,
    dim: int,
    tile_c: int,
    n_q: int,
    dims_per_chunk: int,
) -> torch.Tensor:
    """What ``csrc/ragged_fused_gather_score.cu`` returns at probe "dma",
    bit for bit, as ``fused_gather_score_dma`` for the worklist form
    (``n_q`` query tokens: a tile of another token stages nothing); invalid
    slots and padding tiles exactly 0."""
    n = packed_codes.shape[0]
    lane = torch.arange(tile_c, device=packed_codes.device)
    ok = (qtok >= 0) & (qtok < n_q)
    m = torch.where(ok, nvalid.long().clamp(0, tile_c), 0)
    row = row0.long().unsqueeze(-1) + lane
    valid = (lane < m.unsqueeze(-1)) & (row >= 0) & (row < n)
    acc = _sink_chain(
        packed_codes[row.clamp(0, max(n - 1, 0))], pscore.float().unsqueeze(-1),
        nbits=nbits, dim=dim, dims_per_chunk=dims_per_chunk,
    )
    return torch.where(valid, acc, 0.0).reshape(-1)


def segmented_ragged_gather_codes(
    packed_list, row0: torch.Tensor, nvalid: torch.Tensor, seg: torch.Tensor, *, tile_c: int
):
    """A segmented worklist's code rows as one flat copy: ``packed_list``
    holds each segment's u8[N_s, PB] codes, ``row0`` is segment-local and
    ``seg`` names the segment. Per segment the slot positions are clamped
    into that segment's rows (floor 0) -> (codes u8[W * tile_c, PB],
    valid bool[W * tile_c])."""
    w = row0.shape[0]
    pb = packed_list[0].shape[1]
    lane = torch.arange(tile_c, dtype=torch.long, device=row0.device)
    pos = row0.long().unsqueeze(-1) + lane  # [W, tile_c] segment-local
    valid = lane < nvalid.long().unsqueeze(-1)
    gathered = torch.zeros((w, tile_c, pb), dtype=torch.uint8, device=row0.device)
    for s, codes in enumerate(packed_list):
        n_s = codes.shape[0]
        if n_s == 0:
            continue  # an empty segment owns no worklist entries
        own = (seg == s).view(w, 1, 1)
        gathered = torch.where(own, codes[pos.clamp(0, n_s - 1)], gathered)
    return gathered.reshape(w * tile_c, pb), valid.reshape(-1)


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
    """``ragged_fused_gather_score`` over a worklist spanning segments:
    slot (w, c) is ``pscore[w] + sum_d v[qtok[w], d, code_d]`` of row
    ``row0[w] + c`` of segment ``seg[w]`` when ``c < nvalid[w]`` and
    exactly 0 otherwise -> f32[W * tile_c]."""
    from repro_torch.core.worklist import per_slot
    gathered, valid = segmented_ragged_gather_codes(
        packed_list, row0, nvalid, seg, tile_c=tile_c
    )
    scores = ragged_selective_sum(gathered, per_slot(qtok, tile_c), v, nbits=nbits, dim=dim)
    scores = scores + per_slot(pscore.float(), tile_c)
    return torch.where(valid, scores, 0.0)


RAGGED_MAX_TILES = 128  # tiles one block of the ragged kernel takes at most
RAGGED_TILES_PER_BLOCK = 32  # its blocks: one per this many tiles ...
RAGGED_OVERSUBSCRIBE = 2  # ... up to this many per block the card holds at once


def ragged_blocks(n_tiles: int, resident: int) -> int:
    """Blocks of ``csrc/ragged_fused_gather_score.cu``'s launch
    (``ragged_blocks`` there): one per ``RAGGED_TILES_PER_BLOCK`` tiles,
    but no fewer than the card's ``resident`` blocks and no more than
    ``RAGGED_OVERSUBSCRIBE`` times them; at least enough that no block
    takes more than ``RAGGED_MAX_TILES`` tiles, at most one per tile, at
    least 1."""
    s = -(-n_tiles // RAGGED_TILES_PER_BLOCK)
    s = max(resident, min(s, RAGGED_OVERSUBSCRIBE * resident))
    s = max(s, -(-n_tiles // RAGGED_MAX_TILES))
    return max(1, min(s, n_tiles))


def ragged_split(
    nvalid: torch.Tensor, qtok: torch.Tensor, *, n_q: int, tile_c: int, blocks: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The work split of ``csrc/ragged_fused_gather_score.cu``: which block
    scores which slot of the flat [W * tile_c] output, under which v-table
    load, and which block zeroes it.

    Block s takes tiles [W*s // blocks, W*(s+1) // blocks). A tile's valid
    slots are m = min(max(nvalid, 0), tile_c), or 0 where qtok lies outside
    [0, n_q); with pre[t] their prefix sums over the block's tiles, flat row
    f is slot f - pre[t] of the tile t with pre[t] <= f < pre[t + 1] (the
    largest t with pre[t] <= f). The block walks runs: from the next tile
    with valid slots, the tiles that follow while each has none or the same
    qtok; one v-table load each. Every slot c >= m of its tiles it zeroes.

    Returns (scored [*, 4] rows of (s, w, c, run), zeroed [*, 3] rows of
    (s, w, c), runs [*, 4] rows of (s, first tile, end tile, qtok)), int64,
    the runs in the order the blocks walk them."""
    w_all = nvalid.numel()
    qt = qtok.long().cpu()
    m = torch.where((qt >= 0) & (qt < n_q), nvalid.long().cpu().clamp(0, tile_c), 0)
    scored, zeroed, runs = [], [], []
    lane = torch.arange(tile_c)
    for s in range(blocks):
        t0, t1 = w_all * s // blocks, w_all * (s + 1) // blocks
        mm = m[t0:t1]
        pre = torch.zeros(t1 - t0 + 1, dtype=torch.long)
        pre[1:] = mm.cumsum(0)
        ml, ql = mm.tolist(), qt[t0:t1].tolist()
        ta, nt = 0, t1 - t0
        while True:
            while ta < nt and ml[ta] == 0:
                ta += 1
            if ta == nt:
                break
            tb = ta + 1
            while tb < nt and (ml[tb] == 0 or ql[tb] == ql[ta]):
                tb += 1
            f = torch.arange(int(pre[ta]), int(pre[tb]))
            t = torch.searchsorted(pre[:nt], f, right=True) - 1
            scored.append(torch.stack(
                [torch.full_like(f, s), t0 + t, f - pre[t], torch.full_like(f, len(runs))], 1
            ))
            runs.append((s, t0 + ta, t0 + tb, ql[ta]))
            ta = tb
        tt, cc = torch.nonzero(lane >= mm.unsqueeze(-1), as_tuple=True)
        zeroed.append(torch.stack([torch.full_like(tt, s), t0 + tt, cc], 1))
    empty = torch.zeros((0, 4), dtype=torch.long)
    return (
        torch.cat(scored) if scored else empty,
        torch.cat(zeroed) if zeroed else empty[:, :3],
        torch.tensor(runs, dtype=torch.long).reshape(-1, 4),
    )


def ragged_fused_gather_score_split(
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
    blocks: int,
    dims_per_chunk: int | None = None,
) -> torch.Tensor:
    """``ragged_fused_gather_score`` computed the way
    ``csrc/ragged_fused_gather_score.cu`` splits it (``ragged_split``):
    each run's rows scored against its token's v-table ``dims_per_chunk``
    dims at a time (all D by default), the first chunk writing partial sum
    plus pscore and later ones adding; each block's invalid slots zeroed;
    every other slot left NaN. A row outside [0, n_tokens) scores 0, as in
    the kernel."""
    n = packed_codes.shape[0]
    dev = packed_codes.device
    scored, zeroed, _ = ragged_split(
        nvalid, qtok, n_q=v.shape[0], tile_c=tile_c, blocks=blocks
    )
    w, c = scored[:, 1].to(dev), scored[:, 2].to(dev)
    out = torch.full((nvalid.numel() * tile_c,), math.nan, dtype=torch.float32, device=dev)
    row = row0.long()[w] + c
    ok = (row >= 0) & (row < n)
    rows = packed_codes[row.clamp(0, max(n - 1, 0))]
    q = qtok.long()[w]
    slot = w * tile_c + c
    dc, per_byte = dims_per_chunk or dim, 8 // nbits
    for d0 in range(0, dim, dc):
        nd = min(dc, dim - d0)
        part = ragged_selective_sum(
            rows[:, d0 // per_byte : (d0 + nd) // per_byte], q, v[:, d0 : d0 + nd],
            nbits=nbits, dim=nd,
        )
        if d0 == 0:
            out[slot] = torch.where(ok, part + pscore.float()[w], 0.0)
        else:
            out[slot] = torch.where(ok, out[slot] + part, out[slot])
    out[zeroed[:, 1].to(dev) * tile_c + zeroed[:, 2].to(dev)] = 0.0
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    tk: int = 128,
) -> torch.Tensor:
    """q [B, H, Sq, Dh], k/v [B, Hkv, Skv, Dh] (Hkv | H; head h reads kv
    head h // (H / Hkv)) -> [B, H, Sq, Dh] in ``q.dtype``.

    The TPU kernel's recurrence, block by block over ``tk`` keys: float32
    scores scaled by 1/sqrt(Dh), masked to -1e30 where ``rel = q_pos -
    k_pos`` breaks ``rel >= 0`` (causal) or ``rel < window``, running
    (max, sum, acc) in float32, ``acc / max(sum, 1e-30)``. Positions are
    absolute indices into the arrays."""
    b, h, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, hkv, rep * sq, dh)  # the heads sharing a kv head, stacked
    q_pos = torch.arange(sq, device=q.device).unsqueeze(-1)
    m = l = acc = None
    for k0 in range(0, skv, tk):
        kb = k[:, :, k0 : k0 + tk].float()  # [B, Hkv, T, Dh]
        vb = v[:, :, k0 : k0 + tk].float()
        t = kb.shape[2]
        s = (qf @ kb.transpose(-1, -2)).reshape(b, hkv, rep, sq, t) * scale
        rel = q_pos - torch.arange(k0, k0 + t, device=q.device)
        mask = torch.ones_like(rel, dtype=torch.bool)
        if causal:
            mask &= rel >= 0
        if window is not None:
            mask &= rel < window
        s = torch.where(mask, s, -1e30)
        m_blk = s.amax(-1)
        p = torch.exp(s - m_blk.unsqueeze(-1))
        l_blk = p.sum(-1)
        acc_blk = (p.reshape(b, hkv, rep * sq, t) @ vb).reshape(b, hkv, rep, sq, dh)
        if m is None:
            m, l, acc = m_blk, l_blk, acc_blk
            continue
        m_tot = torch.maximum(m, m_blk)
        a_prev, a_blk = torch.exp(m - m_tot), torch.exp(m_blk - m_tot)
        m = m_tot
        l = l * a_prev + l_blk * a_blk
        acc = acc * a_prev.unsqueeze(-1) + acc_blk * a_blk.unsqueeze(-1)
    out = acc / l.clamp_min(1e-30).unsqueeze(-1)
    return out.reshape(b, h, sq, dh).to(q.dtype)


def flash_schedule(
    sq: int, skv: int, *, causal: bool, window: int | None, bq: int, bk: int
) -> list[tuple[int, int, int, int, int]]:
    """The bf16 flash kernel's schedule (``tile_range`` and the block order
    of ``csrc/flash_attention.cu``): for each q-block of ``bq`` rows, in the
    order the kernel starts them, ``(qb, t_lo, t_hi, m_lo, m_hi)``. The
    block visits kv tiles ``t_lo..t_hi`` of ``bk`` keys and applies the
    mask on tile t only where ``t < m_lo`` (a key the window hides from one
    of its rows) or ``t >= m_hi`` (a key after one of its rows under the
    causal mask, or at or past Skv).

    Tiles are skipped only when every row has a valid key (Sq <= Skv and
    window != 0); otherwise a block visits every tile, since a row with no
    valid key averages v over all of them. Blocks start heaviest first:
    the last q-blocks first under the causal mask, the first ones
    otherwise."""
    w = -1 if window is None else max(int(window), 0)
    nqb, nt = -(-sq // bq), -(-skv // bk)
    skip = sq <= skv and w != 0
    out = []
    for qb in (range(nqb - 1, -1, -1) if causal else range(nqb)):
        q0 = qb * bq
        q_last = min(q0 + bq, sq) - 1
        t_lo, t_hi = 0, nt - 1
        if skip:
            if w >= 0:
                t_lo = max(0, q0 - w + 1) // bk
            if causal:
                t_hi = min(t_hi, q_last // bk)
        m_lo = (q_last - w) // bk + 1 if 0 <= w <= q_last else 0
        m_hi = skv // bk if skv % bk else nt
        if causal:
            m_hi = min(m_hi, (q0 + 1) // bk)
        out.append((qb, t_lo, t_hi, m_lo, m_hi))
    return out


def flash_attention_tiled(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    bq: int,
    bk: int,
) -> torch.Tensor:
    """The bf16 flash kernel's algorithm, plainly: each q-block visits the
    kv tiles ``flash_schedule`` gives it and masks only the flagged ones
    (-1e30, keys past Skv dropped), with the recurrence in base 2 (scores
    scaled by log2(e)/sqrt(Dh), ``exp2``). Same shapes and function as
    ``flash_attention``; float32 sums."""
    b, h, sq, dh = q.shape
    rep = h // k.shape[1]
    skv = k.shape[2]
    c = math.log2(math.e) / math.sqrt(dh)
    kf, vf = (t.float().repeat_interleave(rep, dim=1) for t in (k, v))
    out = torch.empty(b, h, sq, dh, dtype=torch.float32, device=q.device)
    for qb, t_lo, t_hi, m_lo, m_hi in flash_schedule(
        sq, skv, causal=causal, window=window, bq=bq, bk=bk
    ):
        rows = torch.arange(qb * bq, min(qb * bq + bq, sq), device=q.device)
        qf = q[:, :, rows].float()
        m = torch.full((b, h, rows.numel()), -math.inf, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h, rows.numel(), dh, device=q.device)
        for t in range(t_lo, t_hi + 1):
            keys = torch.arange(t * bk, min(t * bk + bk, skv), device=q.device)
            s = (qf @ kf[:, :, keys].transpose(-1, -2)) * c
            if t < m_lo or t >= m_hi:
                rel = rows.unsqueeze(-1) - keys
                mask = torch.ones_like(rel, dtype=torch.bool)
                if causal:
                    mask &= rel >= 0
                if window is not None:
                    mask &= rel < max(int(window), 0)
                s = torch.where(mask, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new.unsqueeze(-1))
            l = l * alpha + p.sum(-1)
            acc = acc * alpha.unsqueeze(-1) + p @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / l.clamp_min(1e-30).unsqueeze(-1)
    return out.to(q.dtype)


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, idx, axis=0)`` in its default fill mode: an index
    in [-V, 0) wraps to ``idx + V``; one outside [-V, V) gives a row of
    NaN. -> [*idx.shape, *table.shape[1:]]."""
    v = table.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + v, idx)
    valid = (idx >= 0) & (idx < v)
    rows = table[idx.clamp(0, max(v - 1, 0))]
    return rows.masked_fill_(~valid.reshape(*valid.shape, *[1] * (table.dim() - 1)), math.nan)


def _bag_terms(table, bag_indices, bag_weights):
    """(rows [S, L] clamped into the table, weights [S, L] float32 set to 0
    where the index lies outside [0, V))."""
    v = table.shape[0]
    idx = bag_indices.long()
    w = torch.where((idx >= 0) & (idx < v), bag_weights.float(), 0.0)
    return idx.clamp(0, max(v - 1, 0)), w


def embedding_bag_bags(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """table f32[V, D], bag_indices int[S, L], bag_weights f32[S, L] ->
    f32[S, D], out[s] = sum_l w[s, l] * table[idx[s, l]], summed in index
    order. As in the TPU kernel, an index outside [0, V) (negative ones
    included) contributes exactly 0: the index is clamped into the table
    and its weight masked to 0, so nothing reads out of range."""
    rows, w = _bag_terms(table, bag_indices, bag_weights)
    out = torch.zeros((rows.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for j in range(rows.shape[1]):
        out.addcmul_(table[rows[:, j]].float(), w[:, j : j + 1])
    return out


def embedding_bag_error_bound(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """f32[S, D]: how far two float32 sums of one bag's terms, taken in
    different orders (or with and without fused multiply-adds), may lie
    apart per element: (L + 1) * 2^-24 * sum_l |w_l| * |table[idx_l]| +
    1e-7, over the indices in [0, V)."""
    rows, w = _bag_terms(table, bag_indices, bag_weights)
    out = torch.zeros((rows.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    for j in range(rows.shape[1]):
        out.addcmul_(table[rows[:, j]].float().abs(), w[:, j : j + 1].abs())
    return out.mul_((rows.shape[1] + 1) * 2.0**-24).add_(1e-7)


def bag_sort(bag_indices: torch.Tensor, v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bag backward kernel's index preparation: the flattened ids as
    int64 keys (V for an index outside [0, V)), stably sorted -> (keys,
    their flat positions s * L + l), int64 [S * L]. Each table row's
    contributions then form one run, in increasing position."""
    flat = bag_indices.reshape(-1).long()
    key = torch.where((flat >= 0) & (flat < v), flat, v)
    return torch.sort(key, stable=True)


# The bag backward's sort (csrc/embedding_bag.cu): keys per block, and the
# widest digit of one pass.
BAG_SORT_TILE = 2048
BAG_SORT_DIGIT_BITS = 8


def bag_sort_plan(n: int, v: int) -> tuple[int, int, int]:
    """The bag backward kernel's sort of ``n`` keys in [0, V], V >= 1 (twin
    of ``sort_plan`` in ``csrc/embedding_bag.cu``): (passes, digit bits,
    tiles). The passes of at most ``BAG_SORT_DIGIT_BITS`` bits, all of one
    width, cover bit_length(V) bits; a tile is ``BAG_SORT_TILE`` keys."""
    bits = max(int(v).bit_length(), 1)
    passes = -(-bits // BAG_SORT_DIGIT_BITS)
    return passes, -(-bits // passes), -(-n // BAG_SORT_TILE)


def bag_csr(bag_indices: torch.Tensor, v: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The bag backward kernel's index preparation as rows: (offsets
    int64 [V + 1], positions int64 [n]). ``positions`` are the flat
    positions s * L + l of the ids in [0, V), grouped by id in increasing
    id and, within an id, in increasing position (``bag_sort``'s positions
    of keys below V); ``offsets[r]`` is the number of those ids below r,
    so row r's contributions are positions[offsets[r]:offsets[r + 1]]."""
    key, pos = bag_sort(bag_indices, v)
    offsets = torch.searchsorted(key, torch.arange(v + 1, device=key.device))
    return offsets, pos[: int(offsets[-1])]


def embedding_bag_bags_backward(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor,
    grad: torch.Tensor, *, table_grad: bool = True, weights_grad: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradient of ``embedding_bag_bags`` given grad = dout f32[S, D]:
    (dtable f32[V, D] dense, dtable[v] = sum over (s, l) with idx[s, l] = v
    of w[s, l] * grad[s], by ``index_add_``; dw f32[S, L], dw[s, l] =
    <table[idx[s, l]], grad[s]>, 0 for an index outside [0, V)), each None
    where not asked for. The ids take no gradient."""
    rows, w = _bag_terms(table, bag_indices, bag_weights)
    g = grad.float()
    s, l = rows.shape
    dtable = dw = None
    if table_grad:
        dtable = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
        terms = w.reshape(-1, 1) * g.repeat_interleave(l, dim=0)
        dtable.index_add_(0, rows.reshape(-1), terms)
    if weights_grad:
        valid = (bag_indices >= 0) & (bag_indices < table.shape[0])
        dots = torch.sum(table[rows].float() * g.unsqueeze(1), dim=-1)
        dw = torch.where(valid, dots, 0.0)
    return dtable, dw


def embedding_bag_backward_error_bound(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor, grad: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """How far two float32 evaluations of the bag's gradients, summed in
    different orders, may lie apart per element: dtable (n + 1) * 2^-24 *
    sum |w * grad| + 1e-7 over a row's n contributions; dw (D + 1) * 2^-24 *
    sum_d |row_d * grad_d| + 1e-7."""
    rows, w = _bag_terms(table, bag_indices, bag_weights)
    g = grad.float().abs()
    s, l = rows.shape
    flat = rows.reshape(-1)
    valid = ((bag_indices >= 0) & (bag_indices < table.shape[0])).reshape(-1)
    count = torch.zeros(table.shape[0], dtype=torch.float32, device=table.device)
    count.index_add_(0, flat, valid.float())
    mass = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    mass.index_add_(0, flat, w.abs().reshape(-1, 1) * g.repeat_interleave(l, dim=0))
    dtable = mass.mul_(((count + 1) * 2.0**-24).unsqueeze(-1)).add_(1e-7)
    dots = torch.sum(table[rows].float().abs() * g.unsqueeze(1), dim=-1)
    dw = dots.mul_((table.shape[1] + 1) * 2.0**-24).add_(1e-7)
    return dtable, dw


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    segment_ids: torch.Tensor,
    *,
    num_segments: int,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """EmbeddingBag(sum), flat form: out[s] = sum_{i: seg[i] == s} w[i] *
    table[idx[i]] -> [num_segments, D]. Segment ids need not be sorted; one
    outside [0, num_segments) is dropped, as ``jax.ops.segment_sum`` drops
    it. Rows are gathered with ``take``'s semantics."""
    rows = take(table, indices)
    if weights is not None:
        rows = rows * weights.unsqueeze(-1)
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    out = torch.zeros((num_segments, *table.shape[1:]), dtype=rows.dtype, device=table.device)
    return out.index_add_(0, seg[keep], rows[keep])
