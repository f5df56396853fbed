"""The ragged worklist kernel's work split, on the CPU.

``csrc/ragged_fused_gather_score.cu`` cuts the worklist's W tiles into S
equal contiguous ranges, one block each; a block prefix-sums its tiles'
valid slots (min(max(nvalid, 0), tile_c), 0 where qtok lies outside
[0, Q)), maps a flat row back to its (tile, slot) by the last prefix sum
at or below it, scores its rows in runs of one query token (one v-table
load each; tiles without valid rows join any run) and zeroes every other
slot of its tiles. ``ref.ragged_split`` is the Python twin of that index
math; here it is held against a brute-force scan of the worklist: every
valid slot scored by exactly one block, every invalid and padding slot
zeroed exactly once, each block's rows contiguous, each run's tiles of
one token and as few runs as the token sequence allows.
``ref.ragged_fused_gather_score_split`` (the output built block by block
and run by run, v-table chunk by chunk, every unwritten slot NaN) must
equal ``ref.ragged_fused_gather_score`` and JAX's
``ragged_fused_gather_score_kernel_call`` in interpret mode with
``buffering="double"``, rtol = atol = 1e-4 (float32 sums in another
order). Worklists with padding, batched worklists (each element's padding
between it and the next), tile_c 8/32/64, nbits 2/4/8, tokens in any
order. The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_ragged_split.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_gather_score import ragged_fused_gather_score_kernel_call
from repro_torch.core import worklist as wl
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-4, atol=1e-4)
DIM = 64


def _worklist(kind: str, tile: int, seed: int):
    """(row0, nvalid, qtok, pscore) int32/float32 [W] and the token count:
    ``padded`` one query's worklist with padding tiles after its real ones;
    ``batched`` three queries' worklists in one, qtok offset by query (the
    batched retrieve's layout); ``unsorted`` the padded one with its tiles
    shuffled; ``none`` no padding at all."""
    rng = np.random.default_rng(seed)
    b = 3 if kind == "batched" else 1
    n, p, cap, n_tokens = 5, 4, 3 * tile + 5, 8 * tile + 40
    sizes = rng.integers(0, cap + 1, (b, n, p)).astype(np.int32)
    sizes[rng.random((b, n, p)) < 0.25] = 1
    sizes[:, 0, 0], sizes[:, -1, -1] = cap, 0
    starts = rng.integers(0, n_tokens - cap + 1, (b, n, p)).astype(np.int32)
    pscore = rng.standard_normal((b, n, p)).astype(np.float32)
    need = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes, tile), amortized=False)
    slack = 0 if kind == "none" else 3
    if kind == "none":  # one token, so the bound is exactly its tiles
        sizes, starts, pscore = sizes[:, :1], starts[:, :1], pscore[:, :1]
        n = 1
        need = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes, tile), amortized=False)
    work = wl.build_tile_worklist(
        *map(torch.from_numpy, (starts, sizes, pscore)), tile_c=tile,
        tiles_per_qtoken=need + slack,
    )
    qtok = work.qtok + (torch.arange(b) * n).unsqueeze(-1).int()
    arrays = [a.reshape(-1).numpy().copy() for a in (work.row0, work.nvalid, qtok, work.pscore)]
    if kind == "unsorted":
        perm = rng.permutation(arrays[0].size)
        arrays = [a[perm] for a in arrays]
    return (*arrays, b * n, n_tokens)


def _inputs(kind, tile, nbits, seed):
    row0, nvalid, qtok, pscore, n_q, n_tokens = _worklist(kind, tile, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(0, 256, (n_tokens, DIM * nbits // 8), dtype=np.uint8)
    v = rng.standard_normal((n_q, DIM, 1 << nbits)).astype(np.float32)
    return codes, row0, nvalid, qtok, pscore, v


def _brute(nvalid, qtok, n_q, tile):
    """The valid and the invalid (w, c) slots of the worklist, by scanning."""
    m = np.where((qtok >= 0) & (qtok < n_q), np.clip(nvalid, 0, tile), 0)
    w, c = np.meshgrid(np.arange(nvalid.size), np.arange(tile), indexing="ij")
    valid = c < m[:, None]
    slots = np.stack([w, c], -1)
    return {tuple(x) for x in slots[valid]}, {tuple(x) for x in slots[~valid]}, m


KINDS = ["padded", "batched", "unsorted", "none"]
BLOCKS = [1, 2, 3, 7, 10**6]  # 10**6: capped at one block per tile


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("tile", [8, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_ragged_split_covers_each_slot_once(kind, tile, blocks):
    row0, nvalid, qtok, pscore, n_q, _ = _worklist(kind, tile, seed=len(kind) + tile)
    w_all = nvalid.size
    blocks = min(blocks, w_all)
    scored, zeroed, runs = (
        x.numpy() for x in tref.ragged_split(
            torch.from_numpy(nvalid), torch.from_numpy(qtok), n_q=n_q, tile_c=tile, blocks=blocks
        )
    )
    valid, invalid, m = _brute(nvalid, qtok, n_q, tile)

    got = [tuple(x) for x in scored[:, 1:3]]
    assert len(got) == len(set(got)), "a valid slot is scored twice"
    assert set(got) == valid, "a valid slot is unscored or an invalid one scored"
    got = [tuple(x) for x in zeroed[:, 1:3]]
    assert len(got) == len(set(got)), "a slot is zeroed twice"
    assert set(got) == invalid, "an invalid slot is left or a valid one zeroed"

    bounds = np.arange(blocks + 1) * w_all // blocks
    for rows in (scored, zeroed):  # each slot's block is the one whose tile range holds it
        np.testing.assert_array_equal(rows[:, 0], np.searchsorted(bounds, rows[:, 1], side="right") - 1)
    pre = np.concatenate([[0], np.cumsum(m)])
    for s in range(blocks):  # a block's rows in flat order, contiguous
        mine = scored[scored[:, 0] == s]
        flat = pre[mine[:, 1]] + mine[:, 2] - pre[bounds[s]]
        np.testing.assert_array_equal(flat, np.arange(pre[bounds[s + 1]] - pre[bounds[s]]))

    # Runs: each of one token, in the block's tile order, as few as the
    # sequence of its valid tiles' tokens allows.
    np.testing.assert_array_equal(runs[scored[:, 3], 3], qtok[scored[:, 1]])
    for s in range(blocks):
        mine = runs[runs[:, 0] == s]
        assert np.all(mine[1:, 1] == mine[:-1, 2]) and np.all(mine[:, 1] < mine[:, 2])
        toks = qtok[bounds[s] : bounds[s + 1]][m[bounds[s] : bounds[s + 1]] > 0]
        changes = int(np.count_nonzero(toks[1:] != toks[:-1])) + (toks.size > 0)
        assert len(mine) == changes
    if kind != "unsorted":  # token-major: a block's runs are its distinct tokens
        for s in range(blocks):
            toks = runs[runs[:, 0] == s, 3]
            assert len(toks) == len(set(toks.tolist()))


@pytest.mark.parametrize("blocks", [1, 3, 10**6])
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("tile", [8, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_ragged_split_output_matches_ref(kind, tile, nbits, blocks):
    args = _inputs(kind, tile, nbits, seed=tile + nbits)
    kw = dict(nbits=nbits, dim=DIM, tile_c=tile)
    targs = tuple(map(torch.from_numpy, args))
    got = tref.ragged_fused_gather_score_split(
        *targs, **kw, blocks=min(blocks, args[1].size)
    )
    assert not bool(torch.isnan(got).any()), "a slot no block wrote"
    want = tref.ragged_fused_gather_score(*targs, **kw)
    torch.testing.assert_close(got, want, **TOL)
    invalid = (np.arange(tile) >= args[2][:, None]).reshape(-1)
    assert np.all(got.numpy()[invalid] == 0.0)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_ragged_split_v_table_chunks(nbits):
    """The kernel's walk over dimension chunks (a v-table too wide for one
    block): partial sums added chunk by chunk equal the whole sum."""
    args = _inputs("batched", 16, nbits, seed=nbits)
    kw = dict(nbits=nbits, dim=DIM, tile_c=16)
    targs = tuple(map(torch.from_numpy, args))
    want = tref.ragged_fused_gather_score(*targs, **kw)
    for dc in (128 // nbits, 48 if nbits == 8 else 128 // nbits):
        got = tref.ragged_fused_gather_score_split(*targs, **kw, blocks=5, dims_per_chunk=dc)
        torch.testing.assert_close(got, want, **TOL)
    assert _build.vtable_chunk(256, 8, 4 * (4 * tref.RAGGED_MAX_TILES + 1)) == 128


@pytest.mark.parametrize(
    "kind,tile,nbits",
    [
        ("padded", 8, 4),
        ("batched", 32, 4),
        ("unsorted", 8, 2),
        ("padded", 64, 8),
        ("batched", 8, 8),
        ("none", 32, 2),
    ],
)
def test_ragged_split_output_matches_pallas(kind, tile, nbits):
    args = _inputs(kind, tile, nbits, seed=3 * tile + nbits)
    kw = dict(nbits=nbits, dim=DIM, tile_c=tile)
    got = tref.ragged_fused_gather_score_split(
        *map(torch.from_numpy, args), **kw, blocks=min(3, args[1].size)
    )
    pallas = ragged_fused_gather_score_kernel_call(
        *map(jnp.asarray, args), **kw, n_tokens=args[0].shape[0],
        buffering="double", interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("blocks", [1, 3, 10**6])
def test_ragged_split_tokens_outside_q_give_zeros(blocks):
    """A tile whose qtok lies outside [0, Q) has no valid slot: every slot
    zeroed once, none scored, the rest as if its nvalid were 0."""
    codes, row0, nvalid, qtok, pscore, v = _inputs("batched", 8, 4, seed=5)
    bad = np.flatnonzero(nvalid > 0)[::7]
    qtok_bad = qtok.copy()
    qtok_bad[bad[::2]], qtok_bad[bad[1::2]] = -1, v.shape[0] + 2
    blocks = min(blocks, nvalid.size)
    scored, zeroed, _ = tref.ragged_split(
        torch.from_numpy(nvalid), torch.from_numpy(qtok_bad), n_q=v.shape[0], tile_c=8,
        blocks=blocks,
    )
    valid, invalid, _ = _brute(nvalid, qtok_bad, v.shape[0], 8)
    assert {tuple(x) for x in scored[:, 1:3].tolist()} == valid and len(scored) == len(valid)
    assert {tuple(x) for x in zeroed[:, 1:3].tolist()} == invalid and len(zeroed) == len(invalid)
    got = tref.ragged_fused_gather_score_split(
        *map(torch.from_numpy, (codes, row0, nvalid, qtok_bad, pscore, v)),
        nbits=4, dim=DIM, tile_c=8, blocks=blocks,
    )
    nvalid_ok = nvalid.copy()
    nvalid_ok[bad] = 0
    want = tref.ragged_fused_gather_score(
        *map(torch.from_numpy, (codes, row0, nvalid_ok, qtok, pscore, v)),
        nbits=4, dim=DIM, tile_c=8,
    )
    torch.testing.assert_close(got, want, **TOL)
    assert not bool(got.reshape(-1, 8)[torch.from_numpy(bad)].any())


@pytest.mark.parametrize("blocks", [1, 4])
def test_ragged_split_rows_outside_the_index_score_zero(blocks):
    """A row outside [0, n_tokens) is not loaded and its slot is 0, as in
    the kernel (a well-formed worklist never yields one; the plain version
    and JAX clamp it instead)."""
    codes, row0, nvalid, qtok, pscore, v = _inputs("padded", 8, 4, seed=11)
    n = codes.shape[0]
    real = np.flatnonzero(nvalid == 8)[:3]
    row0[real] = (-3, n - 5, n + 2)
    got = tref.ragged_fused_gather_score_split(
        *map(torch.from_numpy, (codes, row0, nvalid, qtok, pscore, v)),
        nbits=4, dim=DIM, tile_c=8, blocks=blocks,
    ).numpy().reshape(-1, 8)
    assert np.all(got[real[0], :3] == 0.0) and np.all(got[real[0], 3:] != 0.0)
    assert np.all(got[real[1], 5:] == 0.0) and np.all(got[real[1], :5] != 0.0)
    assert np.all(got[real[2]] == 0.0)


@pytest.mark.parametrize(
    "n_tiles,resident,want",
    [
        (8192, 396, 396),  # the kernel phase's Q 32: one wave (~21 tiles a block)
        (32768, 396, 792),  # Q 128: two blocks per slot the card holds
        (65536, 396, 792),
        (20000, 396, 625),  # in between: one block per 32 tiles
        (500, 396, 396),
        (300, 396, 300),  # at most one block per tile
        (1, 396, 1),
        (10**6, 396, -(-(10**6) // 128)),  # at most 128 tiles a block
        (0, 396, 1),
    ],
)
def test_ragged_blocks(n_tiles, resident, want):
    assert tref.ragged_blocks(n_tiles, resident) == want
