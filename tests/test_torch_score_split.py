"""The dense fused kernel's work split, on the CPU.

``csrc/fused_gather_score.cu`` flattens each query token's probed rows
(the prefix sums of min(sizes, cap)) and its zero tails, splits both into
equal ranges over S blocks, and maps a flat index back to its (probe,
slot). ``ref.score_split`` is the Python twin of that index math; here it
is held against a brute-force scan of the [Q, P, cap] grid: every valid
slot scored by exactly one block, no invalid slot scored, every tail slot
zeroed exactly once, each block's ranges contiguous and as equal as
integers allow. ``ref.fused_gather_score_split`` (the output built block
by block, every unwritten slot NaN) must equal ``ref.fused_gather_score``
and JAX's ``fused_gather_score_kernel_call`` in interpret mode with
``buffering="double"``, rtol = atol = 1e-4 (float32 sums in another
order). The kernel itself runs only on the card
(``tests/test_torch_kernels_cuda.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_score_split.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_gather_score import fused_gather_score_kernel_call
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-4, atol=1e-4)


def _sizes(kind: str, q: int, p: int, cap: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((q, p), np.int32)
    if kind == "one":
        return np.ones((q, p), np.int32)
    if kind == "over_cap":
        return rng.integers(cap + 1, 3 * cap, (q, p)).astype(np.int32)
    if kind == "all_cap":
        return np.full((q, p), cap, np.int32)
    if kind == "skew":  # one probe at cap, the rest 1
        s = np.ones((q, p), np.int32)
        s[np.arange(q), rng.integers(0, p, q)] = cap
        return s
    if kind == "mixed":  # 0, 1, in between, at and past cap
        return rng.integers(0, 2 * cap, (q, p)).astype(np.int32)
    raise ValueError(kind)


# name, sizes kind, Q, P, cap
CASES = [
    ("zero", "zero", 3, 4, 8),
    ("one", "one", 3, 4, 8),
    ("over_cap", "over_cap", 3, 4, 8),
    ("all_cap", "all_cap", 3, 4, 8),
    ("skew", "skew", 3, 6, 16),
    ("p1", "mixed", 3, 1, 16),
    ("p1_skew", "skew", 2, 1, 16),
    ("q1", "mixed", 1, 5, 16),
    ("q1_skew", "skew", 1, 7, 24),
    ("q128", "mixed", 128, 3, 8),
    ("q128_skew", "skew", 128, 4, 8),
    ("mixed", "mixed", 4, 9, 24),
]
BLOCKS = [1, 2, 3, 7, 1000]  # 1000: more blocks than any token has rows


def _brute(sizes: np.ndarray, cap: int):
    """The valid and the tail slots of the grid, by scanning it."""
    q, p, c = np.meshgrid(*map(np.arange, (*sizes.shape, cap)), indexing="ij")
    valid = c < np.clip(sizes, 0, cap)[..., None]
    slots = np.stack([q, p, c], -1)
    return {tuple(x) for x in slots[valid]}, {tuple(x) for x in slots[~valid]}


def _check_ranges(rows: np.ndarray, n_per_token: np.ndarray, blocks: int, flat_of) -> None:
    """Each block's share of a token's flat indices is the contiguous range
    [n*s // blocks, n*(s+1) // blocks): the block of every flat index is the
    last s whose range starts at or before it."""
    f = flat_of(rows)
    for qi, n in enumerate(n_per_token):
        mine = rows[:, 0] == qi
        np.testing.assert_array_equal(np.sort(f[mine]), np.arange(n))
        starts = np.arange(blocks + 1) * n // blocks
        want = np.searchsorted(starts, f[mine], side="right") - 1
        np.testing.assert_array_equal(rows[mine, 1], want)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("name,kind,q,p,cap", CASES)
def test_score_split_covers_each_slot_once(name, kind, q, p, cap, blocks):
    sizes = _sizes(kind, q, p, cap, seed=len(name) + q + p)
    scored, zeroed = (x.numpy() for x in tref.score_split(torch.from_numpy(sizes), cap, blocks))
    valid, tail = _brute(sizes, cap)

    got_scored = [tuple(x) for x in scored[:, [0, 2, 3]]]
    assert len(got_scored) == len(set(got_scored)), "a valid slot is scored twice"
    assert set(got_scored) == valid, "a valid slot is unscored or an invalid one scored"
    got_zeroed = [tuple(x) for x in zeroed[:, [0, 2, 3]]]
    assert len(got_zeroed) == len(set(got_zeroed)), "a tail slot is zeroed twice"
    assert set(got_zeroed) == tail, "a tail slot is left or a valid one zeroed"
    assert ((scored[:, 1] >= 0) & (scored[:, 1] < blocks)).all()
    assert ((zeroed[:, 1] >= 0) & (zeroed[:, 1] < blocks)).all()

    m = np.clip(sizes, 0, cap)
    pre = np.concatenate([np.zeros((q, 1), np.int64), m.cumsum(1)], 1)
    _check_ranges(scored, pre[:, -1], blocks, lambda r: pre[r[:, 0], r[:, 2]] + r[:, 3])
    _check_ranges(
        zeroed, p * cap - pre[:, -1], blocks,
        lambda r: r[:, 2] * cap - pre[r[:, 0], r[:, 2]] + r[:, 3] - m[r[:, 0], r[:, 2]],
    )


def _inputs(kind, q, p, cap, nbits, seed):
    rng = np.random.default_rng(seed)
    dim, n_tokens = 32, 4 * cap + 3
    sizes = _sizes(kind, q, p, cap, seed)
    starts = rng.integers(0, n_tokens - cap + 1, (q, p)).astype(np.int32)
    codes = rng.integers(0, 256, (n_tokens, dim * nbits // 8), dtype=np.uint8)
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    v = rng.standard_normal((q, dim, 1 << nbits)).astype(np.float32)
    return codes, starts, sizes, pscore, v


@pytest.mark.parametrize("blocks", [1, 3, 1000])
@pytest.mark.parametrize("name,kind,q,p,cap", CASES)
def test_split_output_matches_ref_and_pallas(name, kind, q, p, cap, blocks):
    args = _inputs(kind, q, p, cap, 4, seed=q * p + cap)
    kw = dict(nbits=4, dim=32, cap=cap)
    got = tref.fused_gather_score_split(*map(torch.from_numpy, args), **kw, blocks=blocks)
    assert not bool(torch.isnan(got).any()), "a slot no block wrote"
    want = tref.fused_gather_score(*map(torch.from_numpy, args), **kw)
    torch.testing.assert_close(got, want, **TOL)
    invalid = np.arange(cap) >= np.clip(args[2], 0, cap)[..., None]
    assert np.all(got.numpy()[invalid] == 0.0)
    if blocks != 3:
        return  # the split does not change what the Pallas kernel computes
    pallas = fused_gather_score_kernel_call(
        *map(jnp.asarray, args), nbits=4, dim=32, n_tokens=args[0].shape[0],
        cap_pad=cap, tile_c=8, buffering="double", interpret=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("nbits", [2, 8])
def test_split_output_other_widths(nbits):
    args = _inputs("mixed", 3, 5, 16, nbits, seed=nbits)
    kw = dict(nbits=nbits, dim=32, cap=16)
    got = tref.fused_gather_score_split(*map(torch.from_numpy, args), **kw, blocks=4)
    torch.testing.assert_close(got, tref.fused_gather_score(*map(torch.from_numpy, args), **kw), **TOL)


def test_split_rows_outside_the_index_score_zero():
    """A row outside [0, n_tokens) is not loaded and its slot is 0, as in
    the kernel (a well-formed CSR never yields one)."""
    codes, starts, sizes, pscore, v = _inputs("all_cap", 2, 3, 8, 4, seed=1)
    starts[0, 1], starts[1, 2] = -3, codes.shape[0] - 5
    got = tref.fused_gather_score_split(
        *map(torch.from_numpy, (codes, starts, sizes, pscore, v)),
        nbits=4, dim=32, cap=8, blocks=2,
    ).numpy()
    assert np.all(got[0, 1, :3] == 0.0) and np.all(got[0, 1, 3:] != 0.0)
    assert np.all(got[1, 2, 5:] == 0.0) and np.all(got[1, 2, :5] != 0.0)


@pytest.mark.parametrize(
    "n_q,resident,rows,want",
    [
        (32, 396, None, 12),  # three 256-thread blocks an SM on 132 SMs
        (128, 396, None, 3),
        (1, 396, None, 396),
        (500, 396, None, 1),  # more tokens than the card holds blocks
        (32, 396, 32768, 12),
        (32, 396, 100, 4),  # selective_sum: no more blocks than chunks of 32
        (3, 396, 1, 1),
    ],
)
def test_score_blocks_per_token(n_q, resident, rows, want):
    assert tref.score_blocks_per_token(n_q, resident, rows) == want


@pytest.mark.parametrize(
    "dim,nbits,extra,chunks",
    [
        (128, 4, 0, 1),  # the path: 8 KiB of table
        (128, 8, 4 * (3 * 32 + 1), 1),  # 128 KiB of table beside one warp's ring
        (200, 8, 0, 1),
        (224, 8, 0, 2),  # the table fits a block alone, not beside one warp's ring
        (220, 8, 4 * (3 * 4096 + 1), 2),  # nor beside the probe arrays of 4096 probes
        (256, 8, 0, 2),
        (256, 8, 4 * (4 * 128 + 1), 2),  # the ragged kernel's tile arrays
        (1000, 8, 0, 6),
    ],
)
def test_require_ring(dim, nbits, extra, chunks):
    """The scoring kernels' v-table chunk (_build.vtable_chunk, the twin of
    score_rows::dims_per_chunk): the whole table where it, ``extra`` bytes
    and one warp's ring of staged rows fit one block's shared memory, else
    the fewest chunks of whole 16-byte row pieces that do. One chunk at D
    128 (the path's code is unchanged there), two or more from D 208 at
    nbits 8; every chunk fits and one fewer would not."""
    from repro_torch.kernels import _build

    pb = dim * nbits // 8
    _build.require_codec(dim, nbits, pb)
    dc = _build.vtable_chunk(dim, nbits, extra)
    assert -(-dim // dc) == chunks
    unit = 128 // nbits
    assert dc == dim or dc % unit == 0
    assert _build._vtable_fits(dc, nbits, extra)
    if chunks > 1:
        per = -(-dim // (chunks - 1))
        smaller = -(-per // unit) * unit  # the chunk one fewer chunks would take
        assert not _build._vtable_fits(smaller, nbits, extra)
    assert _build.ring_row_stride(pb) % 32 == 16  # an odd number of 16-byte units


def test_vtable_chunk_refuses_what_cannot_fit():
    """Only per-block arrays that leave no room for one 16-byte unit of the
    table beside one warp's ring are refused (a probe count no path uses)."""
    from repro_torch.kernels import _build

    with pytest.raises(ValueError, match="staged rows"):
        _build.vtable_chunk(128, 8, 4 * (3 * 18000 + 1))
    assert _build.vtable_chunk(128, 4, 4 * (3 * 18500 + 1)) == 64  # nbits 4 chunks too
