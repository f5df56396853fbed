"""Port parity: WARP_SELECT and the tile worklists of ``repro_torch``
against the JAX package on the same numpy inputs (integers exact, floats
within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import warpselect as jws
from repro.core import worklist as jwl
from repro_torch.core import warpselect as tws
from repro_torch.core import worklist as twl

torch.set_num_threads(1)  # xdist runs one test process per core


def _select_inputs(seed, q=6, c=40, d=16):
    rng = np.random.default_rng(seed)
    qv = rng.standard_normal((q, d)).astype(np.float32)
    cent = rng.standard_normal((c, d)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=1, keepdims=True)
    sizes = rng.integers(0, 30, c).astype(np.int32)
    qmask = rng.random(q) > 0.3
    return qv, cent, sizes, qmask


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("t_prime", [5, 60, 10**6])
def test_warp_select_matches_jax(seed, t_prime):
    """t_prime=10**6 never crosses: mse falls back to the last retained
    score; masked tokens get mse 0 and still emit probes."""
    qv, cent, sizes, qmask = _select_inputs(seed)
    kw = dict(nprobe=4, t_prime=t_prime, k_impute=9)
    want = jws.warp_select(
        jnp.asarray(qv), jnp.asarray(cent), jnp.asarray(sizes),
        qmask=jnp.asarray(qmask), **kw,
    )
    got = tws.warp_select(
        torch.from_numpy(qv), torch.from_numpy(cent), torch.from_numpy(sizes),
        qmask=torch.from_numpy(qmask), **kw,
    )
    np.testing.assert_array_equal(got.probe_cids.numpy(), np.asarray(want.probe_cids))
    np.testing.assert_array_equal(got.probe_sizes.numpy(), np.asarray(want.probe_sizes))
    np.testing.assert_array_equal(got.top_sizes.numpy(), np.asarray(want.top_sizes))
    for f in ("probe_scores", "mse", "top_scores"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=1e-5, atol=1e-5
        )
    assert np.all(got.mse.numpy()[~qmask] == 0)
    if t_prime == 10**6:
        np.testing.assert_allclose(
            got.mse.numpy()[qmask], got.top_scores.numpy()[qmask, -1], rtol=0, atol=0
        )


def test_warp_select_batched_equals_per_query():
    qv, cent, sizes, qmask = _select_inputs(5)
    qb = np.stack([qv, qv[::-1].copy()])
    mb = np.stack([qmask, qmask[::-1].copy()])
    kw = dict(nprobe=5, t_prime=20, k_impute=8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    batched = tws.warp_select(t(qb), t(cent), t(sizes), qmask=t(mb), **kw)
    for i in range(2):
        one = tws.warp_select(t(qb[i]), t(cent), t(sizes), qmask=t(mb[i]), **kw)
        for a, b in zip(batched, one):
            assert torch.equal(a[i], b)


def test_topk_ties_break_toward_lower_index():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5]])
    vals, idx = tws.topk_lower_index_first(x, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]]
    # The cut falls inside a tie: the lower indices make it, as in lax.top_k.
    _, idx = tws.topk_lower_index_first(x, 2)
    assert idx.tolist() == [[1, 2]]
    y = torch.tensor([-0.5, float("-inf"), -2.0, float("-inf"), 0.25, -2.0])
    vals, idx = tws.topk_lower_index_first(y, 5)
    assert idx.tolist() == [4, 0, 2, 5, 1]
    want = jax.lax.top_k(jnp.asarray(y.numpy()), 5)
    assert idx.tolist() == np.asarray(want[1]).tolist()


def _probe_inputs(seed, q=3, p=4, tile=8):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 3 * tile + 3, (q, p)).astype(np.int32)
    sizes[0, 0] = 0  # an empty run contributes no tile
    starts = rng.integers(0, 500, (q, p)).astype(np.int32)
    pscores = rng.standard_normal((q, p)).astype(np.float32)
    return starts, sizes, pscores


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("tile", [8, 16])
@pytest.mark.parametrize("slack", [0, 3])
def test_build_tile_worklist_matches_jax(seed, tile, slack):
    starts, sizes, pscores = _probe_inputs(seed, tile=tile)
    need = twl.needed_worklist_tiles(twl.probe_tile_counts(sizes, tile))
    bound = need + slack
    want = jwl.build_tile_worklist(
        jnp.asarray(starts), jnp.asarray(sizes), jnp.asarray(pscores),
        tile_c=tile, tiles_per_qtoken=bound,
    )
    got = twl.build_tile_worklist(
        torch.from_numpy(starts), torch.from_numpy(sizes), torch.from_numpy(pscores),
        tile_c=tile, tiles_per_qtoken=bound,
    )
    for f in ("row0", "nvalid", "qtok", "pscore"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    pos_j, val_j = jwl.worklist_slot_positions(want, tile_c=tile, n_tokens=510)
    pos_t, val_t = twl.worklist_slot_positions(got, tile_c=tile, n_tokens=510)
    np.testing.assert_array_equal(pos_t.numpy(), np.asarray(pos_j))
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))


def test_batched_worklists_equal_per_element():
    """The per-batch-element worklists the JAX engine gets from vmap."""
    a = _probe_inputs(7)
    b = _probe_inputs(8)
    stacked = [torch.from_numpy(np.stack([x, y])) for x, y in zip(a, b)]
    got = twl.build_tile_worklist(*stacked, tile_c=8, tiles_per_qtoken=6)
    for i, src in enumerate((a, b)):
        want = jwl.build_tile_worklist(
            *(jnp.asarray(x) for x in src), tile_c=8, tiles_per_qtoken=6
        )
        for f in ("row0", "nvalid", "qtok", "pscore"):
            np.testing.assert_array_equal(
                getattr(got, f)[i].numpy(), np.asarray(getattr(want, f))
            )


def test_empty_index_clamp_floor_is_zero():
    wl = twl.TileWorklist(*(torch.tensor([3], dtype=torch.int32) for _ in range(3)),
                          torch.tensor([0.5]))
    pos, _ = twl.worklist_slot_positions(wl, tile_c=8, n_tokens=0)
    assert pos.min().item() == 0


@pytest.mark.parametrize("nprobe", [1, 3, 7])
@pytest.mark.parametrize("tile", [8, 32])
def test_bounds_and_ladder_match_jax(nprobe, tile):
    rng = np.random.default_rng(nprobe * 31 + tile)
    sizes = rng.integers(0, 200, 50).astype(np.int32)
    bound = twl.worklist_bound(sizes, nprobe, tile)
    assert bound == jwl.worklist_bound(sizes, nprobe, tile)
    assert twl.bucket_ladder(bound) == jwl.bucket_ladder(bound)
    probe = rng.integers(0, 200, (2, 5, nprobe))
    tiles = twl.probe_tile_counts(probe, tile)
    np.testing.assert_array_equal(tiles, jwl.probe_tile_counts(probe, tile))
    for amortized in (True, False):
        need = twl.needed_worklist_tiles(tiles, amortized=amortized)
        assert need == jwl.needed_worklist_tiles(tiles, amortized=amortized)
        ladder = twl.bucket_ladder(bound)
        assert twl.pick_bucket(ladder, need) == jwl.pick_bucket(ladder, need)


@pytest.mark.parametrize("bound", [1, 2, 5, 64, 100, 1000])
def test_bucket_ladder_values(bound):
    assert twl.bucket_ladder(bound) == jwl.bucket_ladder(bound)
