"""The bag backward's index preparation on the CPU, and the plain backward
summed through it against JAX.

The CUDA entry of the table's gradient sorts the flattened ids on the card
by a stable least-significant-digit radix sort of their keys (the id, or V
for an id outside [0, V)), in ``ref.bag_sort_plan``'s passes, and turns
them into rows: ``offsets[r]`` the number of keys below r, the positions of
row r at ``positions[offsets[r]:offsets[r + 1]]`` in increasing flat
position. Its plain twin is ``ref.bag_csr``; the card test
(``tests/test_torch_kernels_cuda.py``) holds the entry's arrays to it
exactly. Here:

- ``ref.bag_csr`` against ``ref.bag_sort`` and a brute-force count,
  exactly, with int32 and int64 ids, ids outside [0, V) on both sides
  (int64 ones far outside int32), an empty bag set, V at 2^k - 1, 2^k and
  2^k + 1 (the key's bit count changes), and one row named 100,000 times;
- the plan: passes of at most 8 bits, all of one width, covering
  bit_length(V), the fewest such; the passes run as stable sorts by one
  digit each (the kernel's order) give ``ref.bag_sort``'s keys and
  positions exactly;
- the plain backward, dtable summed row by row through ``ref.bag_csr`` in
  position order (the kernel's chain) and dw from
  ``ref.embedding_bag_bags_backward``, against ``jax.vjp`` of
  ``jnp.take`` + sum on in-range ids made with numpy, within
  ``ref.embedding_bag_backward_error_bound`` (float32 sums in another
  order).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_bag_backward_prep.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core  # noqa: F401  (imports the kernels package in its order)
from repro_torch.kernels import ref

torch.set_num_threads(1)  # xdist runs one test process per core


def _ids(seed, s, l, v, dtype, bad=0.0):
    """Ids uniform over [0, V), a share ``bad`` of them outside on both
    sides (negative, and >= V)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, v, (s, l))
    pick = rng.random((s, l)) < bad
    far = rng.integers(v, 2 * v + 1, (s, l))
    idx = np.where(pick, np.where(far % 2 == 0, far, -far), idx)
    return torch.from_numpy(idx.astype(np.int64)).to(dtype)


def _assert_csr(idx, v):
    """``ref.bag_csr`` equals ``ref.bag_sort`` restricted to keys below V
    and a brute-force count of the keys below each row, exactly."""
    offsets, positions = ref.bag_csr(idx, v)
    key, pos = ref.bag_sort(idx, v)
    flat = idx.reshape(-1).long().numpy()
    keys = np.where((flat >= 0) & (flat < v), flat, v)
    want = np.searchsorted(np.sort(keys, kind="stable"), np.arange(v + 1), side="left")
    assert offsets.dtype == torch.int64 and positions.dtype == torch.int64
    assert offsets.tolist() == want.tolist()
    assert torch.equal(positions, pos[key < v])
    # Each row's positions are exactly its ids' flat positions, increasing.
    for r in np.unique(keys[keys < v])[:50]:
        got = positions[offsets[r]:offsets[r + 1]].numpy()
        assert got.tolist() == np.flatnonzero(keys == r).tolist()
    return offsets, positions


def _lsd_sort(idx, v):
    """The kernel's sort in plain form: ``ref.bag_sort_plan``'s passes, each
    a stable sort by one digit of the keys, lowest digit first."""
    flat = idx.reshape(-1).long()
    key = torch.where((flat >= 0) & (flat < v), flat, v)
    pos = torch.arange(key.numel())
    passes, bits, _ = ref.bag_sort_plan(key.numel(), v)
    for p in range(passes):
        order = torch.sort((key >> (p * bits)) & ((1 << bits) - 1), stable=True).indices
        key, pos = key[order], pos[order]
    return key, pos


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("s,l,v", [(300, 13, 500), (64, 100, 1000), (1000, 1, 7), (5, 39, 100_000)])
def test_bag_csr_matches_bag_sort(dtype, s, l, v):
    _assert_csr(_ids(s * l + v, s, l, v, dtype, bad=0.1), v)


def test_bag_csr_ids_far_outside_the_table():
    v = 1000
    idx = _ids(3, 50, 20, v, torch.int64, bad=0.3)
    idx[0, :5] = torch.tensor([2**32 + 5, -(2**32) + 5, 2**62, -1, v])
    offsets, positions = _assert_csr(idx, v)
    valid = ((idx >= 0) & (idx < v)).reshape(-1)
    assert int(offsets[-1]) == int(valid.sum()) == positions.numel()
    assert not bool(torch.isin(positions, torch.nonzero(~valid).flatten()).any())


@pytest.mark.parametrize("s,l", [(0, 8), (16, 0), (0, 0)])
def test_bag_csr_of_an_empty_bag_set(s, l):
    offsets, positions = ref.bag_csr(torch.zeros((s, l), dtype=torch.int64), 37)
    assert offsets.tolist() == [0] * 38 and positions.numel() == 0


@pytest.mark.parametrize("k", [1, 7, 8, 16, 20])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_sort_plan_and_passes_at_powers_of_two(k, delta):
    """V at 2^k - 1, 2^k and 2^k + 1: the keys lie in [0, V], bit_length(V)
    bits, which steps up at V = 2^k."""
    v = 2**k + delta
    passes, bits, tiles = ref.bag_sort_plan(4097, v)
    need = v.bit_length()
    assert bits <= ref.BAG_SORT_DIGIT_BITS and passes * bits >= need
    assert passes == -(-need // ref.BAG_SORT_DIGIT_BITS)  # the fewest passes
    assert (passes - 1) * bits < need  # no pass sorts only zero digits
    assert tiles == -(-4097 // ref.BAG_SORT_TILE)
    idx = _ids(k, 41, 17, v, torch.int64, bad=0.05)
    idx[0, :3] = torch.tensor([v - 1, v, 0])
    key, pos = _lsd_sort(idx, v)
    want = ref.bag_sort(idx, v)
    assert torch.equal(key, want[0]) and torch.equal(pos, want[1])
    _assert_csr(idx, v)


def test_bag_csr_hot_row():
    """One row named 100,000 times, at every other flat position, among
    uniform ids."""
    v = 3000
    idx = _ids(9, 1000, 250, v, torch.int32, bad=0.02)
    idx.view(-1)[0:200_000:2] = 7
    offsets, positions = _assert_csr(idx, v)
    hot = positions[offsets[7]:offsets[8]]
    assert hot.numel() >= 100_000 and bool((hot[1:] > hot[:-1]).all())
    key, pos = _lsd_sort(idx, v)
    assert torch.equal(key, ref.bag_sort(idx, v)[0]) and torch.equal(pos, ref.bag_sort(idx, v)[1])


def _csr_dtable(table, idx, w, g):
    """dtable summed row by row through ``ref.bag_csr``, each row's terms in
    increasing flat position (the kernel's order), in float32."""
    v, d = table.shape
    offsets, positions = ref.bag_csr(idx, v)
    l = idx.shape[1]
    wf, gf = w.reshape(-1).numpy(), g.numpy()
    out = np.zeros((v, d), np.float32)
    for r in range(v):
        acc = np.zeros(d, np.float32)
        for f in positions[offsets[r]:offsets[r + 1]].tolist():
            acc = acc + np.float32(wf[f]) * gf[f // l]
        out[r] = acc
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 8, 18])
def test_plain_backward_through_bag_csr_matches_jax(dtype, d):
    rng = np.random.default_rng(100 + d)
    v, s, l = 400, 60, 25
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (s, l))
    idx[:, 1] = idx[:, 0]  # a duplicate in every bag
    w = rng.random((s, l)).astype(np.float32) * (rng.random((s, l)) > 0.2)
    g = rng.standard_normal((s, d)).astype(np.float32)

    def bags(t, ww):
        return jnp.sum(jnp.take(t, jnp.asarray(idx), axis=0) * ww[..., None], axis=1)

    _, vjp = jax.vjp(bags, jnp.asarray(table), jnp.asarray(w))
    jt, jw = (torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(g)))
    tt, ti, tw, tg = (torch.from_numpy(table), torch.from_numpy(idx).to(dtype),
                      torch.from_numpy(w), torch.from_numpy(g))
    lim_t, lim_w = ref.embedding_bag_backward_error_bound(tt, ti, tw, tg)
    dtable = _csr_dtable(tt, ti, tw, tg)
    _, dw = ref.embedding_bag_bags_backward(tt, ti, tw, tg, table_grad=False, weights_grad=True)
    assert float(((dtable - jt).abs() - lim_t).max()) <= 0
    assert float(((dw - jw).abs() - lim_w).max()) <= 0
    named = torch.zeros(v, dtype=torch.bool)
    named[ti.reshape(-1).long()] = True
    assert not bool(dtable[~named].any())  # rows no bag names: exactly 0
