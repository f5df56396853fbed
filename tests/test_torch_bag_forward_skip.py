"""The identity the embedding-bag forward kernel's zero-weight skip rests
on, checked on the CPU against the JAX package.

The kernel (``csrc/embedding_bag.cu``) loads no row whose weight is 0.0 or
-0.0, as it loads none for an id outside [0, V). Its result is held to the
plain version ``ref.embedding_bag_bags``, which fmas every in-range term.

- A zero-weight slot adds exactly nothing to the plain version on a finite
  table: with those slots' ids moved outside [0, V) it gives the same bits.
  Cases: D 1, 18 and 256; the path's 0/1 prefix masks; DIN's masked
  attention weights (0.0 and -0.0 in the masked slots); zeros of both
  signs scattered among nonzero weights.
- At the path's shapes narrowed (L 100 / D 18, L 39 / D 1, L 8 / D 256,
  V 1024), the plain version matches JAX's ``embedding_bag_kernel_call``
  in interpret mode within rtol = atol = 1e-5 (float32 sums in another
  order: the TPU form sums a one-hot product per vocab block), with the
  zero-weight slots in place and with their ids moved outside [0, V).
- One NaN table row. JAX's kernel in interpret mode gives NaN in every bag,
  also in bags that do not name the row (its one-hot product multiplies 0
  by every row of the block). JAX's reference (``use_kernel=False``:
  ``jnp.take`` + sum) and the plain version give NaN exactly in the bags
  that name the row, at any weight, 0.0 and -0.0 included. The kernel
  gives NaN only where the row's weight is nonzero (tested on the card).
  The reference makes no promise for a non-finite table; these tests pin
  what each version does.
- ``scripts/bench_bag_forward.py`` imports neither JAX nor ``repro``, and
  its six inputs, made on the CPU at a tenth of S, are the path's: ids in
  [0, V) of the stated dtype, prefix masks, DIN's signed zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.embedding_bag import embedding_bag_kernel_call
from repro_torch.kernels import LAUNCHES, ops, ref

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-5, atol=1e-5)
V = 1024  # two of the TPU kernel's 512-row vocab blocks
# (L, D) of the path's bags: DIN's history, xDeepFM's linear term, the
# two-tower user tower.
SHAPES = [(100, 18), (39, 1), (8, 256)]
KINDS = ["prefix", "din_masked", "signed_zeros"]


def _bags(seed, l, d, kind, *, s=16):
    """A table [V, D] and S bags of L ids with weights of one kind: the
    path's 0/1 prefix mask; that mask times attention weights in [-1, 1)
    (DIN: a masked slot holds 0.0 or -0.0); or weights in (0, 1] with a
    third of them 0.0 or -0.0."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, d)).astype(np.float32)
    idx = rng.integers(0, V, (s, l)).astype(np.int32)
    mask = (np.arange(l) < rng.integers(1, l + 1, (s, 1))).astype(np.float32)
    if kind == "prefix":
        w = mask
    elif kind == "din_masked":
        w = mask * (rng.random((s, l)) * 2 - 1).astype(np.float32)
    else:
        w = (1 - rng.random((s, l))).astype(np.float32)
        zero = rng.random((s, l)) < 1 / 3
        w = np.where(zero, np.where(rng.random((s, l)) < 0.5, 0.0, -0.0), w).astype(np.float32)
    return table, idx, w.astype(np.float32)


def _moved_outside(idx, w, seed):
    """The ids of the zero-weight slots moved outside [0, V), negative or >= V."""
    rng = np.random.default_rng(seed)
    far = np.where(rng.random(idx.shape) < 0.5, rng.integers(V, 3 * V, idx.shape),
                   -rng.integers(1, 2 * V, idx.shape))
    return np.where(w == 0, far, idx).astype(np.int32)


def _plain(table, idx, w):
    return ref.embedding_bag_bags(
        torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w)).numpy()


def _pallas(table, idx, w):
    return np.asarray(embedding_bag_kernel_call(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), tile_s=8, blk_v=512,
        interpret=True))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("l,d", SHAPES)
def test_zero_weight_slots_add_exactly_nothing(l, d, kind):
    table, idx, w = _bags(l + d, l, d, kind)
    zero = w == 0
    assert zero.any() and (~zero).any()
    if kind != "prefix":
        assert np.signbit(w[zero]).any()  # -0.0 occurs
    moved = _moved_outside(idx, w, l * d)
    assert ((moved[zero] < 0) | (moved[zero] >= V)).all()
    np.testing.assert_array_equal(_plain(table, idx, w), _plain(table, moved, w))
    # The kernel route on a CPU tensor is that plain version: no launch.
    before = dict(LAUNCHES)
    via_ops = ops.embedding_bag(torch.from_numpy(table), bag_indices=torch.from_numpy(idx).long(),
                                bag_weights=torch.from_numpy(w), use_kernel=True)
    assert LAUNCHES == before
    np.testing.assert_array_equal(via_ops.numpy(), _plain(table, idx, w))
    # The moved ids read nothing either: any weight gives the same bits.
    loud = np.where(zero, np.float32(7.0), w)
    np.testing.assert_array_equal(_plain(table, moved, loud), _plain(table, idx, w))


@pytest.mark.parametrize("moved", [False, True])
@pytest.mark.parametrize("kind", ["prefix", "din_masked"])
@pytest.mark.parametrize("l,d", SHAPES)
def test_plain_version_matches_pallas_interpret_at_path_shapes(l, d, kind, moved):
    table, idx, w = _bags(3 * l + d, l, d, kind)
    if moved:
        idx = _moved_outside(idx, w, l + 7 * d)
    want = _pallas(table, idx, w)
    got = _plain(table, idx, w)
    assert got.shape == (idx.shape[0], d) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("l,d", SHAPES)
def test_a_nan_row_pins_what_each_version_does(l, d):
    table, idx, w = _bags(5 * l + d, l, d, "din_masked")
    nan_row = 700  # in the second vocab block; not a clamp target
    idx = np.where(idx == nan_row, nan_row + 1, idx).astype(np.int32)
    # Bag 0 names the row under 0.0, bag 1 under -0.0, bag 2 under a
    # nonzero weight; no other bag names it.
    for bag, wt in ((0, 0.0), (1, -0.0), (2, 0.5)):
        idx[bag, 0], w[bag, 0] = nan_row, wt
    table[nan_row] = np.nan
    named = (idx == nan_row).any(axis=1)
    assert named.sum() == 3

    kernel = _pallas(table, idx, w)
    assert np.isnan(kernel).all()  # every bag, also those not naming the row

    reference = np.asarray(jops.embedding_bag(
        jnp.asarray(table), None, bag_indices=jnp.asarray(idx), bag_weights=jnp.asarray(w),
        use_kernel=False))
    plain = _plain(table, idx, w)
    for got in (reference, plain):
        np.testing.assert_array_equal(np.isnan(got).all(axis=1), named)
        assert not np.isnan(got[~named]).any()
    finite = table.copy()
    finite[nan_row] = 0.0
    np.testing.assert_allclose(plain[~named], _plain(finite, idx, w)[~named], rtol=0, atol=0)


def _bench():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "bench_bag_forward.py")
    spec = importlib.util.spec_from_file_location("bench_bag_forward", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return path, mod


def test_bench_script_imports_neither_jax_nor_repro():
    import ast

    path, _ = _bench()
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert not {n for n in names if n.split(".")[0] in ("jax", "repro")}


@pytest.mark.parametrize("case", ["user_bulk", "din", "din_path", "xdeepfm_bulk", "user_p99",
                                  "din_p99"])
def test_bench_inputs_are_the_paths(case):
    """The bench's inputs, made on the CPU at a tenth of S (the card makes
    them the same way): ids in [0, V) of the stated dtype, and weights of
    the stated kind (a prefix mask; DIN's attention weights with 0.0 and
    -0.0 in the masked slots; a fifth 0 with a duplicate id in every bag;
    all 1)."""
    _, bench = _bench()
    name, s, l, table, dtype, weights = next(c for c in bench.CASES if c[0] == case)
    s = max(s // 10, 64)
    v = bench.TABLES[table][0]
    idx, w = bench.make_bags(torch, s, l, v, dtype, weights, 3, torch.device("cpu"))
    assert idx.dtype == getattr(torch, dtype) and tuple(idx.shape) == (s, l) == tuple(w.shape)
    assert int(idx.min()) >= 0 and int(idx.max()) < v
    zero = w == 0
    if weights == "ones":
        assert bool((w == 1).all())
    elif weights == "fifth_zero":
        assert torch.equal(idx[:, 0], idx[:, 1])
        assert abs(float(zero.float().mean()) - 0.2) < 0.02
    else:
        valid = (w != 0).sum(dim=1)
        mask = torch.arange(l) < valid.unsqueeze(1)
        assert bool(valid.min() >= 1) and torch.equal(zero, ~mask)  # a prefix of each bag
        if weights == "attention":
            assert bool(torch.signbit(w[zero]).any()) and bool((w[~zero] < 0).any())
