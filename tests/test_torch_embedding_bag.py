"""Port parity of the embedding bag on the CPU: ``repro_torch``'s
``ops.embedding_bag`` and its kernel's plain version against the JAX
package's ``ops.embedding_bag`` and ``ref.embedding_bag``.

- Padded form, kernel: the plain version ``ref.embedding_bag_bags`` (what
  the wrapper runs on a CPU tensor, and what the CUDA kernel is held to on
  the card) against JAX's Pallas kernel in interpret mode
  (``use_kernel=True``), at ``tests/test_kernels.py``'s shapes plus D 1,
  10 and 18, zero weights, and indices outside [0, V), negative and
  >= V, which contribute exactly 0 in both. rtol = atol = 1e-5: float32
  sums in another order (the TPU form sums a one-hot product per vocab
  block, the port sums rows in index order).
- Padded form, ``use_kernel=False``: ``jnp.take``'s semantics (NaN for an
  index outside [-V, V), a negative one in range wraps), NaN positions
  included; 1e-5.
- Flat form against ``ref.embedding_bag`` with unsorted segment ids (and
  ids outside [0, num_segments), which both drop); 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_cuda

torch.set_num_threads(1)  # xdist runs one test process per core
torch.set_float32_matmul_precision("highest")

TOL = dict(rtol=1e-5, atol=1e-5)


def _bags(seed, v, d, s, l, *, zero_weights=False, out_of_range=False):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(0, v, (s, l)).astype(np.int32)
    w = (rng.random((s, l)) > 0.3).astype(np.float32) * rng.random((s, l)).astype(np.float32)
    if zero_weights:
        w[:] = 0
    if out_of_range:
        bad = rng.random((s, l)) < 0.3
        far = rng.integers(v, 3 * v + 600, (s, l))  # >= V, some past JAX's padded vocab
        neg = -rng.integers(1, 2 * v, (s, l))
        idx = np.where(bad, np.where(rng.random((s, l)) < 0.5, far, neg), idx).astype(np.int32)
    return table, idx, w


def _jax_bags(table, idx, w, *, use_kernel):
    return np.asarray(jops.embedding_bag(
        jnp.asarray(table), None, bag_indices=jnp.asarray(idx), bag_weights=jnp.asarray(w),
        use_kernel=use_kernel,
    ))


BAG_CASES = [
    # (V, D, S, L, kind): tests/test_kernels.py's shapes, narrow D, edge weights/ids
    (100, 32, 5, 3, "plain"),
    (1000, 64, 37, 10, "plain"),
    (513, 128, 8, 64, "plain"),
    (300, 1, 12, 39, "plain"),
    (600, 10, 9, 39, "plain"),
    (700, 18, 6, 100, "plain"),
    (200, 16, 7, 5, "zero_weights"),
    (600, 32, 11, 20, "out_of_range"),
    (600, 18, 4, 33, "out_of_range"),
]


@pytest.mark.parametrize("v,d,s,l,kind", BAG_CASES)
def test_kernel_plain_version_matches_pallas_interpret(v, d, s, l, kind):
    table, idx, w = _bags(v + d + s, v, d, s, l, **({kind: True} if kind != "plain" else {}))
    want = _jax_bags(table, idx, w, use_kernel=True)
    got = ref.embedding_bag_bags(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    assert got.dtype == torch.float32 and tuple(got.shape) == (s, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The dispatch's kernel route on a CPU tensor is that plain version:
    # no launch, the same numbers, int64 ids alike.
    before = dict(LAUNCHES)
    via_ops = ops.embedding_bag(
        torch.from_numpy(table), bag_indices=torch.from_numpy(idx).long(),
        bag_weights=torch.from_numpy(w), use_kernel=True,
    )
    assert LAUNCHES == before
    np.testing.assert_array_equal(via_ops.numpy(), got.numpy())


def test_out_of_range_ids_contribute_exactly_zero():
    table, idx, w = _bags(3, 600, 24, 10, 16, out_of_range=True)
    valid = (idx >= 0) & (idx < 600)
    assert (~valid).any() and valid.any()
    got = ref.embedding_bag_bags(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w))
    in_range = ref.embedding_bag_bags(
        torch.from_numpy(table), torch.from_numpy(np.where(valid, idx, 0)),
        torch.from_numpy(np.where(valid, w, 0).astype(np.float32)),
    )
    np.testing.assert_array_equal(got.numpy(), in_range.numpy())


@pytest.mark.parametrize("out_of_range", [False, True])
def test_dense_path_matches_jax_take_semantics(out_of_range):
    table, idx, w = _bags(5, 600, 16, 9, 12, out_of_range=out_of_range)
    idx[0, 0], idx[1, 1] = -1, -600  # in range for jnp.take: wrap to rows V-1 and 0
    want = _jax_bags(table, idx, w, use_kernel=False)
    got = ops.embedding_bag(
        torch.from_numpy(table), bag_indices=torch.from_numpy(idx),
        bag_weights=torch.from_numpy(w), use_kernel=False,
    ).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == out_of_range
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)


def test_take_matches_jnp_take():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 3)).astype(np.float32)
    idx = np.array([[0, 49, -1, -50], [-51, 50, 7, 1000]], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0))
    got = ref.take(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    assert got.shape == (2, 4, 3)
    np.testing.assert_array_equal(got, want)  # a copy of rows, NaN where JAX fills


@pytest.mark.parametrize("weighted", [False, True])
def test_flat_form_matches_jax_ref_unsorted_segments(weighted):
    rng = np.random.default_rng(7 + weighted)
    table = rng.standard_normal((80, 12)).astype(np.float32)
    n, segs = 60, 9
    indices = rng.integers(0, 80, (n,)).astype(np.int32)
    seg = rng.integers(0, segs, (n,)).astype(np.int32)  # unsorted
    seg[:3] = [segs, segs + 4, -1]  # outside [0, num_segments): dropped by both
    w = rng.random((n,)).astype(np.float32) if weighted else None
    want = np.asarray(jref.embedding_bag(
        jnp.asarray(table), jnp.asarray(indices), jnp.asarray(seg), num_segments=segs,
        weights=None if w is None else jnp.asarray(w),
    ))
    got = ops.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(indices), torch.from_numpy(seg),
        num_segments=segs, weights=None if w is None else torch.from_numpy(w),
    )
    assert tuple(got.shape) == (segs, 12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("s,l", [(0, 5), (4, 0)])
def test_empty_bags_are_zeros(s, l):
    table = torch.randn(30, 7)
    out = embedding_bag(table, torch.zeros((s, l), dtype=torch.int32), torch.ones(s, l))
    assert tuple(out.shape) == (s, 7) and not out.any()


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_forms():
    table = torch.randn(30, 8)
    idx, w = torch.zeros((2, 3), dtype=torch.int64), torch.ones(2, 3)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        embedding_bag_cuda(table, idx, w)
    with pytest.raises(ValueError, match="bag_weights"):
        ops.embedding_bag(table, bag_indices=idx, use_kernel=True)
    with pytest.raises(ValueError, match="flat form"):
        ops.embedding_bag(table, torch.zeros(3, dtype=torch.int64))
