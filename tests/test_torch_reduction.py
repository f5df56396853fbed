"""Port parity: the two-stage reduction of ``repro_torch`` against
``repro.core.reduction.two_stage_reduce`` (``impl="scan"``) on the same
numpy inputs — doc ids exact (ties lower-doc-first, as ``lax.top_k``),
scores within a few float32 ulps (summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.reduction import two_stage_reduce as jax_reduce
from repro_torch.core.reduction import two_stage_reduce

torch.set_num_threads(1)  # xdist runs one test process per core

ATOL = 4e-6


def _duplicate_heavy(seed, n, n_docs, q_max):
    """The generator of tests/test_reduction.py's duplicate-heavy parity
    test: few docs and query tokens over many entries (long duplicate
    (doc, qtok) runs), a third of the scores quantized (score ties)."""
    rng = np.random.default_rng(seed)
    doc_ids = rng.integers(0, n_docs, n).astype(np.int32)
    qtok = rng.integers(0, q_max, n).astype(np.int32)
    scores = rng.standard_normal(n).astype(np.float32)
    ties = rng.random(n) < 0.33
    scores[ties] = np.round(scores[ties], 1)
    valid = rng.random(n) > 0.3
    mse = (rng.standard_normal(q_max) * 0.1).astype(np.float32)
    return doc_ids, qtok, scores, valid, mse


def _both(args, n_docs=None, **kw):
    """JAX (told ``n_docs``, which arms its overflow guard) and the port
    (whose int64 key needs no guard) on the same inputs."""
    want = jax_reduce(*(jnp.asarray(a) for a in args), n_docs=n_docs, **kw)
    got = two_stage_reduce(*(torch.from_numpy(a) for a in args), **kw)
    return want, got


def _check(want, got):
    np.testing.assert_array_equal(got.doc_ids.numpy(), np.asarray(want.doc_ids))
    np.testing.assert_allclose(
        got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=ATOL
    )


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("impl", ["scan", "segment"])
def test_duplicate_heavy_matches_jax(seed, impl):
    """Random sizes from a few shapes (each distinct shape recompiles the
    JAX reference)."""
    rng = np.random.default_rng(1000 + seed)
    n, q_max = int(rng.choice([7, 64, 300])), int(rng.choice([1, 3, 5]))
    n_docs = int(rng.integers(1, 10))
    args = _duplicate_heavy(seed, n, n_docs, q_max)
    want, got = _both(args, q_max=q_max, k=4)
    _check(want, got)
    # "segment" is accepted and gives the same results as "scan".
    alt = two_stage_reduce(*(torch.from_numpy(a) for a in args), q_max=q_max, k=4, impl=impl)
    assert torch.equal(alt.doc_ids, got.doc_ids)


@pytest.mark.parametrize("seed", range(4))
def test_tied_totals_break_toward_lower_doc(seed):
    """Every doc gets the same total: the top-k must be the k lowest doc
    ids in ascending order, as jax.lax.top_k orders equal values."""
    rng = np.random.default_rng(seed)
    n_docs, q_max = 12, 3
    doc_ids = np.repeat(np.arange(n_docs, dtype=np.int32), q_max)
    rng.shuffle(doc_ids)
    qtok = np.zeros_like(doc_ids)
    for d in range(n_docs):
        qtok[doc_ids == d] = np.arange(q_max)
    scores = np.full(doc_ids.shape, 0.5, np.float32)
    valid = np.ones(doc_ids.shape, bool)
    mse = np.full(q_max, 0.1, np.float32)
    want, got = _both((doc_ids, qtok, scores, valid, mse), q_max=q_max, k=5)
    _check(want, got)
    assert got.doc_ids.tolist() == [0, 1, 2, 3, 4]


def test_pad_to_k_and_padding_contract():
    args = (
        np.array([3, 3, 5], np.int32), np.array([0, 1, 0], np.int32),
        np.array([0.5, 0.25, 0.1], np.float32), np.array([True, True, True]),
        np.zeros(2, np.float32),
    )
    with pytest.raises(ValueError, match="pad_to_k"):
        two_stage_reduce(*map(torch.from_numpy, args), q_max=2, k=5)
    want, got = _both(args, q_max=2, k=5, pad_to_k=True)
    _check(want, got)
    assert got.doc_ids.tolist()[2:] == [-1, -1, -1]
    assert torch.isinf(got.scores[2:]).all() and (got.scores[2:] < 0).all()


def test_all_invalid_gives_minus_one_and_minus_inf():
    args = (
        np.arange(6, dtype=np.int32), np.zeros(6, np.int32),
        np.ones(6, np.float32), np.zeros(6, bool), np.zeros(1, np.float32),
    )
    want, got = _both(args, q_max=1, k=3)
    _check(want, got)
    assert got.doc_ids.tolist() == [-1, -1, -1]


def test_wide_doc_ids_need_no_two_key_path():
    """Doc ids whose int32 composite key would overflow: the JAX package
    switches to a two-key sort; the int64 key covers them directly."""
    rng = np.random.default_rng(7)
    n, q_max = 200, 32
    doc_ids = rng.integers(2**31 - 200, 2**31 - 1, n).astype(np.int32)
    qtok = rng.integers(0, q_max, n).astype(np.int32)
    scores = rng.standard_normal(n).astype(np.float32)
    valid = rng.random(n) > 0.2
    mse = (rng.standard_normal(q_max) * 0.1).astype(np.float32)
    want, got = _both(
        (doc_ids, qtok, scores, valid, mse), q_max=q_max, k=6, n_docs=2**31 - 1
    )
    _check(want, got)


def test_batched_rows_reduce_independently():
    rows = [_duplicate_heavy(s, 150, 7, 4) for s in (1, 2, 3)]
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*rows)]
    got = two_stage_reduce(*stacked, q_max=4, k=5)
    for i, r in enumerate(rows):
        one = two_stage_reduce(*map(torch.from_numpy, r), q_max=4, k=5)
        assert torch.equal(got.doc_ids[i], one.doc_ids)
        torch.testing.assert_close(got.scores[i], one.scores, rtol=0, atol=0)
