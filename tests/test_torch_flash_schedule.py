"""The bf16 flash kernel's schedule and masking, on the CPU.

``ref.flash_schedule`` is the plain twin of the kernel's ``tile_range``
and block order (``csrc/flash_attention.cu``): which kv tiles each 128-row
q-block visits, on which of them it applies the mask, and the order the
blocks start in. Here it is held against a brute-force scan of the mask
over many shapes, for both tile shapes the kernel uses (128 keys at Dh 64,
64 at Dh 128). Then ``ref.flash_attention_tiled``, a plain attention that
visits only the scheduled tiles, masks only the flagged ones and runs in
base 2, is held against ``ref.flash_attention`` and against the JAX
package's Pallas kernel in interpret mode, from the same numpy inputs:
float32 within 1e-5 (float32 sums in another order, ``exp2`` for ``exp``),
bf16 within one bf16 ulp of the larger output plus 1e-5 (both are one
rounding of float32 values far closer than an ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import BLOCK_Q, TILE_K, bf16_smem_bytes

torch.set_num_threads(1)  # xdist runs one test process per core

LENGTHS = (1, 63, 64, 65, 127, 128, 129, 1000, 2048)
WINDOWS = (None, 1, 17, 128, 129, 512)
F32_TOL = 1e-5
BF16_ATOL = 1e-5


def _scan(sq, skv, causal, window, bq, bk):
    """Per (q-block, kv tile): whether a real row (< Sq) has a valid key
    there, and whether one meets an invalid key (masked, or at or past
    Skv), by brute force over every (row, key) pair."""
    nqb, nt = -(-sq // bq), -(-skv // bk)
    rows, keys = np.arange(nqb * bq), np.arange(nt * bk)
    rel = rows[:, None] - keys[None, :]
    valid = np.broadcast_to(keys < skv, rel.shape).copy()
    if causal:
        valid &= rel >= 0
    if window is not None:
        valid &= rel < window
    real = (rows < sq)[:, None]
    def per_tile(x):
        return x.reshape(nqb, bq, nt, bk).any(axis=(1, 3))
    return per_tile(valid & real), per_tile(~valid & real)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("causal", [True, False])
def test_schedule_matches_a_scan_of_the_mask(causal, window):
    for bk in sorted(set(TILE_K.values())):
        for sq in LENGTHS:
            for skv in LENGTHS:
                has_valid, has_invalid = _scan(sq, skv, causal, window, BLOCK_Q, bk)
                sched = tref.flash_schedule(sq, skv, causal=causal, window=window, bq=BLOCK_Q, bk=bk)
                nqb, nt = has_valid.shape
                where = f"Sq={sq} Skv={skv} bk={bk}"
                order = [qb for qb, *_ in sched]
                assert order == (list(range(nqb))[::-1] if causal else list(range(nqb))), where
                skip = sq <= skv and window != 0
                counts = []
                for qb, t_lo, t_hi, m_lo, m_hi in sched:
                    visited = np.zeros(nt, bool)
                    visited[t_lo : t_hi + 1] = True
                    if skip:  # a visited tile holds a valid key for some row; no skipped one does
                        np.testing.assert_array_equal(visited, has_valid[qb], err_msg=where)
                    else:  # a row without a valid key averages v over every tile
                        assert visited.all(), where
                    flagged = (np.arange(nt) < m_lo) | (np.arange(nt) >= m_hi)
                    np.testing.assert_array_equal(flagged, has_invalid[qb], err_msg=where)
                    counts.append(t_hi - t_lo + 1)
                # Heaviest first: a block started later visits no more tiles than
                # one started before it, up to bq/bk - 1 where the last is partial.
                slack = BLOCK_Q // bk - 1
                for i in range(len(counts)):
                    assert max(counts[i:]) <= counts[i] + slack, (where, counts)


def _qkv(seed, b, sq, skv, h, hkv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, skv, dh)).astype(np.float32) for _ in range(2))
    return q, k, v


def _excess_over_ulp(got, want):
    """The most an element of ``got`` lies from ``want`` beyond one bf16
    ulp of the larger of the two."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    big = np.maximum(np.abs(got), np.abs(want))
    _, e = np.frexp(big)
    ulp = np.where(big > 0, np.ldexp(np.ones_like(big), e - 8), 0)
    return float((np.abs(got - want) - ulp).max())


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        assert _excess_over_ulp(got, want) <= BF16_ATOL


def _tiled(q, k, v, dtype, causal, window):
    dh = q.shape[-1]
    args = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v))
    out = tref.flash_attention_tiled(
        *args, causal=causal, window=window, bq=BLOCK_Q, bk=TILE_K[dh]
    )
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    return out.float().numpy()


JAX_CASES = [  # b, s, h, hkv, dh, causal, window: Sq = Skv, a multiple of the JAX tiles
    (1, 256, 4, 2, 64, True, None),
    (1, 384, 2, 1, 64, True, 17),
    (1, 256, 2, 2, 64, True, 129),
    (2, 128, 2, 2, 64, False, None),
    (1, 320, 2, 1, 128, True, 128),
    (1, 192, 4, 4, 128, False, 1),
    (1, 128, 2, 2, 64, True, 0),  # every key masked: the mean of v
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,dh,causal,window", JAX_CASES)
def test_tiled_attention_matches_plain_and_jax_kernel(dtype, b, s, h, hkv, dh, causal, window):
    q, k, v = _qkv(s + dh, b, s, s, h, hkv, dh)
    got = _tiled(q, k, v, dtype, causal, window)
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    _assert_close(got, tref.flash_attention(*tq, causal=causal, window=window).float().numpy(), dtype)
    rep = h // hkv
    jq, jk, jv = (
        jnp.asarray(a, getattr(jnp, dtype))
        for a in (q, np.repeat(k, rep, axis=1), np.repeat(v, rep, axis=1))
    )
    want = flash_attention_kernel_call(
        jq, jk, jv, causal=causal, window=window, tq=64, tk=64, interpret=True
    )
    _assert_close(got, np.asarray(want, np.float32), dtype)


RAGGED_CASES = [  # b, sq, skv, h, hkv, dh, causal, window: shapes no JAX tile divides
    (1, 1, 1, 2, 1, 64, True, None),
    (1, 65, 65, 7, 1, 64, True, 17),
    (1, 127, 129, 4, 4, 64, False, None),  # Sq < Skv without causality
    (1, 129, 129, 2, 2, 128, True, 1),
    (1, 63, 200, 2, 1, 128, False, 129),
    (1, 200, 65, 2, 2, 64, True, None),  # Sq > Skv: nothing skipped
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,hkv,dh,causal,window", RAGGED_CASES)
def test_tiled_attention_matches_plain_at_ragged_shapes(dtype, b, sq, skv, h, hkv, dh, causal, window):
    q, k, v = _qkv(sq + skv, b, sq, skv, h, hkv, dh)
    got = _tiled(q, k, v, dtype, causal, window)
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    _assert_close(got, tref.flash_attention(*tq, causal=causal, window=window).float().numpy(), dtype)


@pytest.mark.parametrize("dh", sorted(TILE_K))
def test_bf16_kernel_block_fits_shared_memory(dh):
    assert bf16_smem_bytes(dh) <= _build.SMEM_MAX
