"""Port parity of flash attention on the CPU.

``repro_torch.kernels.ops.flash_attention`` (the plain version, as a CPU
tensor takes it) against the JAX ``ops.flash_attention`` (the Pallas
kernel in interpret mode) on the cases of ``tests/test_flash_attention.py``,
a Dh 128 case, a window whose first tiles are masked for some rows, and
bf16 input; plus the dispatch rules. Tolerance rtol = atol = 2e-4, as the
JAX test holds its kernel; bf16 output 2e-2 (one rounding of values of
magnitude up to ~4). The CUDA kernel is held against the same plain
version on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_cuda

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=2e-4, atol=2e-4)

CASES = [  # b, s, h, hkv, dh, causal, window; the first five are the JAX test's
    (2, 128, 4, 2, 32, True, None),
    (1, 256, 2, 2, 64, True, 64),
    (2, 128, 4, 4, 32, False, None),
    (1, 384, 2, 1, 16, True, 128),
    (1, 200, 2, 2, 32, True, None),  # padding path (causal)
    (1, 192, 4, 2, 128, True, None),  # Dh 128
    (1, 256, 2, 1, 64, True, 40),  # window < tile: rows whose first tile is masked
    (1, 128, 2, 2, 32, False, 48),  # window without causality
]


def _qkv(seed, b, s, h, hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal((b, s, n, dh)).astype(np.float32) for n in (h, hkv, hkv)
    )


@pytest.mark.parametrize("b,s,h,hkv,dh,causal,window", CASES)
def test_flash_matches_jax_kernel(b, s, h, hkv, dh, causal, window):
    q, k, v = _qkv(s + dh, b, s, h, hkv, dh)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
        tq=64, tk=64,
    )
    got = ops.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal, window=window, tq=64, tk=64
    )
    assert got.shape == (b, s, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_bf16_input_matches_jax_kernel():
    q, k, v = _qkv(3, 1, 200, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=True, tq=64, tk=64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True, tq=64, tk=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2
    )


def test_flash_default_tiles_match_jax():
    """The dispatch's tile rule tq = min(tq, max(8, S)): S = 40 runs as one
    40-row tile in both packages."""
    q, k, v = _qkv(5, 2, 40, 7, 1, 8)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_rejects_noncausal_padding():
    q = torch.zeros(1, 100, 2, 16)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(q, q, q, causal=False, tq=64, tk=64)


def test_fully_masked_rows_average_v_like_the_tpu_kernel():
    """A window of 0 masks every key: the TPU recurrence gives the mean of
    v over all (padded) keys, never NaN; the plain version does too."""
    q, k, v = _qkv(9, 1, 64, 2, 2, 16)
    want = jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=0, tq=32, tk=32
    )
    got = ops.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True, window=0, tq=32, tk=32
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy()[0, 0], v.mean(axis=1)[0], **TOL)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    q = torch.randn(1, 2, 64, 64)
    before = LAUNCHES["flash_attention"]
    torch.testing.assert_close(flash_attention(q, q, q), tref.flash_attention(q, q, q))
    assert LAUNCHES["flash_attention"] == before  # no kernel ran
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        flash_attention_cuda(q, q, q)
