"""Port parity of the scoring stage.

On the CPU: each plain version in ``repro_torch.kernels.ref`` against
``repro.kernels.ref`` (nbits 2/4/8) and against the JAX Pallas kernel run
in interpret mode (``buffering="double"``) at one small shape each, plus
the dispatch rules. Tolerance 1e-5: float32 sums taken in another order.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decompress_score import selective_sum_kernel_call
from repro.kernels.fused_gather_score import (
    fused_gather_score_kernel_call,
    ragged_fused_gather_score_kernel_call,
)
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decompress_score import selective_sum, selective_sum_cuda
from repro_torch.kernels.fused_gather_score import (
    fused_gather_score,
    fused_gather_score_cuda,
    ragged_fused_gather_score,
    ragged_fused_gather_score_cuda,
)
from test_torch_kernels_cuda import _inputs, _t, _worklist

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(a):
    return jnp.asarray(a)


# ---------------------------------------------------------------------------
# plain versions against the JAX references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("lut", [False, True])
def test_selective_sum_matches_jax_ref(nbits, lut):
    codes, v, *_ = _inputs(nbits, nbits=nbits)
    packed = codes[:60].reshape(3, 20, -1)
    jf = jref.selective_sum_lut if lut else jref.selective_sum
    tf = tref.selective_sum_lut if lut else tref.selective_sum
    want = jf(_j(packed), _j(v), nbits=nbits, dim=32)
    got = tf(_t(packed), _t(v), nbits=nbits, dim=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("lut", [False, True])
def test_ragged_selective_sum_matches_jax_ref(nbits, lut):
    codes, v, *_ = _inputs(10 + nbits, nbits=nbits)
    qtok = np.random.default_rng(nbits).integers(0, 3, codes.shape[0]).astype(np.int32)
    jf = jref.ragged_selective_sum_lut if lut else jref.ragged_selective_sum
    tf = tref.ragged_selective_sum_lut if lut else tref.ragged_selective_sum
    want = jf(_j(codes), _j(qtok), _j(v), nbits=nbits, dim=32)
    got = tf(_t(codes), _t(qtok), _t(v), nbits=nbits, dim=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_fused_gather_score_matches_jax_ref(nbits):
    codes, v, starts, sizes, pscore = _inputs(20 + nbits, nbits=nbits)
    args = (codes, starts, sizes, pscore, v)
    want = jref.fused_gather_score(*map(_j, args), nbits=nbits, dim=32, cap=24)
    got = tref.fused_gather_score(*map(_t, args), nbits=nbits, dim=32, cap=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    invalid = np.arange(24) >= sizes[..., None]
    assert np.all(got.numpy()[invalid] == 0.0)


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("tile", [8, 16])
def test_ragged_fused_gather_score_matches_jax_ref(nbits, tile):
    codes, v, starts, sizes, pscore = _inputs(30 + nbits, nbits=nbits)
    wl = _worklist(starts, sizes, pscore, tile)
    kw = dict(nbits=nbits, dim=32, tile_c=tile)
    want = jref.ragged_fused_gather_score(_j(codes), *(_j(a.numpy()) for a in wl), _j(v), **kw)
    got = tref.ragged_fused_gather_score(_t(codes), *wl, _t(v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    invalid = (np.arange(tile) >= wl.nvalid.numpy()[:, None]).reshape(-1)
    assert np.all(got.numpy()[invalid] == 0.0)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels (interpret mode, double-buffered)
# ---------------------------------------------------------------------------


def test_selective_sum_matches_pallas_interpret():
    codes, v, *_ = _inputs(40)
    packed = codes[:48].reshape(3, 16, -1)
    want = selective_sum_kernel_call(
        _j(packed), _j(v), nbits=4, dim=32, tile_n=8, interpret=True
    )
    got = tref.selective_sum(_t(packed), _t(v), nbits=4, dim=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fused_gather_score_matches_pallas_interpret():
    codes, v, starts, sizes, pscore = _inputs(41)
    want = fused_gather_score_kernel_call(
        _j(codes), _j(starts), _j(sizes), _j(pscore), _j(v),
        nbits=4, dim=32, n_tokens=codes.shape[0], cap_pad=32, tile_c=8,
        buffering="double", interpret=True,
    )[:, :, :24]
    got = tref.fused_gather_score(
        _t(codes), _t(starts), _t(sizes), _t(pscore), _t(v), nbits=4, dim=32, cap=24
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ragged_fused_gather_score_matches_pallas_interpret():
    codes, v, starts, sizes, pscore = _inputs(42)
    wl = _worklist(starts, sizes, pscore, 8)
    want = ragged_fused_gather_score_kernel_call(
        _j(codes), *(_j(a.numpy()) for a in wl), _j(v),
        nbits=4, dim=32, n_tokens=codes.shape[0], tile_c=8,
        buffering="double", interpret=True,
    )
    got = tref.ragged_fused_gather_score(_t(codes), *wl, _t(v), nbits=4, dim=32, tile_c=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    codes, v, starts, sizes, pscore = _inputs(50)
    before = dict(LAUNCHES)
    packed = _t(codes[:60].reshape(3, 20, -1))
    assert torch.equal(
        selective_sum(packed, _t(v), nbits=4, dim=32),
        tref.selective_sum(packed, _t(v), nbits=4, dim=32),
    )
    args = tuple(map(_t, (codes, starts, sizes, pscore, v)))
    assert torch.equal(
        fused_gather_score(*args, nbits=4, dim=32, cap=24),
        tref.fused_gather_score(*args, nbits=4, dim=32, cap=24),
    )
    wl = _worklist(starts, sizes, pscore, 8)
    assert torch.equal(
        ragged_fused_gather_score(_t(codes), *wl, _t(v), nbits=4, dim=32, tile_c=8),
        tref.ragged_fused_gather_score(_t(codes), *wl, _t(v), nbits=4, dim=32, tile_c=8),
    )
    assert LAUNCHES == before  # no kernel ran, so no count moved


@pytest.mark.parametrize("which", ["selective_sum", "fused", "ragged"])
def test_cuda_wrappers_refuse_cpu_tensors(which):
    codes, v, starts, sizes, pscore = _inputs(51)
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        if which == "selective_sum":
            selective_sum_cuda(_t(codes[:60].reshape(3, 20, -1)), _t(v), nbits=4, dim=32)
        elif which == "fused":
            fused_gather_score_cuda(
                *map(_t, (codes, starts, sizes, pscore, v)), nbits=4, dim=32, cap=24
            )
        else:
            wl = _worklist(starts, sizes, pscore, 8)
            ragged_fused_gather_score_cuda(_t(codes), *wl, _t(v), nbits=4, dim=32, tile_c=8)


def test_ops_kernel_path_on_cpu_equals_reference_path():
    codes, v, starts, sizes, pscore = _inputs(52)
    offsets = np.arange(0, 90, 5, dtype=np.int32)
    csizes = np.full(offsets.shape[0], 5, np.int32)
    cids = np.random.default_rng(0).integers(0, csizes.shape[0], (3, 4))
    args = tuple(map(_t, (codes, offsets, csizes, cids, pscore, v)))
    a = ops.fused_gather_selective_sum(*args, nbits=4, dim=32, cap=5, use_kernel=True)
    b = ops.fused_gather_selective_sum(*args, nbits=4, dim=32, cap=5, use_kernel=False)
    assert torch.equal(a, b)


def test_packable_dim_and_tile_errors():
    packed = torch.zeros((1, 2, 4), dtype=torch.uint8)
    v = torch.zeros((1, 7, 16))
    with pytest.raises(ValueError, match="does not fill whole"):
        ops.selective_sum(packed, v, nbits=4, dim=7, use_kernel=True)
    with pytest.raises(ValueError, match="does not fill whole"):
        ops.selective_sum(packed, v, nbits=4, dim=7, use_kernel=False, impl="lut")
    ops.selective_sum(packed, v, nbits=4, dim=7, use_kernel=False)  # gather handles it
    for bad in (0, 4, 12):
        with pytest.raises(ValueError, match="multiple of 8"):
            ops.validate_tile_c(bad)
    assert ops.resolve_tile_choice(1024, layout="ragged") == ops.TileChoice(32, "heuristic", "double")
    assert ops.resolve_tile_choice(20, layout="dense") == ops.TileChoice(32, "heuristic", "double")
    assert ops.resolve_tile_choice(20, 16, buffering="single").source == "config"
