"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version
on the card: edge shapes (an index smaller than one tile, runs ending at
the last row, padding tiles, dims that are not a multiple of the word
size) at nbits 2/4/8; invalid slots exactly 0; tolerance 1e-4 (float32
sums in another order). Marked ``cuda``: each test skips itself without a
card. This file imports no JAX, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

It also holds the input helpers ``tests/test_torch_kernels.py`` shares.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import Retriever, WarpSearchConfig
from repro_torch.core import worklist as wl
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decompress_score import selective_sum_cuda
from repro_torch.kernels.fused_gather_score import (
    fused_gather_score_cuda,
    ragged_fused_gather_score_cuda,
)

torch.set_num_threads(1)  # xdist runs one test process per core


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, *, nbits=4, dim=32, q=3, n_tokens=90, p=4, cap=24):
    rng = np.random.default_rng(seed)
    pb = dim * nbits // 8
    codes = rng.integers(0, 256, (n_tokens, pb), dtype=np.uint8)
    v = rng.standard_normal((q, dim, 1 << nbits)).astype(np.float32)
    sizes = rng.integers(0, cap + 1, (q, p)).astype(np.int32)
    sizes[0, 0] = cap  # one full cluster
    sizes[-1, -1] = 0  # one empty probe
    starts = rng.integers(0, n_tokens - cap + 1, (q, p)).astype(np.int32)
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    return codes, v, starts, sizes, pscore


def _worklist(starts, sizes, pscore, tile, slack=2):
    bound = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes, tile)) + slack
    return wl.build_tile_worklist(
        _t(starts), _t(sizes), _t(pscore), tile_c=tile, tiles_per_qtoken=bound
    )


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("dim", [32, 128, 20])
def test_selective_sum_kernel_on_card(card, nbits, dim):
    if dim % (8 // nbits):
        pytest.skip("dim does not fill whole packed bytes")
    rng = np.random.default_rng(nbits + dim)
    pb = dim * nbits // 8
    packed = _t(rng.integers(0, 256, (3, 1037, pb), dtype=np.uint8)).to(card)
    v = _t(rng.standard_normal((3, dim, 1 << nbits)).astype(np.float32)).to(card)
    got = selective_sum_cuda(packed, v, nbits=nbits, dim=dim)
    torch.cuda.synchronize()
    want = tref.selective_sum(packed, v, nbits=nbits, dim=dim)
    torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("n_tokens", [5, 90, 4000])
def test_fused_gather_score_kernel_on_card(card, nbits, n_tokens):
    """Includes an index smaller than one tile and probes ending at the
    last row: no clamp, no route to the plain version."""
    cap = min(24, n_tokens)
    codes, v, starts, sizes, pscore = _inputs(
        60 + nbits, nbits=nbits, n_tokens=n_tokens, cap=cap
    )
    starts[1, 1], sizes[1, 1] = n_tokens - cap, cap  # run ends at the last row
    args = tuple(_t(a).to(card) for a in (codes, starts, sizes, pscore, v))
    before = LAUNCHES["fused_gather_score"]
    got = fused_gather_score_cuda(*args, nbits=nbits, dim=32, cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_gather_score"] == before + 1
    want = tref.fused_gather_score(*args, nbits=nbits, dim=32, cap=cap)
    torch.testing.assert_close(got, want, **CARD_TOL)
    invalid = torch.arange(cap, device=card) >= args[2].long().unsqueeze(-1)
    assert bool((got[invalid] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("tile", [8, 32])
def test_ragged_fused_gather_score_kernel_on_card(card, nbits, tile):
    codes, v, starts, sizes, pscore = _inputs(70 + nbits, nbits=nbits)
    wl = _worklist(starts, sizes, pscore, tile, slack=3)  # padding tiles
    args = (_t(codes).to(card), *(a.to(card) for a in wl), _t(v).to(card))
    got = ragged_fused_gather_score_cuda(*args, nbits=nbits, dim=32, tile_c=tile)
    torch.cuda.synchronize()
    want = tref.ragged_fused_gather_score(*args, nbits=nbits, dim=32, tile_c=tile)
    torch.testing.assert_close(got, want, **CARD_TOL)
    invalid = (torch.arange(tile, device=card) >= args[2].long().unsqueeze(-1)).reshape(-1)
    assert bool((got[invalid] == 0).all())


@pytest.mark.cuda
def test_kernel_wrappers_check_their_inputs(card):
    codes, v, starts, sizes, pscore = _inputs(80)
    args = [_t(a).to(card) for a in (codes, starts, sizes, pscore, v)]
    args[1] = args[1].long()  # wrong dtype
    with pytest.raises(ValueError, match="dtype"):
        fused_gather_score_cuda(*args, nbits=4, dim=32, cap=24)
    packed = _t(codes[:60].reshape(3, 20, -1)).to(card)
    with pytest.raises(ValueError, match="shape"):
        selective_sum_cuda(packed, args[4][:2].contiguous(), nbits=4, dim=32)


def _fixture():
    fdir = os.path.join(os.path.dirname(__file__), "data", "torch_fixture")
    with open(os.path.join(fdir, "expected.json")) as f:
        expected = json.load(f)
    return fdir, expected, np.load(os.path.join(fdir, "queries.npz"))


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["full", "scan_qtokens"])
def test_ragged_materialize_kernel_route_on_card(card, memory):
    """gather="materialize", layout="ragged" at executor="kernel" scores
    the gathered copy of the worklist's rows with the worklist kernel; it
    must match the reference executor and launch that kernel."""
    fdir, expected, z = _fixture()
    r = Retriever.from_store(os.path.join(fdir, "store"), device=card)
    cfg = dict(expected["cases"][0]["config"], gather="materialize", layout="ragged", memory=memory)
    got = {}
    for executor in ("kernel", "reference"):
        before = LAUNCHES["ragged_fused_gather_score"]
        res = r.plan(WarpSearchConfig(**cfg, executor=executor)).retrieve_batch(z["q"], z["qmask"])
        got[executor] = (res.doc_ids.cpu().numpy(), res.scores.cpu().numpy())
        launched = LAUNCHES["ragged_fused_gather_score"] - before
        assert (launched > 0) == (executor == "kernel")
    np.testing.assert_array_equal(got["kernel"][0], got["reference"][0])
    np.testing.assert_allclose(got["kernel"][1], got["reference"][1], rtol=1e-4, atol=1e-4)
    # The JAX reference's materialize/dense ids: the layouts give the same top-k.
    np.testing.assert_array_equal(got["kernel"][0], np.asarray(expected["cases"][0]["doc_ids"]))


@pytest.mark.cuda
@pytest.mark.parametrize("executor", ["kernel", "reference"])
def test_fixture_retrieval_on_card(card, executor):
    """The committed JAX-written expectations, through the whole slice on
    the card (``tests/data/torch_fixture``)."""
    fdir, expected, z = _fixture()
    r = Retriever.from_store(os.path.join(fdir, "store"), device=card)
    for case in expected["cases"]:
        before = dict(LAUNCHES)
        plan = r.plan(WarpSearchConfig(**case["config"], executor=executor))
        res = plan.retrieve_batch(z["q"], z["qmask"])
        np.testing.assert_array_equal(res.doc_ids.cpu().numpy(), np.asarray(case["doc_ids"]))
        np.testing.assert_allclose(
            res.scores.cpu().numpy(), np.asarray(case["scores"]), rtol=1e-4, atol=1e-4
        )
        launched = sum(LAUNCHES[k] - before[k] for k in LAUNCHES)
        assert (launched > 0) == (executor == "kernel")
