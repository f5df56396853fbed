"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version
on the card: edge shapes (an index smaller than one tile, runs ending at
the last row, padding tiles, dims that are not a multiple of the word
size) at nbits 2/4/8; invalid slots exactly 0; tolerance 1e-4 (float32
sums in another order). The three scoring kernels also at D 20 and 96,
code views offset by 1, 4 and 16 bytes, Q 128, skewed probe sizes (one at
cap 1024 beside sizes 0 and 1, one past cap), exactly one launch per call,
and their launch as the Python twins say (blocks per token,
``ref.score_blocks_per_token``; the ragged kernel's blocks,
``ref.ragged_blocks``; the v-table chunk, ``_build.vtable_chunk``); the
ragged kernel at tile_c 8 to 64, on batched worklists, the materialize
route's gathered copy, all-padding worklists, unsorted and out-of-range
qtok; all three at nbits 8 with v-tables wider than one block's shared
memory (D 224 to 520, walked in chunks of dimensions). Flash attention
over causal and window masks (windows 1 to 512), S from 1 to 1000 (the
bf16 kernel's 128-row blocks partly empty), Sq != Skv, Dh 64 and 128,
float32 and bf16, GQA ratios 1 to 7, contiguous and transposed
[B, S, H, Dh] views: 1e-4 at float32, and
at bf16 each element within one bf16 ulp of the larger output plus 1e-5
(both are one rounding of float32 values far closer than an ulp). The
embedding bag at D 1, 18, 256 and 257, int32 and int64 ids, an unaligned
table view, ids outside [0, V) and empty bag sets, per element within
``ref.embedding_bag_error_bound`` ((L + 1) * 2^-24 * sum |w| |row| + 1e-7,
float32 sums in another order); a two-tower forward at REDUCED, kernel vs
reference executor, within 1e-5; the forward at every lane grouping (D 1
to 257, L 1 to 100, S below and above one block, a table view at +4
bytes) with 0.0 and -0.0 weights, bit-identical across calls, exactly 0
at all-zero weights, and a NaN row that adds nothing under weight 0 and
gives NaN under a nonzero weight. The bag's backward kernels (the table's
dense gradient and the weights') per element within
``ref.embedding_bag_backward_error_bound`` ((n + 1) * 2^-24 * sum |w g| +
1e-7 over a row's n contributions; (D + 1) * 2^-24 * sum |row g| + 1e-7),
bit-identical across calls, and through autograd; at every width tier
(D 1 to 256) with a row named 100,000 times, and at V 2^16 - 1 to
2^16 + 1 with 32- and 64-bit keys, the table entry's sort and row offsets
equal to ``ref.bag_sort`` / ``ref.bag_csr``. The two fused kernels'
``probe`` carve-outs: "full" bit-identical to the product call, "dma"
and "compute" finite with the invalid slots 0, each launch counted under
its own name; a two-point autotune sweep (the table's schema, the plans
it steers); the staging/scoring split on traced retrieves. Marked
``cuda``: each test skips itself
without a card. This file imports no JAX, so it runs where JAX is not installed:

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
from repro_torch.kernels import LAUNCHES, _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decompress_score import selective_sum_cuda
from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda, embedding_bag_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.fused_gather_score import (
    dense_dims_per_chunk,
    fused_gather_score_cuda,
    ragged_dims_per_chunk,
    ragged_fused_gather_score_cuda,
    segmented_ragged_fused_gather_score_cuda,
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


FLASH_CASES = [
    # b, s, h, hkv, dh, causal, window
    (2, 256, 4, 2, 64, True, None),
    (1, 200, 4, 1, 64, True, None),  # S not a multiple of the kernel's tiles
    (1, 384, 2, 2, 128, True, 96),  # window: rows whose first tiles are masked
    (2, 128, 4, 4, 64, False, None),
    (1, 256, 8, 2, 128, False, 64),  # window without causality
    (1, 1000, 14, 2, 64, True, 512),
    # The bf16 kernel's 128-row blocks partly empty, windows at and around
    # its tiles, GQA ratios 1, 4 and 7, Dh 128.
    (1, 1, 4, 4, 64, True, None),
    (1, 65, 4, 1, 64, True, None),
    (1, 127, 7, 1, 64, True, 17),
    (1, 129, 4, 4, 128, True, 1),
    (1, 1000, 7, 1, 128, True, 128),
    (1, 1000, 4, 1, 64, True, 129),
    (2, 129, 4, 1, 64, False, 17),
]


def _flash_inputs(seed, b, s, h, hkv, dh, dtype, device):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (
        torch.randn(b, n, s, dh, generator=g).to(device=device, dtype=dtype)
        for n in (h, hkv, hkv)
    )
    return q, k, v


def _assert_flash_close(got, want):
    """float32: within 1e-4. bf16: element by element within one bf16 ulp
    of the larger of the two outputs (both are one rounding of float32
    values far closer than that), plus 1e-5 for outputs near 0."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        return
    got, want = got.float(), want.float()
    big = torch.maximum(got.abs(), want.abs())
    _, e = torch.frexp(big)
    ulp = torch.where(big > 0, torch.ldexp(torch.ones_like(big), e - 8), torch.zeros_like(big))
    excess = float(((got - want).abs() - ulp).max())
    assert excess <= 1e-5, f"an element differs by {excess} more than one bf16 ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,dh,causal,window", FLASH_CASES)
def test_flash_attention_kernel_on_card(card, dtype, b, s, h, hkv, dh, causal, window):
    q, k, v = _flash_inputs(b + s + dh, b, s, h, hkv, dh, dtype, card)
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _assert_flash_close(got, tref.flash_attention(q, k, v, causal=causal, window=window))


# A TP rank's heads over a (data, model) mesh: mixtral's prefill shard at
# model 4 (H 8, Hkv 2, window), the KV head replicated where Hkv < model
# (8 / 1), and a 12 / 2 split.
FLASH_TP_CASES = [
    (2, 512, 8, 2, 128, True, 256),
    (1, 300, 8, 1, 128, True, None),
    (1, 384, 12, 2, 128, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,dh,causal,window", FLASH_TP_CASES)
def test_flash_attention_kernel_at_tp_head_counts_on_card(card, dtype, b, s, h, hkv, dh, causal,
                                                          window):
    q, k, v = _flash_inputs(7 * h + hkv, b, s, h, hkv, dh, dtype, card)
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    _assert_flash_close(got, tref.flash_attention(q, k, v, causal=causal, window=window))


FLASH_EDGE_CASES = [
    # b, sq, skv, h, hkv, dh, causal, window, layout: "model" passes the
    # transposed views of [B, S, H, Dh] tensors, as ops.flash_attention does
    (1, 65, 300, 4, 1, 64, False, None, "contiguous"),  # Sq < Skv without causality
    (1, 127, 1000, 7, 1, 128, False, None, "contiguous"),
    (1, 1, 129, 4, 4, 64, False, 17, "contiguous"),
    (1, 300, 129, 4, 2, 64, True, None, "contiguous"),  # Sq > Skv: no tile skipped
    (2, 1000, 1000, 14, 2, 64, True, None, "model"),
    (1, 129, 129, 8, 2, 128, True, 128, "model"),
    (1, 65, 300, 7, 1, 64, False, None, "model"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,hkv,dh,causal,window,layout", FLASH_EDGE_CASES)
def test_flash_attention_kernel_edges_on_card(card, dtype, b, sq, skv, h, hkv, dh, causal, window, layout):
    g = torch.Generator().manual_seed(sq + skv + dh)
    shapes = ((b, h, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh))
    if layout == "model":
        q, k, v = (
            torch.randn(n, m, hh, d, generator=g).to(device=card, dtype=dtype).transpose(1, 2)
            for n, hh, m, d in shapes
        )
    else:
        q, k, v = (torch.randn(*shape, generator=g).to(device=card, dtype=dtype) for shape in shapes)
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    _assert_flash_close(got, tref.flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_bf16_unaligned_rows_on_card(card, dh):
    """bf16 rows that do not start on 16 bytes (the tensor cores load
    16-byte pieces) are copied by the wrapper, then launched: same result."""
    q, k, v = _flash_inputs(dh, 2, 192, 4, 2, dh, torch.bfloat16, card)
    buf = torch.zeros(3, 2, 4, 192, dh + 1, dtype=torch.bfloat16, device=card)
    qm, km, vm = buf[0, :, :, :, 1:], buf[1, :, :2, :, 1:], buf[2, :, :2, :, 1:]
    for dst, src in ((qm, q), (km, k), (vm, v)):
        dst.copy_(src)
    before = LAUNCHES["flash_attention"]
    got = flash_attention_cuda(qm, km, vm, causal=True)
    assert LAUNCHES["flash_attention"] == before + 1
    _assert_flash_close(got, tref.flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, None), (True, 40)])
def test_flash_attention_dispatch_pads_on_card(card, causal, window):
    """ops.flash_attention on [B, S, H, Dh] with S padded to the tile: the
    kernel reads the transposed views and matches the plain version."""
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 100, 6, 64, generator=g).to(card)
    k, v = (torch.randn(2, 100, 3, 64, generator=g).to(card) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal, window=window, tq=64, tk=64)
    want = ops.flash_attention(
        q, k, v, causal=causal, window=window, tq=64, tk=64, use_kernel=False
    )
    torch.testing.assert_close(got, want, **CARD_TOL)


@pytest.mark.cuda
def test_flash_attention_kernel_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 64, 32, device=card)
    with pytest.raises(ValueError, match="head_dim=32"):
        flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 2, 64, 64, device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_attention_cuda(q, q, q)


@pytest.mark.cuda
def test_lm_generate_kernel_executor_on_card(card):
    """A small bf16 LM with head_dim 64: prefill logits of the kernel and
    reference executors agree, one flash launch per layer per generate,
    tokens equal or first differing at a near-tie of the reference."""
    from repro_torch.models import KVCache, TransformerConfig, TransformerLM, init_params
    from repro_torch.serving import generate

    cfg = TransformerConfig(
        n_layers=3, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab=1024,
        head_dim=64, qkv_bias=True, tie_embeddings=True, sliding_window=96,
    )
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0), device=card)
    models = {ex: TransformerLM.from_params(cfg, params, executor=ex) for ex in ("kernel", "reference")}
    prompt = torch.randint(0, cfg.vocab, (2, 300), device=card)
    logits = {
        ex: m.prefill(prompt, KVCache.empty(cfg, 2, 316, device=card))[0] for ex, m in models.items()
    }
    torch.testing.assert_close(logits["kernel"], logits["reference"], rtol=0, atol=0.125)
    before = LAUNCHES["flash_attention"]
    got = generate(models["kernel"], prompt, max_new_tokens=16)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    want = generate(models["reference"], prompt, max_new_tokens=16)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    # Teacher forcing: both fed the reference's tokens, logits agree at every step.
    caches = {ex: m.prefill(prompt, KVCache.empty(cfg, 2, 316, device=card))[1] for ex, m in models.items()}
    for t in range(15):
        step = {}
        for ex, m in models.items():
            step[ex], caches[ex] = m.decode_step(want[:, t].long(), caches[ex])
        torch.testing.assert_close(step["kernel"], step["reference"], rtol=0, atol=0.125)
    for row in range(2):
        diff = torch.nonzero(got[row] != want[row]).flatten()
        if diff.numel():
            step = int(diff[0])
            cache = KVCache.empty(cfg, 2, 316, device=card)
            lg, cache = models["reference"].prefill(prompt, cache)
            for t in range(step):
                lg, cache = models["reference"].decode_step(want[:, t].long(), cache)
            top2 = torch.topk(lg[row].float(), 2).values
            assert float(top2[0] - top2[1]) <= 0.125


def _bag_inputs(card, seed, *, v=5000, d=64, s=300, l=13, idx_dtype=torch.int32, bad=0.0):
    """A table [V, D] and bags of L ids (a share ``bad`` of them outside
    [0, V), negative and >= V), weights with some zeros, on the card."""
    g = torch.Generator(device=card).manual_seed(seed)
    table = torch.randn(v, d, generator=g, device=card)
    idx = torch.randint(0, v, (s, l), generator=g, device=card)
    if bad:
        pick = torch.rand(s, l, generator=g, device=card) < bad
        far = torch.randint(v, 2 * v, (s, l), generator=g, device=card)
        idx = torch.where(pick, torch.where(idx % 2 == 0, far, -1 - idx), idx)
    w = torch.rand(s, l, generator=g, device=card)
    w = torch.where(torch.rand(s, l, generator=g, device=card) < 0.2, 0.0, w)
    return table, idx.to(idx_dtype).contiguous(), w


def _assert_bag_close(table, idx, w, got):
    want = tref.embedding_bag_bags(table, idx, w)
    limit = tref.embedding_bag_error_bound(table, idx, w)
    assert got.shape == want.shape and got.dtype == torch.float32
    excess = float(((got - want).abs() - limit).max())
    assert excess <= 0, f"an element differs from the plain version by {excess} beyond its limit"


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 18, 256, 257])
def test_embedding_bag_kernel_on_card(card, idx_dtype, d):
    table, idx, w = _bag_inputs(card, d, d=d, idx_dtype=idx_dtype, bad=0.1)
    before = LAUNCHES["embedding_bag"]
    got = embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag"] == before + 1
    _assert_bag_close(table, idx, w, got)


@pytest.mark.cuda
def test_embedding_bag_out_of_range_ids_add_exactly_zero_on_card(card):
    table, idx, w = _bag_inputs(card, 3, idx_dtype=torch.int64, bad=0.3)
    idx[0, :4] = torch.tensor([2**32 + 5, -(2**32) + 5, 2**62, -1], device=card)
    valid = (idx >= 0) & (idx < table.shape[0])
    got = embedding_bag_cuda(table, idx, w)
    in_range = embedding_bag_cuda(
        table, torch.where(valid, idx, 0), torch.where(valid, w, 0.0).contiguous()
    )
    assert torch.equal(got, in_range)  # fmaf(0, row, acc) == acc
    _assert_bag_close(table, idx, w, got)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [4, 16])
@pytest.mark.parametrize("dropped", [False, True])
def test_embedding_bag_on_a_ranks_row_range_on_card(card, ranks, dropped):
    """A rank's bag over its row range of a table split over ``ranks``:
    ids of the whole table shifted by the range's start, so 3/4 (15/16) of
    them fall outside [0, V); ``dropped`` gives them as -1, as the recsys
    models over a mesh pass them."""
    v = 1200
    table, _, w = _bag_inputs(card, ranks, v=v, d=18, s=512, l=100)
    g = torch.Generator(device=card).manual_seed(ranks)
    idx = torch.randint(0, ranks * v, (512, 100), generator=g, device=card) - v
    if dropped:
        idx = torch.where((idx >= 0) & (idx < v), idx, -1)
    idx = idx.to(torch.int32).contiguous()
    outside = float(((idx < 0) | (idx >= v)).float().mean())
    assert abs(outside - (ranks - 1) / ranks) < 0.02
    before = LAUNCHES["embedding_bag"]
    got = embedding_bag_cuda(table, idx, w)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag"] == before + 1
    _assert_bag_close(table, idx, w, got)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
def test_embedding_bag_unaligned_table_view_on_card(card, d):
    table, idx, w = _bag_inputs(card, 5, d=d)
    wide = torch.zeros(table.shape[0], d + 1, device=card)
    wide[:, 1:] = table
    shifted = torch.zeros(table.numel() + 1, device=card)
    shifted[1:] = table.reshape(-1)
    for view in (wide[:, 1:], shifted[1:].view(table.shape)):
        assert view.data_ptr() % 16 != 0
        got = embedding_bag_cuda(view, idx, w)
        _assert_bag_close(table, idx, w, got)


@pytest.mark.cuda
@pytest.mark.parametrize("s,l", [(0, 8), (16, 0)])
def test_embedding_bag_empty_bags_on_card(card, s, l):
    table = torch.randn(100, 32, device=card)
    before = LAUNCHES["embedding_bag"]
    out = ops.embedding_bag(
        table, bag_indices=torch.zeros((s, l), dtype=torch.int64, device=card),
        bag_weights=torch.ones(s, l, device=card), use_kernel=True,
    )
    assert tuple(out.shape) == (s, 32) and not bool(out.any())
    assert LAUNCHES["embedding_bag"] == before


@pytest.mark.cuda
def test_embedding_bag_kernel_rejects_what_it_does_not_take(card):
    table, idx, w = _bag_inputs(card, 9)
    with pytest.raises(ValueError, match="float32"):
        embedding_bag_cuda(table.double(), idx, w)
    with pytest.raises(ValueError, match="int32 or int64"):
        embedding_bag_cuda(table, idx.short(), w)
    with pytest.raises(ValueError, match="contiguous columns"):
        embedding_bag_cuda(table.t().contiguous().t(), idx, w)


def _assert_bag_grads_close(table, idx, w, g, dtable, dw):
    want_t, want_w = tref.embedding_bag_bags_backward(table, idx, w, g, weights_grad=True)
    limit_t, limit_w = tref.embedding_bag_backward_error_bound(table, idx, w, g)
    assert dtable.shape == table.shape and dw.shape == w.shape
    assert float(((dtable - want_t).abs() - limit_t).max()) <= 0
    assert float(((dw - want_w).abs() - limit_w).max()) <= 0
    valid = (idx >= 0) & (idx < table.shape[0])
    assert not bool(dw[~valid].any())


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 18, 256, 257])
def test_embedding_bag_backward_kernels_on_card(card, idx_dtype, d):
    """dtable and dw against the plain backward within
    ``ref.embedding_bag_backward_error_bound``; duplicate ids, zero
    weights, ids outside [0, V), a row named by 40 bags (a run longer than
    one 32-entry batch); two calls bit-identical; one launch per gradient."""
    table, idx, w = _bag_inputs(card, 20 + d, v=500, d=d, idx_dtype=idx_dtype, bad=0.1)
    idx[:40, 0] = 7
    idx[0, :5] = 3
    g = torch.randn(idx.shape[0], d, generator=torch.Generator(device=card).manual_seed(d),
                    device=card)
    before = LAUNCHES["embedding_bag_backward"]
    dtable, dw = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=True)
    again = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=True)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag_backward"] == before + 4
    assert torch.equal(dtable, again[0]) and torch.equal(dw, again[1])
    _assert_bag_grads_close(table, idx, w, g, dtable, dw)
    only_t = embedding_bag_backward_cuda(table, idx, w, g)
    assert only_t[1] is None and torch.equal(only_t[0], dtable)


@pytest.mark.cuda
def test_embedding_bag_autograd_on_card_uses_the_backward_kernels(card):
    table, idx, w = _bag_inputs(card, 31, d=32, idx_dtype=torch.int64, bad=0.05)
    t = table.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    out = ops.embedding_bag(t, bag_indices=idx, bag_weights=wr, use_kernel=True)
    g = torch.randn_like(out)
    before = dict(LAUNCHES)
    dt, dw = torch.autograd.grad(out, (t, wr), g)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag_backward"] == before["embedding_bag_backward"] + 2
    assert LAUNCHES["embedding_bag"] == before["embedding_bag"]
    _assert_bag_grads_close(table, idx, w, g, dt, dw)
    with pytest.raises(ValueError, match="grad"):
        embedding_bag_backward_cuda(table, idx, w, g.double())


@pytest.mark.cuda
def test_two_tower_kernel_executor_on_card(card):
    """Two-tower at REDUCED: the serve step and retrieval scores of the
    kernel and reference executors within 1e-5, two embedding-bag launches
    per serve step (one per tower) and none at the reference."""
    from repro_torch.configs import RECSYS_SHAPES_REDUCED
    from repro_torch.configs.two_tower_retrieval import REDUCED as cfg
    from repro_torch.models import TwoTower, init_params, serve_step

    params = init_params(cfg, torch.Generator(device=card).manual_seed(1), device=card)
    models = {ex: TwoTower.from_params(cfg, params, executor=ex) for ex in ("kernel", "reference")}
    assert TwoTower.from_params(cfg, params).executor == "kernel"
    g = torch.Generator(device=card).manual_seed(2)
    b = RECSYS_SHAPES_REDUCED["serve_bulk"].batch
    batch = {}
    for side, fields, vocab in (("user", cfg.user_fields, cfg.user_vocab),
                                ("item", cfg.item_fields, cfg.item_vocab)):
        batch[f"{side}_ids"] = torch.randint(0, vocab, (b, fields), generator=g, device=card)
        n = torch.randint(1, fields + 1, (b, 1), generator=g, device=card)
        batch[f"{side}_mask"] = (torch.arange(fields, device=card) < n).float()
    out, launches = {}, {}
    for ex, m in models.items():
        before = LAUNCHES["embedding_bag"]
        out[ex] = serve_step(m, RECSYS_SHAPES_REDUCED["serve_bulk"])(batch)
        torch.cuda.synchronize()
        launches[ex] = LAUNCHES["embedding_bag"] - before
    assert launches == {"kernel": 2, "reference": 0}
    torch.testing.assert_close(out["kernel"], out["reference"], rtol=1e-5, atol=1e-5)
    cand = models["reference"].item_embed(batch["item_ids"], batch["item_mask"])
    scores = {
        ex: serve_step(m, RECSYS_SHAPES_REDUCED["retrieval_cand"])(
            {"user_ids": batch["user_ids"][:1], "user_mask": batch["user_mask"][:1], "cand_emb": cand}
        )
        for ex, m in models.items()
    }
    torch.testing.assert_close(scores["kernel"], scores["reference"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# selective_sum and the dense fused kernel: one thread per row, a cp.async
# ring per warp, each token's rows split over several blocks
# ---------------------------------------------------------------------------

# name, nbits, dim, byte offset of the code view: D 20 rows are not a
# multiple of 4 (or 16) bytes; an offset of 1 takes the byte-copy path, 16
# the 16-byte path on a shifted base.
SCORE_CASES = [
    ("d128", 4, 128, 0),
    ("d128_b2", 2, 128, 0),
    ("d128_b8", 8, 128, 0),
    ("d20_b2", 2, 20, 0),
    ("d20_b4", 4, 20, 0),
    ("d20_b8", 8, 20, 0),
    ("off1", 4, 128, 1),
    ("off16", 4, 128, 16),
    ("d96_off4", 4, 96, 4),
]


def _code_view(card, codes, offset):
    """The codes on the card as a contiguous view ``offset`` bytes into a
    larger buffer."""
    flat = np.ascontiguousarray(codes).reshape(-1)
    buf = torch.zeros(flat.size + offset, dtype=torch.uint8, device=card)
    buf[offset:] = _t(flat).to(card)
    view = buf[offset:].view(codes.shape)
    assert view.data_ptr() % 16 == offset % 16 and view.is_contiguous()
    return view


def _skewed_sizes(rng, q, p, cap):
    """Probes of size 0 and 1, one at cap per token, one past cap."""
    sizes = rng.integers(0, 2, (q, p)).astype(np.int32)
    sizes[np.arange(q), rng.integers(0, p, q)] = cap
    sizes[0, -1] = cap + 517  # clamped to cap
    return sizes


@pytest.mark.cuda
@pytest.mark.parametrize("q", [3, 128])
@pytest.mark.parametrize("name,nbits,dim,offset", SCORE_CASES)
def test_selective_sum_rows_on_card(card, q, name, nbits, dim, offset):
    """N not a multiple of a warp's 32 rows nor of a block's range; one
    launch per call; the launch splits each token's rows as the twin says."""
    rng = np.random.default_rng(sum(map(ord, name)) + q)
    n, pb = 32 * 37 + 5, dim * nbits // 8
    packed = _code_view(card, rng.integers(0, 256, (q, n, pb), dtype=np.uint8), offset)
    v = _t(rng.standard_normal((q, dim, 1 << nbits)).astype(np.float32)).to(card)
    before = LAUNCHES["selective_sum"]
    got = selective_sum_cuda(packed, v, nbits=nbits, dim=dim)
    torch.cuda.synchronize()
    assert LAUNCHES["selective_sum"] == before + 1
    torch.testing.assert_close(got, tref.selective_sum(packed, v, nbits=nbits, dim=dim), **CARD_TOL)
    plan = _build.launch_plan("selective_sum", packed.data_ptr(), q, n, pb, dim, nbits)
    assert plan["blocks_per_token"] == tref.score_blocks_per_token(
        q, plan["resident_blocks"], rows=n
    )


@pytest.mark.cuda
@pytest.mark.parametrize("q", [4, 128])
@pytest.mark.parametrize("name,nbits,dim,offset", SCORE_CASES)
def test_fused_gather_score_skewed_on_card(card, q, name, nbits, dim, offset):
    """One probe per token at cap 1024 beside probes of size 1 and 0, one
    past cap; runs ending at the last row; exactly one launch; invalid
    slots exactly 0."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7 * q)
    p, cap, n_tokens = (32, 1024, 9000) if q == 4 else (8, 1024, 3000)
    pb = dim * nbits // 8
    codes = _code_view(card, rng.integers(0, 256, (n_tokens, pb), dtype=np.uint8), offset)
    sizes = _skewed_sizes(rng, q, p, cap)
    starts = rng.integers(0, n_tokens - cap + 1, (q, p)).astype(np.int32)
    starts[-1, 0], sizes[-1, 0] = n_tokens - cap, cap  # run ends at the last row
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    v = rng.standard_normal((q, dim, 1 << nbits)).astype(np.float32)
    args = (codes, *(_t(a).to(card) for a in (starts, sizes, pscore, v)))
    before = LAUNCHES["fused_gather_score"]
    got = fused_gather_score_cuda(*args, nbits=nbits, dim=dim, cap=cap)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_gather_score"] == before + 1
    want = tref.fused_gather_score(*args, nbits=nbits, dim=dim, cap=cap)
    torch.testing.assert_close(got, want, **CARD_TOL)
    invalid = torch.arange(cap, device=card) >= args[2].long().clamp(max=cap).unsqueeze(-1)
    assert bool((got[invalid] == 0).all())
    plan = _build.launch_plan("fused_gather_score", codes.data_ptr(), q, p, cap, pb, dim, nbits)
    assert plan["blocks_per_token"] == tref.score_blocks_per_token(q, plan["resident_blocks"])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["empty", "tiny"])
def test_fused_gather_score_sparse_tokens_on_card(card, kind):
    """Tokens whose probes are all empty (every block only writes zeros) or
    hold fewer rows than the token has blocks."""
    rng = np.random.default_rng(5)
    q, p, cap, n_tokens = 6, 5, 40, 200
    codes = _t(rng.integers(0, 256, (n_tokens, 64), dtype=np.uint8)).to(card)
    sizes = rng.integers(0, 3, (q, p)).astype(np.int32) * (kind == "tiny")
    starts = rng.integers(0, n_tokens - cap, (q, p)).astype(np.int32)
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    v = rng.standard_normal((q, 128, 16)).astype(np.float32)
    args = (codes, *(_t(a).to(card) for a in (starts, sizes, pscore, v)))
    got = fused_gather_score_cuda(*args, nbits=4, dim=128, cap=cap)
    torch.cuda.synchronize()
    want = tref.fused_gather_score(*args, nbits=4, dim=128, cap=cap)
    torch.testing.assert_close(got, want, **CARD_TOL)
    assert bool((got[torch.arange(cap, device=card) >= args[2].long().unsqueeze(-1)] == 0).all())


# ---------------------------------------------------------------------------
# the ragged worklist kernel on score_rows.cuh: tiles split in equal ranges
# over the card's resident blocks, one v-table load per run of a query token
# ---------------------------------------------------------------------------


def _ragged_worklist(rng, b, n, p, cap, tile, n_tokens, slack=5):
    """A worklist as ``engine._ragged_block`` builds it for ``b`` batch
    elements of ``n`` query tokens: skewed probe sizes (0, 1, in between
    and cap; runs kept inside the index), each element's padding tiles
    after its real ones, qtok offset by element -> (row0, nvalid, qtok,
    pscore) flat int32/float32 [b * W]."""
    sizes = rng.integers(0, cap + 1, (b, n, p)).astype(np.int32)
    sizes[rng.random((b, n, p)) < 0.3] = 1
    sizes[rng.random((b, n, p)) < 0.1] = 0
    sizes[:, :, 0] = cap
    starts = rng.integers(0, n_tokens - cap + 1, (b, n, p)).astype(np.int32)
    pscore = rng.standard_normal((b, n, p)).astype(np.float32)
    bound = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes, tile), amortized=False) + slack
    work = wl.build_tile_worklist(
        _t(starts), _t(sizes), _t(pscore), tile_c=tile, tiles_per_qtoken=bound
    )
    qtok = work.qtok + (torch.arange(b) * n).unsqueeze(-1).int()
    return tuple(a.reshape(-1).contiguous() for a in (work.row0, work.nvalid, qtok, work.pscore))


def _check_ragged(card, codes, work, v, *, nbits, dim, tile):
    """One launch, the plain version within 1e-4, invalid slots exactly 0,
    the launch's blocks and v-table chunk as the twins say."""
    args = (codes, *(a.to(card) for a in work), v)
    before = LAUNCHES["ragged_fused_gather_score"]
    got = ragged_fused_gather_score_cuda(*args, nbits=nbits, dim=dim, tile_c=tile)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_fused_gather_score"] == before + 1
    want = tref.ragged_fused_gather_score(*args, nbits=nbits, dim=dim, tile_c=tile)
    torch.testing.assert_close(got, want, **CARD_TOL)
    invalid = (torch.arange(tile, device=card) >= args[2].long().unsqueeze(-1)).reshape(-1)
    assert bool((got[invalid] == 0).all())
    w = work[0].numel()
    plan = _build.launch_plan(
        "ragged_fused_gather_score", codes.data_ptr(), w, codes.shape[1], dim, nbits
    )
    assert plan["blocks"] == tref.ragged_blocks(w, plan["resident_blocks"])
    assert plan["tiles_per_block"] <= tref.RAGGED_MAX_TILES
    assert plan["dims_per_chunk"] == _build.vtable_chunk(dim, nbits, 4 * (4 * tref.RAGGED_MAX_TILES + 1))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 16, 32, 64])
@pytest.mark.parametrize("name,nbits,dim,offset", SCORE_CASES)
def test_ragged_rows_on_card(card, tile, name, nbits, dim, offset):
    """Skewed clusters cut into tiles of 8 to 64 rows, padding tiles, code
    views at +1, +4 and +16 bytes, D 20 and 96."""
    rng = np.random.default_rng(sum(map(ord, name)) + tile)
    n_tokens, pb = 6000, dim * nbits // 8
    codes = _code_view(card, rng.integers(0, 256, (n_tokens, pb), dtype=np.uint8), offset)
    work = _ragged_worklist(rng, 1, 6, 9, 700, tile, n_tokens)
    v = _t(rng.standard_normal((6, dim, 1 << nbits)).astype(np.float32)).to(card)
    _check_ragged(card, codes, work, v, nbits=nbits, dim=dim, tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [2, 4, 8])
def test_ragged_batched_q128_on_card(card, nbits):
    """retrieve_batch's shape: 4 elements of 32 query tokens in one
    worklist, each element's padding between it and the next."""
    rng = np.random.default_rng(128 + nbits)
    n_tokens, dim = 40000, 128
    codes = _t(rng.integers(0, 256, (n_tokens, dim * nbits // 8), dtype=np.uint8)).to(card)
    work = _ragged_worklist(rng, 4, 32, 16, 1024, 32, n_tokens)
    v = _t(rng.standard_normal((128, dim, 1 << nbits)).astype(np.float32)).to(card)
    _check_ragged(card, codes, work, v, nbits=nbits, dim=dim, tile=32)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 32])
def test_ragged_materialize_form_on_card(card, tile):
    """The materialize route: a gathered copy of the worklist's rows,
    row0 = w * tile_c."""
    rng = np.random.default_rng(tile)
    n_tokens, dim = 5000, 128
    codes = _t(rng.integers(0, 256, (n_tokens, 64), dtype=np.uint8)).to(card)
    row0, nvalid, qtok, pscore = _ragged_worklist(rng, 2, 8, 7, 300, tile, n_tokens)
    work = wl.TileWorklist(row0.to(card), nvalid.to(card), qtok.to(card), pscore.to(card))
    pos, _ = wl.worklist_slot_positions(work, tile_c=tile, n_tokens=n_tokens)
    gathered = codes[pos].contiguous()
    flat_row0 = torch.arange(row0.numel(), dtype=torch.int32) * tile
    v = _t(rng.standard_normal((16, dim, 16)).astype(np.float32)).to(card)
    got = _check_ragged(card, gathered, (flat_row0, nvalid, qtok, pscore), v, nbits=4, dim=dim, tile=tile)
    direct = ragged_fused_gather_score_cuda(
        codes, *(a.to(card) for a in (row0, nvalid, qtok, pscore)), v, nbits=4, dim=dim, tile_c=tile
    )
    torch.testing.assert_close(got, direct, **CARD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [1, 37, 5000])
def test_ragged_all_padding_on_card(card, w):
    """A worklist of padding tiles only: every slot exactly 0."""
    codes = torch.randint(0, 256, (100, 64), dtype=torch.uint8, device=card)
    zeros = torch.zeros(w, dtype=torch.int32)
    work = (zeros, zeros, zeros, torch.zeros(w))
    v = torch.randn(3, 128, 16, device=card)
    got = _check_ragged(card, codes, work, v, nbits=4, dim=128, tile=32)
    assert not bool(got.any())


@pytest.mark.cuda
def test_ragged_unsorted_qtok_and_edges_on_card(card):
    """qtok in any order and outside [0, Q) (those tiles give zeros), nvalid
    past tile_c and negative, rows outside the index (their slots 0)."""
    rng = np.random.default_rng(3)
    n_tokens, w, tile = 3000, 900, 16
    codes = _t(rng.integers(0, 256, (n_tokens, 64), dtype=np.uint8)).to(card)
    row0 = rng.integers(0, n_tokens - tile, w).astype(np.int32)
    nvalid = rng.integers(-3, tile + 5, w).astype(np.int32)
    qtok = rng.integers(-2, 9, w).astype(np.int32)
    row0[:3] = (-5, n_tokens - 4, n_tokens + 10)
    nvalid[:3] = tile
    qtok[:3] = 0
    pscore = rng.standard_normal(w).astype(np.float32)
    v = _t(rng.standard_normal((7, 128, 16)).astype(np.float32)).to(card)
    args = (codes, *(_t(a).to(card) for a in (row0, nvalid, qtok, pscore)), v)
    got = ragged_fused_gather_score_cuda(*args, nbits=4, dim=128, tile_c=tile).cpu()
    want = tref.ragged_fused_gather_score_split(
        *(a.cpu() for a in args), nbits=4, dim=128, tile_c=tile, blocks=7
    )
    torch.testing.assert_close(got, want, **CARD_TOL)
    out = got.reshape(w, tile)
    assert bool((out[0, :5] == 0).all()) and bool((out[0, 5:] != 0).all())
    assert bool((out[1, 4:] == 0).all()) and bool((out[2] == 0).all())
    dead = (qtok < 0) | (qtok >= 7) | (nvalid <= 0)
    assert bool((out[torch.from_numpy(dead)] == 0).all())


# ---------------------------------------------------------------------------
# v-tables wider than one block's shared memory (nbits 8 from D 208): the
# three scoring kernels walk the dimensions in chunks
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dim,offset", [(256, 0), (256, 1), (224, 16), (520, 0)])
def test_wide_vtable_all_three_kernels_on_card(card, dim, offset):
    nbits, q, cap, p = 8, 3, 200, 6
    rng = np.random.default_rng(dim + offset)
    n_tokens, pb = 3000, dim
    codes = _code_view(card, rng.integers(0, 256, (n_tokens, pb), dtype=np.uint8), offset)
    v = _t(rng.standard_normal((q, dim, 256)).astype(np.float32)).to(card)
    dc = _build.vtable_chunk(dim, nbits)
    assert dc < dim

    packed = _code_view(card, rng.integers(0, 256, (q, 1037, pb), dtype=np.uint8), offset)
    got = selective_sum_cuda(packed, v, nbits=nbits, dim=dim)
    torch.testing.assert_close(got, tref.selective_sum(packed, v, nbits=nbits, dim=dim), **CARD_TOL)
    plan = _build.launch_plan("selective_sum", packed.data_ptr(), q, 1037, pb, dim, nbits)
    assert plan["dims_per_chunk"] == dc

    sizes = _skewed_sizes(rng, q, p, cap)
    starts = rng.integers(0, n_tokens - cap + 1, (q, p)).astype(np.int32)
    pscore = rng.standard_normal((q, p)).astype(np.float32)
    args = (codes, *(_t(a).to(card) for a in (starts, sizes, pscore)), v)
    got = fused_gather_score_cuda(*args, nbits=nbits, dim=dim, cap=cap)
    torch.testing.assert_close(got, tref.fused_gather_score(*args, nbits=nbits, dim=dim, cap=cap), **CARD_TOL)
    plan = _build.launch_plan("fused_gather_score", codes.data_ptr(), q, p, cap, pb, dim, nbits)
    assert plan["dims_per_chunk"] == _build.vtable_chunk(dim, nbits, 4 * (3 * p + 1))

    work = _ragged_worklist(rng, 1, q, p, cap, 32, n_tokens)
    _check_ragged(card, codes, work, v, nbits=nbits, dim=dim, tile=32)


def _token_rows(assign, packed):
    """Each token's code row of a CSR-by-cluster index whose token order
    within a cluster is the token order (the stable sort by assignment)."""
    rows = np.empty_like(packed)
    rows[np.argsort(assign, kind="stable")] = packed
    return rows


@pytest.mark.cuda
def test_build_on_card_matches_cpu_build(card):
    from repro_torch.core import IndexBuildConfig, build_index, kmeans
    from repro_torch.data import make_corpus
    from repro_torch.store import array_chunks, build_index_chunked, builder

    corpus = make_corpus(n_docs=800, mean_doc_len=20, seed=3, topic_skew=1.6, n_topics=64)
    STATS_ROWS = -(-builder.STATS_VALUES // corpus.emb.shape[1])
    cfg = IndexBuildConfig(n_centroids=128, nbits=4, kmeans_iters=4)
    args = (corpus.emb, corpus.token_doc_ids, corpus.n_docs, cfg)
    on_card, on_cpu = build_index(*args, device=card), build_index(*args, device="cpu")
    np.testing.assert_allclose(on_card.centroids.cpu().numpy(), on_cpu.centroids.numpy(), atol=1e-5)
    again = build_index_chunked(
        array_chunks(corpus.emb, corpus.token_doc_ids, 997), corpus.n_docs, cfg, device=card
    )
    for name in ("centroids", "packed_codes", "token_doc_ids", "cluster_offsets", "bucket_cutoffs"):
        assert torch.equal(getattr(again, name), getattr(on_card, name)), name

    # The CPU's passes 2-3 from the card's centroids.
    n, cent_card = corpus.n_tokens, on_card.centroids
    cent = cent_card.cpu()
    normed = builder.normalized_chunks(array_chunks(corpus.emb, corpus.token_doc_ids, 4096), "cpu")
    assign, docs = np.empty(n, np.int32), np.empty(n, np.int32)
    packed = np.empty((n, on_card.packed_codes.shape[1]), np.uint8)
    small = builder.encode_corpus(
        normed, cent, cfg.nbits, n, assign_out=assign, packed_out=packed, docs_out=docs
    )
    card_assign = kmeans.assign_clusters(
        kmeans.l2_normalize(torch.from_numpy(corpus.emb).to(card)), cent_card
    ).cpu().numpy()
    differ = np.flatnonzero(card_assign != assign)
    top2 = np.sort(kmeans.l2_normalize(torch.from_numpy(corpus.emb)).numpy() @ cent.numpy().T, -1)
    assert (top2[differ, -1] - top2[differ, -2] <= 1e-6).all(), "a non-tie assignment differs"
    print(f"build: {differ.size} of {n} assignments differ between card and CPU, each a near-tie")
    if differ.size == 0:
        for name, got in small.items():
            np.testing.assert_array_equal(got, getattr(on_card, name).cpu().numpy(), err_msg=name)
        np.testing.assert_array_equal(packed, on_card.packed_codes.cpu().numpy())
        np.testing.assert_array_equal(docs, on_card.token_doc_ids.cpu().numpy())
        assert int(small["cluster_sizes"].max()) == on_card.cap
    elif differ.min() >= STATS_ROWS:  # the codec's residual sample is unaffected
        np.testing.assert_array_equal(small["bucket_cutoffs"], on_card.bucket_cutoffs.cpu().numpy())
        agree = card_assign == assign
        np.testing.assert_array_equal(
            _token_rows(card_assign, on_card.packed_codes.cpu().numpy())[agree],
            _token_rows(assign, packed)[agree],
        )

    # A Lloyd step on the card gives the same bits twice.
    pts = kmeans.l2_normalize(torch.from_numpy(corpus.emb[:4000]).to(card))
    reseed = torch.randint(0, 4000, (128,), generator=torch.Generator().manual_seed(0))
    first = kmeans.lloyd_step(pts, cent_card, reseed)
    assert torch.equal(first, kmeans.lloyd_step(pts, cent_card, reseed))


# ---------------------------------------------------------------------------
# the segmented entry of the ragged kernel: one launch over a worklist that
# spans a base and its delta segments
# ---------------------------------------------------------------------------


def _segment_geometry(rng, n_clusters, rows):
    """CSR geometry of a segment of ``rows`` rows over ``n_clusters``
    clusters -> (offsets i32[C + 1], sizes i32[C])."""
    assign = np.sort(rng.integers(0, n_clusters, rows))
    sizes = np.bincount(assign, minlength=n_clusters).astype(np.int32)
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32), sizes


def _segmented_worklist(rng, geoms, b, n, p, tile, slack=3):
    """A worklist as the segmented ragged path builds it: ``b`` elements of
    ``n`` tokens probing ``p`` clusters each, every probe expanded into its
    per-segment runs (some zeroed, as masked tokens and dead clusters are)
    -> (row0, nvalid, seg, qtok, pscore) flat [b * W]."""
    n_seg, c = len(geoms), geoms[0][1].shape[0]
    cids = rng.integers(0, c, (b, n, p))
    starts = np.stack([off[cids] for off, _ in geoms], -1).reshape(b, n, -1)
    sizes = np.stack([sz[cids] for _, sz in geoms], -1).reshape(b, n, -1)
    sizes[rng.random(sizes.shape) < 0.1] = 0
    pscore = np.repeat(rng.standard_normal((b, n, p)).astype(np.float32), n_seg, axis=-1)
    segs = np.broadcast_to(np.arange(n_seg, dtype=np.int32), (b, n, p, n_seg)).reshape(b, n, -1)
    bound = wl.needed_worklist_tiles(wl.probe_tile_counts(sizes, tile)) + slack
    work = wl.build_tile_worklist(
        _t(starts), _t(sizes), _t(pscore), seg=_t(segs), tile_c=tile, tiles_per_qtoken=bound
    )
    qtok = work.qtok + (torch.arange(b) * n).unsqueeze(-1).int()
    return tuple(
        a.reshape(-1).contiguous() for a in (work.row0, work.nvalid, work.seg, qtok, work.pscore)
    )


def _check_segmented(card, codes_list, work, v, *, nbits, dim, tile):
    """One launch; the plain version within 1e-4 and invalid slots exactly
    0; bit for bit the sum of one single-array launch per segment with the
    other segments' tiles at nvalid 0 (the JAX op's schedule), and the
    single-array kernel over the segments laid end to end."""
    row0, nvalid, seg, qtok, pscore = (a.to(card) for a in work)
    kw = dict(nbits=nbits, dim=dim, tile_c=tile)
    before = dict(LAUNCHES)
    got = segmented_ragged_fused_gather_score_cuda(
        codes_list, row0, nvalid, seg, qtok, pscore, v, **kw
    )
    torch.cuda.synchronize()
    assert LAUNCHES["segmented_ragged_fused_gather_score"] == before["segmented_ragged_fused_gather_score"] + 1
    assert LAUNCHES["ragged_fused_gather_score"] == before["ragged_fused_gather_score"]
    want = tref.segmented_ragged_fused_gather_score(
        codes_list, row0, nvalid, seg, qtok, pscore, v, **kw
    )
    torch.testing.assert_close(got, want, **CARD_TOL)
    invalid = (torch.arange(tile, device=card) >= nvalid.long().unsqueeze(-1)).reshape(-1)
    assert bool((got[invalid] == 0).all())
    replay = None
    for s, codes in enumerate(codes_list):
        if codes.shape[0] == 0:
            continue
        nv_s = torch.where(seg == s, nvalid, 0)
        out_s = ragged_fused_gather_score_cuda(codes, row0, nv_s, qtok, pscore, v, **kw)
        replay = out_s if replay is None else replay + out_s
    assert torch.equal(got, replay)
    starts = torch.tensor(
        np.concatenate([[0], np.cumsum([c.shape[0] for c in codes_list])[:-1]]), device=card
    )
    flat = torch.cat([c.reshape(-1, c.shape[-1]) for c in codes_list])
    single = ragged_fused_gather_score_cuda(
        flat, (row0 + starts[seg.long()]).int(), nvalid, qtok, pscore, v, **kw
    )
    assert torch.equal(got, single)
    return got


SEGMENT_ROWS = (5000, 7, 0, 1200, 300)  # a delta smaller than a tile, an empty one


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,dim", [(2, 128), (4, 128), (8, 128), (4, 32)])
@pytest.mark.parametrize("tile", [8, 32])
def test_segmented_ragged_kernel_on_card(card, nbits, dim, tile):
    rng = np.random.default_rng(nbits * 100 + dim + tile)
    pb = dim * nbits // 8
    geoms = [_segment_geometry(rng, 64, n) for n in SEGMENT_ROWS]
    codes = [_t(rng.integers(0, 256, (n, pb), dtype=np.uint8)).to(card) for n in SEGMENT_ROWS]
    work = _segmented_worklist(rng, geoms, 2, 8, 6, tile)
    v = _t(rng.standard_normal((16, dim, 1 << nbits)).astype(np.float32)).to(card)
    _check_segmented(card, codes, work, v, nbits=nbits, dim=dim, tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,dim,offsets", [
    (4, 128, (1, 16, 0, 1, 16)),  # code views at +1 and +16 bytes
    (8, 256, (0, 0, 0, 0, 0)),  # a v-table walked in chunks of dims
    (8, 256, (16, 1, 0, 16, 0)),
])
def test_segmented_ragged_views_and_wide_vtable_on_card(card, nbits, dim, offsets):
    rng = np.random.default_rng(dim + sum(offsets))
    pb = dim * nbits // 8
    geoms = [_segment_geometry(rng, 32, n) for n in SEGMENT_ROWS]
    codes = [
        _code_view(card, rng.integers(0, 256, (n, pb), dtype=np.uint8), off)
        if n else torch.zeros((0, pb), dtype=torch.uint8, device=card)
        for n, off in zip(SEGMENT_ROWS, offsets)
    ]
    work = _segmented_worklist(rng, geoms, 1, 6, 5, 32)
    v = _t(rng.standard_normal((6, dim, 1 << nbits)).astype(np.float32)).to(card)
    _check_segmented(card, codes, work, v, nbits=nbits, dim=dim, tile=32)


@pytest.mark.cuda
def test_segmented_ragged_edges_on_card(card):
    """Tiles of a segment outside [0, S), rows past their segment's end and
    an all-padding worklist: those slots exactly 0; a single segment equals
    the single-array kernel."""
    rng = np.random.default_rng(5)
    codes = [_t(rng.integers(0, 256, (n, 64), dtype=np.uint8)).to(card) for n in (300, 40)]
    w, tile = 6, 16
    row0 = torch.tensor([0, 10, 290, 30, 0, 0], dtype=torch.int32, device=card)
    nvalid = torch.full((w,), tile, dtype=torch.int32, device=card)
    seg = torch.tensor([0, 1, 0, 1, -1, 2], dtype=torch.int32, device=card)
    qtok = torch.zeros(w, dtype=torch.int32, device=card)
    pscore = torch.ones(w, device=card)
    v = torch.randn(1, 128, 16, device=card)
    out = segmented_ragged_fused_gather_score_cuda(
        codes, row0, nvalid, seg, qtok, pscore, v, nbits=4, dim=128, tile_c=tile
    ).reshape(w, tile)
    assert bool((out[:2] != 0).all())
    assert bool((out[2, :10] != 0).all()) and bool((out[2, 10:] == 0).all())  # rows 300.. of 300
    assert bool((out[3, :10] != 0).all()) and bool((out[3, 10:] == 0).all())  # rows 40.. of 40
    assert bool((out[4:] == 0).all())
    zeros = torch.zeros(37, dtype=torch.int32, device=card)
    pad = segmented_ragged_fused_gather_score_cuda(
        codes, zeros, zeros, zeros, zeros, torch.zeros(37, device=card), v,
        nbits=4, dim=128, tile_c=32,
    )
    assert not bool(pad.any())
    work = _ragged_worklist(rng, 1, 4, 5, 60, 16, 300)
    one = segmented_ragged_fused_gather_score_cuda(
        codes[:1], work[0].to(card), work[1].to(card), torch.zeros_like(work[0]).to(card),
        work[2].to(card), work[3].to(card), v.expand(4, -1, -1).contiguous(),
        nbits=4, dim=128, tile_c=16,
    )
    single = ragged_fused_gather_score_cuda(
        codes[0], *(a.to(card) for a in work), v.expand(4, -1, -1).contiguous(),
        nbits=4, dim=128, tile_c=16,
    )
    assert torch.equal(one, single)


@pytest.mark.cuda
def test_segmented_wrapper_checks_its_inputs(card):
    codes = [torch.zeros((10, 64), dtype=torch.uint8, device=card)]
    a = torch.zeros(4, dtype=torch.int32, device=card)
    v = torch.zeros(1, 128, 16, device=card)
    with pytest.raises(ValueError, match="dtype"):
        segmented_ragged_fused_gather_score_cuda(
            codes, a, a, a.long(), a, a.float(), v, nbits=4, dim=128, tile_c=8
        )
    with pytest.raises(ValueError, match="packed_list\\[1\\]"):
        segmented_ragged_fused_gather_score_cuda(
            codes + [torch.zeros((10, 32), dtype=torch.uint8, device=card)],
            a, a, a, a, a.float(), v, nbits=4, dim=128, tile_c=8,
        )


@pytest.fixture(scope="module")
def segmented_store(tmp_path_factory):
    """A store built, grown (a delta of 40 docs, one of 2 docs) and
    tombstoned by the port on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from repro_torch.core import IndexBuildConfig, build_index
    from repro_torch.data import make_corpus
    from repro_torch.store import add_documents, delete_documents, save_index

    path = str(tmp_path_factory.mktemp("seg") / "idx")
    c1 = make_corpus(n_docs=300, mean_doc_len=14, seed=31)
    idx = build_index(c1.emb, c1.token_doc_ids, c1.n_docs,
                      IndexBuildConfig(n_centroids=64, nbits=4, kmeans_iters=3), device="cuda")
    save_index(idx, path)
    for n, seed in ((40, 32), (2, 33)):
        c = make_corpus(n_docs=n, mean_doc_len=14, seed=seed)
        add_documents(path, c.emb, c.token_doc_ids, c.n_docs, device="cuda")
    return path, delete_documents(path, [3, 305, 341])


@pytest.mark.cuda
@pytest.mark.parametrize("gather,layout", [
    ("fused", "ragged"), ("materialize", "ragged"), ("fused", "dense"), ("materialize", "dense"),
])
@pytest.mark.parametrize("filtered", [False, True])
def test_segmented_retrieve_kernel_vs_reference_on_card(card, segmented_store, gather, layout, filtered):
    """Kernel and reference executors over base + 2 deltas give the same
    doc ids; (fused, ragged) is one segmented launch per retrieve."""
    from repro_torch.core.docfilter import DocFilter
    from repro_torch.data import make_corpus, make_queries

    path, tomb = segmented_store
    r = Retriever.from_store(path, device=card)
    assert r.is_segmented and r.index.n_segments == 3
    dfilter = DocFilter.tombstones(tomb, r.n_docs) if filtered else None
    corpus = make_corpus(n_docs=30, mean_doc_len=10, seed=7)
    q, qmask, _ = make_queries(corpus, n_queries=4, seed=8)
    got = {}
    for executor in ("kernel", "reference"):
        plan = r.plan(WarpSearchConfig(nprobe=8, k=10, gather=gather, layout=layout,
                                       executor=executor), dfilter=dfilter)
        before = dict(LAUNCHES)
        res = [plan.retrieve(q[i], qmask[i]) for i in range(4)]
        torch.cuda.synchronize()
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        if executor == "reference":
            assert not any(launched.values())
        elif (gather, layout) == ("fused", "ragged"):
            assert launched["segmented_ragged_fused_gather_score"] == 4
        got[executor] = [(x.doc_ids.cpu().numpy(), x.scores.cpu().numpy()) for x in res]
        batch = plan.retrieve_batch(q, qmask)
        for i in range(4):
            np.testing.assert_array_equal(batch.doc_ids[i].cpu().numpy(), got[executor][i][0])
    for (ki, ks), (ri, rs) in zip(got["kernel"], got["reference"]):
        np.testing.assert_array_equal(ki, ri)
        np.testing.assert_allclose(ks, rs, rtol=1e-4, atol=1e-4)
        assert not set(tomb) & set(ki.tolist()) or not filtered


# ---------------------------------------------------------------------------
# the fused kernels' measurement carve-outs, the autotune sweep and the
# staging/scoring split
# ---------------------------------------------------------------------------

# nbits, dim: D 256 at nbits 8 walks the v-table in chunks of dimensions.
PROBE_CASES = [(2, 32), (4, 32), (8, 32), (8, 256)]
SPLIT_KEYS = {
    "kernel_full_ms", "dma_ms", "compute_ms", "overlap_frac", "probe_tile_c", "probe_buffering",
}


def _check_probes(launch, name, invalid, dma_want):
    """``probe="full"`` equals the product call bit for bit and "dma" its
    plain twin (``ref.*_dma``: the probe scores plus each staged row's XOR
    fold), so every row was staged; "dma" and "compute" give its shape and
    dtype, finite values and exactly 0 at the invalid slots; each launch
    counts under its own name."""
    before = dict(LAUNCHES)
    base = launch(None)
    outs = {p: launch(p) for p in ("full", "dma", "compute")}
    torch.cuda.synchronize()
    assert torch.equal(outs["full"], base)
    assert torch.equal(outs["dma"], dma_want)
    for p in ("dma", "compute"):
        assert outs[p].shape == base.shape and outs[p].dtype == torch.float32
        assert bool(torch.isfinite(outs[p]).all())
        assert bool((outs[p][invalid] == 0).all())
    launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    assert launched[name] == 1
    assert all(launched[f"{name}:{p}"] == 1 for p in ("full", "dma", "compute"))


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,dim", PROBE_CASES)
def test_fused_gather_score_probes_on_card(card, nbits, dim):
    codes, v, starts, sizes, pscore = _inputs(
        90 + nbits + dim, nbits=nbits, dim=dim, n_tokens=4000, cap=24
    )
    args = tuple(_t(a).to(card) for a in (codes, starts, sizes, pscore, v))
    invalid = torch.arange(24, device=card) >= args[2].long().unsqueeze(-1)
    dma_want = tref.fused_gather_score_dma(
        *args[:4], nbits=nbits, dim=dim, cap=24,
        dims_per_chunk=dense_dims_per_chunk(dim, nbits, args[1].shape[1]),
    )
    _check_probes(
        lambda p: fused_gather_score_cuda(*args, nbits=nbits, dim=dim, cap=24, probe=p),
        "fused_gather_score", invalid, dma_want,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [8, 32])
@pytest.mark.parametrize("nbits,dim", PROBE_CASES)
def test_ragged_fused_gather_score_probes_on_card(card, nbits, dim, tile):
    codes, v, starts, sizes, pscore = _inputs(95 + nbits + dim, nbits=nbits, dim=dim)
    work = _worklist(starts, sizes, pscore, tile, slack=3)  # padding tiles
    args = (_t(codes).to(card), *(a.to(card) for a in work), _t(v).to(card))
    invalid = (torch.arange(tile, device=card) >= args[2].long().unsqueeze(-1)).reshape(-1)
    dma_want = tref.ragged_fused_gather_score_dma(
        *args[:5], nbits=nbits, dim=dim, tile_c=tile, n_q=args[5].shape[0],
        dims_per_chunk=ragged_dims_per_chunk(dim, nbits),
    )
    _check_probes(
        lambda p: ragged_fused_gather_score_cuda(*args, nbits=nbits, dim=dim, tile_c=tile, probe=p),
        "ragged_fused_gather_score", invalid, dma_want,
    )


@pytest.mark.cuda
def test_autotune_sweep_two_points_on_card(card, tmp_path):
    """A two-point sweep on the fixture index: the table's schema, its
    file, and the plans it steers (the card's, never a CPU plan)."""
    from repro_torch.kernels import autotune, autotune_sweep

    fdir, _, _ = _fixture()
    store = os.path.join(fdir, "store")
    idx = Retriever.from_store(store, device=card).index
    q, qmask = autotune_sweep.sweep_queries(idx, 8, seed=0)
    out = tmp_path / "table.json"
    table, rows = autotune_sweep.run(
        idx, q, qmask, tiles=(16,), nprobe=4, qtokens=8, warmup=1, iters=3,
        out_path=str(out), install=False, log=lambda msg: None,
    )
    dense_tile = ops.resolve_tile_c(idx.cap, layout="dense")
    assert [(r["layout"], r["tile_c"]) for r in rows] == [("dense", dense_tile), ("ragged", 16)]
    for r in rows:
        assert min(r["full_ms"], r["dma_ms"], r["compute_ms"]) > 0
        assert 0.0 <= r["overlap_frac"] <= 1.0
    doc = json.loads(out.read_text())
    assert doc["autotune_table_version"] == 1
    assert sorted(doc["entries"]) == sorted(table.entries) and len(table) == 2
    for key, e in doc["entries"].items():
        assert set(e) == {"tile_c", "buffering", "dma_us", "compute_us", "total_us", "measured_on"}
        assert e["measured_on"] == "cuda" and e["buffering"] == "double"
        assert e["tile_c"] == (16 if key.startswith("layout=ragged") else dense_tile)
    assert autotune.AutotuneTable.load(str(out)).to_json() == table.to_json()
    autotune.set_default_table(table)
    try:
        cfg = WarpSearchConfig(nprobe=4, k=5, layout="ragged", gather="fused")
        on_card = Retriever.from_store(store, device=card).plan(cfg).describe()
        on_cpu = Retriever.from_store(store, device="cpu").plan(cfg).describe()
    finally:
        autotune.set_default_table(None)
    assert (on_card["tile_source"], on_card["tile_c"]) == ("autotune", 16)
    assert on_cpu["tile_source"] == "heuristic"


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_kernel_dma_compute_split_on_card(card, layout):
    """The split's keys; a traced retrieve with probes armed is bit for
    bit the untraced one, launches the product kernel once and carries
    the split on its gather_score span."""
    from repro_torch import obs
    from repro_torch.core import engine

    fdir, _, z = _fixture()
    r = Retriever.from_store(os.path.join(fdir, "store"), device=card)
    plan = r.plan(WarpSearchConfig(nprobe=8, k=10, gather="fused", layout=layout, executor="kernel"))
    q, m = _t(z["q"][:2]).to(card), _t(z["qmask"][:2]).to(card)
    sel = engine.select_probes(r.index, q, m, plan.config)
    cfg = plan._cfg_at(plan._pick(sel, m) if plan.adaptive else None)
    split = engine.kernel_dma_compute_split(r.index, q, m, sel, cfg)
    assert set(split) == SPLIT_KEYS and 0.0 <= split["overlap_frac"] <= 1.0
    assert split["probe_tile_c"] == cfg.tile_c and split["kernel_full_ms"] > 0
    assert split["kernel_full_ms"] <= split["dma_ms"] + split["compute_ms"]
    name = "fused_gather_score" if layout == "dense" else "ragged_fused_gather_score"
    base = plan.retrieve(q[0], m[0])
    tracer = obs.set_tracer(obs.Tracer())
    obs.set_kernel_probes(True)
    before = dict(LAUNCHES)
    try:
        got = plan.retrieve(q[0], m[0])
        torch.cuda.synchronize()
    finally:
        obs.disable_all()
    assert LAUNCHES[name] - before[name] == 1
    assert LAUNCHES[f"{name}:dma"] > before[f"{name}:dma"]
    assert torch.equal(got.doc_ids, base.doc_ids) and torch.equal(got.scores, base.scores)
    (span,) = [e for e in tracer.events() if e.name == "gather_score"]
    assert SPLIT_KEYS <= set(span.args) and 0.0 <= span.args["overlap_frac"] <= 1.0


def _check_bag_backward(card, table, idx, w, g):
    """Both gradients within their limits, two calls bit for bit, one launch
    per gradient, the C entry's sort and row offsets equal to the plain
    preparation (``ref.bag_sort``, ``ref.bag_csr``) exactly."""
    before = LAUNCHES["embedding_bag_backward"]
    scratch = {}
    dtable, dw = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=True, scratch=scratch)
    again = embedding_bag_backward_cuda(table, idx, w, g, weights_grad=True)
    torch.cuda.synchronize()
    assert LAUNCHES["embedding_bag_backward"] == before + 4
    assert torch.equal(dtable, again[0]) and torch.equal(dw, again[1])
    _assert_bag_grads_close(table, idx, w, g, dtable, dw)
    key, pos = tref.bag_sort(idx, table.shape[0])
    offsets, positions = tref.bag_csr(idx, table.shape[0])
    assert torch.equal(scratch["keys"].long(), key) and torch.equal(scratch["positions"].long(), pos)
    assert torch.equal(scratch["offsets"].long(), offsets)
    assert torch.equal(scratch["positions"][: positions.numel()].long(), positions)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 2, 18, 32, 33, 256])
def test_embedding_bag_backward_redesign_on_card(card, idx_dtype, d):
    """The sort on the card, the rows pass and the slots pass at every
    width tier (one thread per row and per slot at D <= 32, a warp wider):
    S * L = 260,000 ids (64 tiles of the sort), 10% outside [0, V) on both
    sides, duplicates, zero weights, and one row named 100,000 times (at
    every other flat position below 200,000: the warp takes it at narrow D)."""
    table, idx, w = _bag_inputs(card, 40 + d, v=5000, d=d, s=20_000, l=13, idx_dtype=idx_dtype,
                                bad=0.1)
    flat = idx.view(-1)
    flat[0:200_000:2] = 7
    g = torch.randn(idx.shape[0], d, generator=torch.Generator(device=card).manual_seed(d),
                    device=card)
    _check_bag_backward(card, table, idx, w, g)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [2**16 - 1, 2**16, 2**16 + 1])
@pytest.mark.parametrize("wide", [False, True])
def test_embedding_bag_backward_sort_widths_on_card(card, monkeypatch, v, wide):
    """V at 2^16 - 1, 2^16 and 2^16 + 1 (16 then 17 key bits: 2 passes of 8,
    then 3 of 6), with 32-bit and, forced, 64-bit keys and positions."""
    from repro_torch.kernels import embedding_bag

    if wide:
        monkeypatch.setattr(embedding_bag, "SORT_32BIT_BELOW", 0)
    table, idx, w = _bag_inputs(card, v, v=v, d=18, s=3000, l=29, idx_dtype=torch.int64, bad=0.05)
    idx[:, 0] = v - 1  # the last row, and keys up to V itself
    g = torch.randn(idx.shape[0], 18, generator=torch.Generator(device=card).manual_seed(v),
                    device=card)
    scratch = {}
    embedding_bag_backward_cuda(table, idx, w, g, scratch=scratch)
    assert scratch["keys"].dtype == (torch.int64 if wide else torch.int32)
    _check_bag_backward(card, table, idx, w, g)


def _forward_inputs(card, seed, *, v, d, s, l, idx_dtype):
    """A table [V, D] and S bags of L ids, 10% of them outside [0, V) on
    both sides; the weights a prefix mask (1..L valid slots) times values
    in [-1, 1), so masked slots hold 0.0 and -0.0, with a few zeros more
    among the valid slots."""
    g = torch.Generator(device=card).manual_seed(seed)
    table = torch.randn(v, d, generator=g, device=card)
    idx = torch.randint(0, v, (s, l), generator=g, device=card)
    pick = torch.rand(s, l, generator=g, device=card) < 0.1
    far = torch.randint(v, 2 * v, (s, l), generator=g, device=card)
    idx = torch.where(pick, torch.where(idx % 2 == 0, far, -1 - idx), idx)
    n = torch.randint(1, l + 1, (s, 1), generator=g, device=card)
    w = (torch.arange(l, device=card) < n).float() * (torch.rand(s, l, generator=g, device=card) * 2 - 1)
    w = torch.where(torch.rand(s, l, generator=g, device=card) < 0.05, 0.0, w)
    return table, idx.to(idx_dtype).contiguous(), w.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3, 700])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("l", [1, 39, 100])
@pytest.mark.parametrize("d", [1, 2, 10, 18, 32, 33, 256, 257])
def test_embedding_bag_forward_redesign_on_card(card, d, l, idx_dtype, s):
    """The forward at every lane grouping (D / VEC lanes a bag up to 32, a
    warp wider, two passes at 257), S below one block and above it, on the
    table and on a view of it at +4 bytes (float loads): each element
    within ``ref.embedding_bag_error_bound``, two calls bit for bit, one
    launch a call; all-zero weights (0.0 and -0.0) give exactly 0; a NaN
    row under weight 0 (0.0 or -0.0) adds nothing, and under a nonzero
    weight gives NaN in that bag."""
    v = 3000
    table, idx, w = _forward_inputs(card, 1000 * d + 10 * l + s, v=v, d=d, s=s, l=l,
                                    idx_dtype=idx_dtype)
    shifted = torch.zeros(table.numel() + 1, device=card)
    shifted[1:] = table.reshape(-1)
    view = shifted[1:].view(v, d)
    assert view.data_ptr() % 16 == 4
    for t in (table, view):
        before = LAUNCHES["embedding_bag"]
        got = embedding_bag_cuda(t, idx, w)
        again = embedding_bag_cuda(t, idx, w)
        torch.cuda.synchronize()
        assert LAUNCHES["embedding_bag"] == before + 2
        assert torch.equal(got, again)
        _assert_bag_close(table, idx, w, got)
        for zero in (0.0, -0.0):
            out = embedding_bag_cuda(t, idx, torch.full_like(w, zero))
            assert not bool(out.any()) and not bool(torch.signbit(out).any())

    # Row 5 turns NaN: bag 0 names it under 0.0, bag 1 under -0.0, bag 2
    # under 0.5, each in its last slot; no other slot names it.
    nan_row = 5
    idx = torch.where(idx == nan_row, nan_row + 1, idx)
    for bag, wt in ((0, 0.0), (1, -0.0), (2, 0.5)):
        idx[bag, l - 1], w[bag, l - 1] = nan_row, wt
    finite = embedding_bag_cuda(table, idx, w)
    poisoned = table.clone()
    poisoned[nan_row] = float("nan")
    got = embedding_bag_cuda(poisoned, idx, w)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[2]).all())
    keep = torch.ones(s, dtype=torch.bool, device=card)
    keep[2] = False
    assert torch.equal(got[keep], finite[keep])
    assert bool(torch.isfinite(got[keep]).all())
