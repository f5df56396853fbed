"""The port's cell layer against the JAX package's (CPU).

- ``launch/roofline.py``: ``model_flops`` equal to JAX's bit for bit in
  every cell of ``all_cells(include_warp=True)``; ``roofline_terms`` at
  JAX's constants gives JAX's dict, and defaults to the H100's peaks.
- ``launch/cost.py``: ``collective_bytes`` equal to JAX's
  ``collective_traffic`` on one HLO line per collective kind at groups of
  2, 4 and 8; ten [128, 128] products count ten times one (as
  ``tests/test_hlo_cost.py`` holds JAX's counter); each kernel wrapper's
  call counts exactly its ``work(...)`` and none of its plain version's
  ops; a ``RankGroup`` reports its collectives.
- ``abstract_state`` and ``input_specs`` of every cell, full and reduced:
  their (shape, dtype) leaves equal JAX's ``jax.eval_shape`` trees as
  multisets, and so do their bytes, with nothing allocated. The port's
  differences by design: dense weights are [out, in] (``nn.Linear``'s
  layout) where JAX's are [in, out], and the LM's layers are tensors of
  their own where JAX stacks them on a leading [L] axis. The test undoes
  both before it compares.
- ``WarpFamily``: ``search_config`` field for field (the executor after a
  plan resolves it on the CPU); ``step_fn`` over stores JAX built at the
  three reduced shapes, one index and the stack of 3 shards (JAX's oracle
  its 3-device ``shard_map``, in a subprocess as
  ``tests/test_torch_distributed.py`` runs it): ids exactly, scores within
  1e-4; ``smoke`` held to JAX's ``smoke`` on the same corpus, the port's
  stack built from JAX's per-shard centroids and JAX-normalised
  embeddings. JAX runs at executor "reference" with ``reduce_impl="scan"``
  (its defaults on the CPU).
- ``launch/dryrun.py::run_cell`` writes every key for one reduced cell
  per family on the CPU; ``launch/hillclimb.py::run_variant`` moves
  ``model_flops`` as the formula says; ``rank_shard`` equals
  ``shard_index``'s shard.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.core import kmeans as jk
from repro.launch import hlo_analysis as jax_hlo
from repro.launch import roofline as jax_roofline
from repro_torch.configs import registry
from repro_torch.configs.families import LM_SHAPES_REDUCED
from repro_torch.configs.warp_family import (
    WARP_SHAPES,
    WARP_SHAPES_REDUCED,
    WarpFamily,
    WarpShape,
    synth_index,
)
from repro_torch.core import IndexBuildConfig, Retriever, WarpIndex
from repro_torch.core import distributed as dist
from repro_torch.kernels import decompress_score, ops
from repro_torch.kernels import embedding_bag as bag
from repro_torch.kernels import flash_attention as flash
from repro_torch.kernels import fused_gather_score as fused
from repro_torch.kernels import ref
from repro_torch.launch import cost, dryrun, hillclimb, roofline
from repro_torch.store import builder, load_index

torch.set_num_threads(1)  # xdist runs one test process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = jax_registry.all_cells(include_warp=True)
TOL = dict(rtol=1e-4, atol=1e-4)
N_SHARDS = 3


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


def test_the_registry_has_jax_cells():
    assert registry.all_cells(include_warp=True) == CELLS and len(CELLS) == 43


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_jax(arch, shape):
    got = roofline.model_flops(registry.get_arch(arch), shape)
    want = jax_roofline.model_flops(jax_registry.get_arch(arch), shape)
    assert got == want and got > 0


@pytest.mark.parametrize("flops,nbytes,coll,n", [
    (1e15, 2e12, 0.0, 1), (3.3e9, 7.1e11, 1.5e9, 256), (0.0, 0.0, 0.0, 4), (5e12, 1e9, 4e10, 512),
])
def test_roofline_terms_equal_jax(flops, nbytes, coll, n):
    kw = dict(per_device_flops=flops, per_device_bytes=nbytes,
              per_device_collective_bytes=coll, n_devices=n)
    got = roofline.roofline_terms(**kw, peak_flops=jax_roofline.PEAK_FLOPS,
                                  hbm_bw=jax_roofline.HBM_BW, link_bw=jax_roofline.LINK_BW)
    assert got == jax_roofline.roofline_terms(**kw)
    h100 = roofline.roofline_terms(**kw)
    assert h100["compute_s"] == flops / 989e12 and h100["memory_s"] == nbytes / 3.35e12
    assert h100["collective_s"] == coll / 450e9


def test_peaks_are_the_h100s():
    assert (roofline.BF16_FLOPS, roofline.F32_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)
    assert roofline.peak_for(torch.bfloat16) == 989e12
    assert roofline.peak_for(torch.float32) == 67e12


def test_model_flops_takes_a_cut_shape():
    from repro_torch.configs.families import LM_SHAPES

    arch = registry.get_arch("qwen2-0.5b")
    half = dataclasses.replace(LM_SHAPES["train_4k"], global_batch=128)
    assert roofline.model_flops(arch, "train_4k", shape_obj=half) == pytest.approx(
        roofline.model_flops(arch, "train_4k") / 2, rel=1e-12)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _hlo_line(op: str, group: int) -> tuple[str, int]:
    """One HLO line of collective ``op`` over ``group`` devices, and the
    bytes ``collective_bytes`` reads of it (the gathered output for an
    all-gather, else the operand)."""
    groups = "replica_groups={{" + ",".join(str(i) for i in range(group)) + "}}"
    if op == "all-reduce":
        return (f"%x = f32[1024,256]{{1,0}} all-reduce(f32[1024,256]{{1,0}} %p), {groups}, "
                "to_apply=%add", 1024 * 256 * 4)
    if op == "all-gather":
        return (f"%x = f32[{1024 * group},256]{{1,0}} all-gather(f32[1024,256]{{1,0}} %p), "
                f"{groups}, dimensions={{0}}", 1024 * group * 256 * 4)
    if op == "reduce-scatter":
        return (f"%x = bf16[{4096 // group},64]{{1,0}} reduce-scatter(bf16[4096,64]{{1,0}} %p), "
                f"{groups}, dimensions={{0}}, to_apply=%add", 4096 * 64 * 2)
    if op == "all-to-all":
        return (f"%x = s32[512,8]{{1,0}} all-to-all(s32[512,8]{{1,0}} %p), {groups}, "
                "dimensions={0}", 512 * 8 * 4)
    return ("%x = f32[77,3]{1,0} collective-permute(f32[77,3]{1,0} %p), "
            "source_target_pairs={{0,1},{1,0}}", 77 * 3 * 4)


@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_collective_bytes_equal_jax(op, group):
    line, nbytes = _hlo_line(op, group)
    want = jax_hlo.collective_traffic(line, group)
    assert want["n_ops"] == 1, line
    assert cost.collective_bytes(op, nbytes, group) == want["total_bytes"] == want["per_op"][op]


def test_rank_group_reports_its_collectives():
    group = dist.RankGroup(0, 3, "gloo", "cpu")
    with cost.StepCost() as c:
        group._count("all-gather", lambda: 300)
        group._count("broadcast", lambda: 90)
    assert c.collectives == {"per_op": {"all-gather": 200.0, "broadcast": 60.0},
                             "total_bytes": 260.0, "n_ops": 2}
    alone = dist.RankGroup(0, 1, "gloo", "cpu")
    with cost.StepCost() as c:
        alone._count("all-gather", lambda: 300)
    assert c.n_collectives == 0  # a group of one moves nothing


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def test_ten_products_count_ten_times_one():
    m = 128
    w = torch.ones(m, m)
    with cost.StepCost() as one:
        w @ w
    with cost.StepCost() as ten:
        x = w
        for _ in range(10):
            x = x @ w
    assert one.flops == 2 * m**3 and ten.flops == 10 * one.flops
    assert ten.bytes == 10 * one.bytes == 10 * 3 * m * m * 4
    assert ten.n_ops == 10 and not ten.kernels


def test_views_and_pointwise_ops_count_as_the_module_says():
    x = torch.randn(64, 32)
    with cost.StepCost() as c:
        x.t(), x.view(-1)[:100], x.unsqueeze(0).expand(3, 64, 32)  # views: nothing
    assert c.n_ops == 0 and c.flops == 0 and c.bytes == 0
    with cost.StepCost() as c:
        x + 1.0
    assert c.flops == 64 * 32 and c.bytes == 2 * 64 * 32 * 4
    table, idx = torch.randn(1000, 16), torch.randint(0, 1000, (8,))
    with cost.StepCost() as c:
        table[idx]  # a gather reads the rows it returns
    assert c.bytes == 2 * 8 * 16 * 4 + 8 * 8
    with cost.StepCost() as c:
        table.zero_()  # an overwrite reads nothing
    assert c.bytes == 1000 * 16 * 4


def _kernel_call_cases():
    g = torch.Generator().manual_seed(5)
    d, nbits, cap, q, p = 64, 4, 24, 6, 5
    pb = d * nbits // 8
    codes = torch.randint(0, 256, (400, pb), generator=g, dtype=torch.uint8)
    v = torch.randn(q, d, 1 << nbits, generator=g)
    sizes = torch.randint(0, cap + 1, (50,), generator=g, dtype=torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32), sizes.cumsum(0).int()])[:-1]
    offsets = offsets.clamp(max=400 - cap)
    cids = torch.randint(0, 50, (q, p), generator=g)
    pscores = torch.randn(q, p, generator=g)
    w = 12
    row0 = torch.randint(0, 300, (w,), generator=g, dtype=torch.int32)
    nvalid = torch.randint(0, 9, (w,), generator=g, dtype=torch.int32)
    qtok = torch.randint(0, q, (w,), generator=g, dtype=torch.int32)
    ps = torch.randn(w, generator=g)
    seg = torch.randint(0, 2, (w,), generator=g, dtype=torch.int32)
    packed = torch.randint(0, 256, (q, 30, pb), generator=g, dtype=torch.uint8)
    qa, ka = torch.randn(2, 64, 4, 64, generator=g), torch.randn(2, 64, 2, 64, generator=g)
    table = torch.randn(300, 16, generator=g)
    bidx = torch.randint(0, 300, (20, 7), generator=g)
    bw = torch.where(torch.rand(20, 7, generator=g) < 0.3, 0.0, torch.rand(20, 7, generator=g))
    return {
        "selective_sum": (
            lambda: ops.selective_sum(packed, v, nbits=nbits, dim=d),
            decompress_score.work(q=q, n=30, pb=pb, dim=d, nbits=nbits)),
        "fused_gather_score": (
            lambda: ops.fused_gather_selective_sum(codes, offsets, sizes, cids, pscores, v,
                                                   nbits=nbits, dim=d, cap=cap),
            fused.work(q=q, p=p, cap=cap, rows=int(sizes[cids].clamp(0, cap).sum()), pb=pb,
                       dim=d, nbits=nbits)),
        "ragged_fused_gather_score": (
            lambda: ops.ragged_fused_gather_selective_sum(codes, row0, nvalid, qtok, ps, v,
                                                          nbits=nbits, dim=d, tile_c=8),
            fused.ragged_work(w=w, tile_c=8, q=q, rows=int(nvalid.sum()), pb=pb, dim=d,
                              nbits=nbits)),
        "segmented_ragged_fused_gather_score": (
            lambda: ops.segmented_ragged_fused_gather_selective_sum(
                [codes, codes[:310]], row0, nvalid, seg, qtok, ps, v, nbits=nbits, dim=d,
                tile_c=8),
            fused.segmented_work(w=w, tile_c=8, q=q, rows=int(nvalid.sum()), n_segments=2,
                                 pb=pb, dim=d, nbits=nbits)),
        "flash_attention": (
            lambda: ops.flash_attention(qa, ka, ka, causal=True, window=40),
            flash.work(b=2, h=4, hkv=2, sq=64, skv=64, dh=64, itemsize=4, causal=True,
                       window=40)),
        "embedding_bag": (
            lambda: ops.embedding_bag(table, bag_indices=bidx, bag_weights=bw, use_kernel=True),
            bag.work(s=20, l=7, d=16, needed=int((bw != 0).sum()), index_bytes=8)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_call_cases()))
def test_a_kernel_call_counts_its_work_and_no_plain_op(name):
    call, (flops, nbytes) = _kernel_call_cases()[name]
    want = call()
    with cost.StepCost() as c:
        got = call()
    assert torch.equal(got, want)
    assert c.kernels == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}
    assert [n for n, _, _ in c.kernel_calls] == [name]
    # Outside the kernel only the wrapper's own index arithmetic runs (the
    # fused wrappers gather each probe's start and size): no flop, and
    # nothing at all around the others.
    assert c.aten_flops == 0
    if name in ("selective_sum", "flash_attention", "embedding_bag"):
        assert c.aten_bytes == 0 and c.n_ops == 0


def test_the_bag_backward_counts_both_kernels_once():
    g = torch.Generator().manual_seed(9)
    table = torch.randn(300, 16, generator=g, requires_grad=True)
    w = torch.rand(20, 7, generator=g, requires_grad=True)
    idx = torch.randint(0, 300, (20, 7), generator=g)
    dout = torch.randn(20, 16, generator=g)
    out = ops.embedding_bag(table, bag_indices=idx, bag_weights=w, use_kernel=True)
    with cost.StepCost() as c:
        dt, dw = torch.autograd.grad(out, (table, w), dout)
    shapes = dict(s=20, l=7, d=16, index_bytes=8)
    t_f, t_b = bag.grad_table_work(v=300, **shapes)
    w_f, w_b = bag.grad_weights_work(after_table=True, **shapes)
    assert c.kernels == {"embedding_bag_backward": {"calls": 2, "flops": t_f + w_f,
                                                    "bytes": t_b + w_b}}
    assert c.aten_flops == 0
    want_t, want_w = ref.embedding_bag_bags_backward(table.detach(), idx, w.detach(), dout,
                                                     weights_grad=True)
    assert torch.equal(dt, want_t) and torch.equal(dw, want_w)


def test_work_functions_give_the_kernel_bounds_reckoned_before():
    """The bounds the kernels line reckoned inline: selective sum's
    gathered rows, v-tables and scores; the dense grid's probed rows and
    12-byte probe entries; the ragged tiles' 16 bytes; the flash kernel's
    causal pairs; the bag's nonzero rows; DIN's backward with dw."""
    assert decompress_score.work(q=32, n=32 * 1024, pb=64, dim=128, nbits=4) == (
        32 * 32 * 1024 * 128, 32 * 32 * 1024 * 64 + 32 * 128 * 16 * 4 + 4 * 32 * 32 * 1024)
    assert flash.pairs(10, 10) == 55 and flash.pairs(10, 10, window=4) == 4 * 5 // 2 + 6 * 4
    assert flash.pairs(6, 10, causal=False) == 60
    din = dict(s=65536, l=100, d=18, index_bytes=8)
    v = 1000
    total = bag.grad_table_work(v=v, **din)[1] + bag.grad_weights_work(after_table=True, **din)[1]
    assert total == v * 18 * 4 + 65536 * 100 * (8 + 4 + 4) + 65536 * 18 * 4 + 65536 * 100 * 18 * 4


# ---------------------------------------------------------------------------
# abstract state and input specs
# ---------------------------------------------------------------------------


def _jax_leaves(tree, stacked: bool):
    """(shape, dtype) of a ``jax.eval_shape`` tree; with ``stacked`` (the
    LM) the layers' leaves are unstacked into one leaf per layer."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
        shape, dtype = tuple(leaf.shape), str(leaf.dtype)
        if stacked and "layers" in keys:
            out += [(shape[1:], dtype)] * shape[0]
        else:
            out.append((shape, dtype))
    return out


def _port_leaves(tree, name=""):
    """(shape, dtype) leaves of a port spec tree, dense weights ([out, in])
    written in JAX's [in, out]."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _port_leaves(v, k)]
    dims, dtype = tree
    dims = tuple(dims)
    if name.endswith(".weight") and len(dims) == 2:
        dims = dims[::-1]
    return [(dims, str(dtype).replace("torch.", ""))]


def _nbytes(leaves):
    return sum(int(np.prod(s, dtype=np.int64)) * np.dtype(
        "float16" if d == "bfloat16" else d).itemsize for s, d in leaves)


@pytest.mark.parametrize("reduced", [False, True])
def test_abstract_state_and_input_specs_match_jax(reduced):
    for arch_name, shape in CELLS:
        jarch, parch = jax_registry.get_arch(arch_name), registry.get_arch(arch_name)
        for what in ("abstract_state", "input_specs"):
            want = _jax_leaves(getattr(jarch.family, what)(jarch, shape, reduced=reduced),
                               stacked=what == "abstract_state" and parch.family.name == "lm")
            got = _port_leaves(getattr(parch.family, what)(parch, shape, reduced=reduced))
            assert collections.Counter(got) == collections.Counter(want), (arch_name, shape, what)
            assert _nbytes(got) == _nbytes(want)
            assert dryrun.spec_bytes(getattr(parch.family, what)(parch, shape, reduced=reduced)) \
                == _nbytes(want)


def test_abstract_state_allocates_nothing():
    arch = registry.get_arch("dbrx-132b")
    st = arch.family.abstract_state(arch, "train_4k")
    assert dryrun.spec_bytes(st) > 1.5e12  # params + two moments of 132B float32 parameters
    assert st["opt"]["step"] == ((), torch.int32)


# ---------------------------------------------------------------------------
# the warp family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(WARP_SHAPES))
@pytest.mark.parametrize("reduced", [False, True])
def test_search_config_matches_jax_family(shape, reduced):
    jarch, parch = jax_registry.get_arch("warp-xtr"), registry.get_arch("warp-xtr")
    want = dataclasses.asdict(jarch.family.search_config(jarch, shape, reduced=reduced))
    got = WarpFamily.search_config(parch, shape, reduced=reduced)
    assert got.executor == "auto"
    resolved = dataclasses.asdict(dataclasses.replace(got, executor=got.resolved_executor(False)))
    assert resolved == want
    if reduced:
        s = WARP_SHAPES_REDUCED[shape]
        index = synth_index(parch.reduced, s, 0, "cpu")
        plan = Retriever.from_index(index, device="cpu").plan(got)
        assert plan.config.executor == want["executor"]
        for f in ("nprobe", "k", "k_impute", "t_prime"):
            assert getattr(plan.config, f) == want[f]


def test_smoke_builds_one_shard_on_the_cpu():
    arch = registry.get_arch("warp-xtr")
    out = WarpFamily.smoke(arch, "search_lifestyle", device="cpu")["scores"]
    assert out.shape == (arch.reduced.k,) and torch.isfinite(out).all()


def test_rank_shard_is_shard_index_shard():
    index = synth_index(registry.get_arch("warp-xtr").reduced,
                        WarpShape("serve", 6000, 300, 64, 128, 1), 3, "cpu")
    for n in (1, 3):
        stack = dist.shard_index(index, n)
        for r in range(n):
            got = dist.rank_shard(index, dist.RankGroup(r, n, "gloo", "cpu"))
            want = stack.shards[r]
            for f in ("centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
                      "cluster_sizes", "bucket_weights", "bucket_cutoffs"):
                assert torch.equal(getattr(got.local, f), getattr(want, f)), (n, r, f)
            for f in ("dim", "nbits", "cap", "n_docs", "n_tokens"):
                assert getattr(got.local, f) == getattr(want, f), (n, r, f)
            assert got.doc_start == int(stack.doc_start[r])
            np.testing.assert_array_equal(got.shard_cluster_sizes, stack.cluster_sizes.numpy())
            assert (got.n_tokens_padded, got.local_docs, got.n_tokens_total) == (
                stack.n_tokens_padded, stack.local_docs, stack.n_tokens_total)


# ---------------------------------------------------------------------------
# the dry run and the hill-climb runner
# ---------------------------------------------------------------------------

KEYS = {
    "arch", "shape", "mesh", "n_devices", "ok", "device", "peak_flops", "reduced", "reckoned",
    "memory", "per_device_flops", "per_device_bytes", "kernels", "kernel_calls", "collectives",
    "roofline",
    "model_flops", "model_flops_run", "useful_flops_ratio", "measured",
}


@pytest.mark.parametrize("arch,shape", [
    ("qwen2-0.5b", "decode_32k"), ("gin-tu", "molecule"), ("din", "serve_p99"),
    ("warp-xtr", "search_lifestyle"),
])
def test_run_cell_writes_every_key(arch, shape, tmp_path):
    assert dryrun.main(["--arch", arch, "--shape", shape, "--device", "cpu", "--reduced",
                        "--iters", "1", "--out", str(tmp_path)]) == 0
    with open(tmp_path / "single" / f"{arch}__{shape}.json") as f:
        rec = json.load(f)
    assert set(rec) == KEYS and rec["ok"] and rec["mesh"] == "single"
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "total_per_device"}
    assert set(rec["measured"]) == {"p50_ms", "peak_bytes", "mfu"}
    assert "model_mfu_at_bound" in rec["roofline"] and rec["reduced"] == []
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    a = registry.get_arch(arch)
    assert rec["reckoned"] == {
        "state_bytes": dryrun.spec_bytes(a.family.abstract_state(a, shape, reduced=True)),
        "input_bytes": dryrun.spec_bytes(a.family.input_specs(a, shape, reduced=True)),
    }
    assert rec["model_flops"] == rec["model_flops_run"] > 0
    assert rec["measured"]["mfu"] > 0 and rec["per_device_flops"] > 0
    # The CPU resolves every model and plan to its reference executor.
    assert rec["kernels"] == {} and rec["kernel_calls"] == []


def test_a_cell_that_does_not_fit_is_cut_depth_then_batch():
    """The state alone over the budget cuts the depth; then the batch (a
    train step's microbatches with it once each holds one row); then the
    depth."""
    arch = registry.get_arch("mixtral-8x7b")
    assert arch.train_microbatches > 1
    full = dryrun._Cell(arch, "train_4k", dryrun._shapes(arch.family, False)["train_4k"], False, [])
    cell = dryrun._fit(full, 100e9)
    assert cell.cuts == ["layers 32 -> 16", "layers 16 -> 8", "layers 8 -> 4"]
    assert sum(dryrun._reckon(cell)) <= 100e9 < dryrun._reckon(dryrun._with_depth(full, 8))[0]
    while cell.shape_obj.global_batch > arch.train_microbatches:
        cell = dryrun._cut_once(cell)
    assert cell.arch.train_microbatches == arch.train_microbatches == 2
    cell = dryrun._cut_once(cell)
    assert cell.cuts[-1] == "batch 2 -> 1 (microbatches 2 -> 1)"
    assert (cell.shape_obj.global_batch, cell.arch.train_microbatches) == (1, 1)
    assert dryrun._halve_batch(cell) is None
    assert dryrun._cut_once(cell).cuts[-1] == "layers 4 -> 2"
    assert roofline.model_flops(cell.arch, "train_4k", shape_obj=cell.shape_obj) < \
        roofline.model_flops(arch, "train_4k")
    serve = dryrun._Cell(arch, "decode_32k", dryrun._shapes(arch.family, False)["decode_32k"],
                         False, [])
    cut = dryrun._with_batch(serve, 16)
    specs = dryrun._batch_axis_specs(cut, arch.family.input_specs(arch, "decode_32k"))
    assert specs["tokens"][0] == (16,) and specs["cache"]["k"][0][1] == 16


def test_a_failing_cell_is_recorded(tmp_path, capsys):
    assert dryrun.main(["--arch", "qwen2-0.5b", "--shape", "no_such_shape", "--device", "cpu",
                        "--reduced", "--out", str(tmp_path)]) == 1
    with open(tmp_path / "single" / "qwen2-0.5b__no_such_shape.json") as f:
        rec = json.load(f)
    assert rec["ok"] is False and "no_such_shape" in rec["error"] and rec["traceback"]


def test_run_variant_moves_model_flops_as_the_formula_says():
    arch = registry.get_arch("qwen2-0.5b")
    s = LM_SHAPES_REDUCED["train_4k"]
    base = dryrun.run_cell("qwen2-0.5b", "train_4k", device="cpu", reduced=True, iters=1,
                           verbose=False)
    rec = hillclimb.run_variant("qwen2-0.5b", "train_4k", "wide_ffn", {"d_ff": 256},
                                device="cpu", reduced=True, iters=1, baseline=base, out_dir=None)
    cfg = dataclasses.replace(arch.reduced, d_ff=256)
    want = roofline.model_flops(dataclasses.replace(arch, config=cfg), "train_4k", shape_obj=s)
    assert rec["model_flops"] == want
    assert rec["delta"]["model_flops"] == want - base["model_flops"] != 0
    assert rec["variant"] == "wide_ffn" and rec["overrides"] == {"d_ff": "256"}
    assert registry.get_arch("qwen2-0.5b") is arch  # nothing patched


def test_nested_overrides_replace_fields_of_the_nested_config():
    cfg = registry.get_arch("mixtral-8x7b").reduced
    got = hillclimb._apply(cfg, {"moe": {"top_k": 1}, "d_ff": 96})
    assert got.moe.top_k == 1 and got.d_ff == 96 and got.moe.n_experts == cfg.moe.n_experts


# ---------------------------------------------------------------------------
# the warp family against JAX (last: the JAX run goes on beside the tests above)
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import jax, numpy as np
from repro.configs import registry
from repro.configs.warp_family import WARP_SHAPES_REDUCED, WarpFamily
from repro.core import IndexBuildConfig, Retriever, build_index, build_sharded_index
from repro.data import make_corpus, make_queries
from repro.store import save_index

out, n_shards = sys.argv[1], int(sys.argv[2])
assert len(jax.devices()) == n_shards
arch = registry.get_arch("warp-xtr")
res, built = {}, {}
for shape, s in WARP_SHAPES_REDUCED.items():
    corpus = make_corpus(n_docs=s.n_docs, mean_doc_len=max(4, s.n_tokens // s.n_docs), seed=0)
    q, qmask, _ = make_queries(corpus, n_queries=max(2, s.batch), seed=1)
    cfg = IndexBuildConfig(n_centroids=s.n_centroids, nbits=4, kmeans_iters=2)
    scfg = WarpFamily.search_config(arch, shape, reduced=True)
    assert scfg.executor == "reference" and scfg.reduce_impl == "scan"
    geometry = (s.n_docs, s.n_tokens, s.n_centroids)  # two shapes share a corpus
    if geometry not in built:
        built[geometry] = (
            build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, cfg),
            build_sharded_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, n_shards, cfg))
    single, stack = built[geometry]
    save_index(single, os.path.join(out, shape, "single"), build_config=cfg)
    save_index(stack, os.path.join(out, shape, "stack"), build_config=cfg)
    for name, index in (("single", single), ("stack", stack)):
        plan = Retriever.from_index(index).plan(scfg)
        r = plan.retrieve_batch(q[: s.batch], qmask[: s.batch]) if s.batch > 1 else plan.retrieve(q[0], qmask[0])
        res[f"{shape}/{name}/ids"], res[f"{shape}/{name}/scores"] = np.asarray(r.doc_ids), np.asarray(r.scores)
    res[f"{shape}/smoke"] = np.asarray(WarpFamily.smoke(arch, shape, jax.random.PRNGKey(0))["scores"])
    res[f"{shape}/q"], res[f"{shape}/qmask"] = q, qmask
    res[f"{shape}/emb"], res[f"{shape}/tdi"] = corpus.emb, corpus.token_doc_ids
np.savez(os.path.join(out, "jax.npz"), **res)
print("OK")
"""


@pytest.fixture(scope="module", autouse=True)
def jax_proc(tmp_path_factory):
    """The JAX run, started with the module's first test so that it runs
    beside the tests that do not need it (they come first)."""
    out = str(tmp_path_factory.mktemp("warp_family_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, out, str(N_SHARDS)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                            cwd=ROOT)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_proc):
    out, proc = jax_proc
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0 and "OK" in stdout, stderr[-3000:]
    return out, dict(np.load(os.path.join(out, "jax.npz")))


def _batch(z, shape):
    s = WARP_SHAPES_REDUCED[shape]
    q, m = torch.from_numpy(z[f"{shape}/q"]), torch.from_numpy(z[f"{shape}/qmask"])
    if s.batch > 1:
        return {"q": q[: s.batch], "qmask": m[: s.batch]}
    return {"q": q[0], "qmask": m[0]}


@pytest.mark.parametrize("layout", ["single", "stack"])
@pytest.mark.parametrize("shape", sorted(WARP_SHAPES_REDUCED))
def test_step_fn_matches_jax(jax_run, shape, layout):
    out, z = jax_run
    arch = registry.get_arch("warp-xtr")
    index = load_index(os.path.join(out, shape, layout), device="cpu")
    assert isinstance(index, dist.ShardedWarpIndex) == (layout == "stack")
    plan = Retriever.from_index(index, device="cpu").plan(
        WarpFamily.search_config(arch, shape, reduced=True))
    res = WarpFamily.step_fn(arch, shape, reduced=True)(plan, _batch(z, shape))
    np.testing.assert_array_equal(res.doc_ids.numpy(), z[f"{shape}/{layout}/ids"])
    np.testing.assert_allclose(res.scores.numpy(), z[f"{shape}/{layout}/scores"], **TOL)


@pytest.mark.parametrize("shape", sorted(WARP_SHAPES_REDUCED))
def test_smoke_matches_jax(jax_run, shape, monkeypatch):
    """The port's sharded build from JAX's per-shard centroids and
    JAX-normalised embeddings (XLA's rsqrt is not correctly rounded) gives
    JAX's stack; the port's smoke over it gives JAX's smoke scores."""
    out, z = jax_run
    want = load_index(os.path.join(out, shape, "stack"), device="cpu")

    def shard_build(emb, tdi, n_docs, sub_cfg, *, device):
        s, n = sub_cfg.seed, emb.shape[0]
        c = sub_cfg.resolved_n_centroids(n)
        jnorm = np.asarray(jk.l2_normalize(jnp.asarray(emb)))

        def normed():
            yield torch.from_numpy(jnorm.copy()), np.asarray(tdi, np.int32)

        packed, docs = np.empty((n, want.packed_codes.shape[-1]), np.uint8), np.empty(n, np.int32)
        small = builder.encode_corpus(
            normed, want.centroids[s, :c].clone(), sub_cfg.nbits, n,
            assign_out=np.empty(n, np.int32), packed_out=packed, docs_out=docs)
        return WarpIndex.from_arrays(
            dict(small, packed_codes=packed, token_doc_ids=docs, dim=emb.shape[1],
                 nbits=sub_cfg.nbits, cap=int(small["cluster_sizes"].max()), n_docs=n_docs,
                 n_tokens=n), device=device)

    monkeypatch.setattr(dist, "build_index", shard_build)
    s = WARP_SHAPES_REDUCED[shape]
    got_index = dist.build_sharded_index(
        z[f"{shape}/emb"], z[f"{shape}/tdi"], s.n_docs, N_SHARDS,
        IndexBuildConfig(n_centroids=s.n_centroids, nbits=4, kmeans_iters=2), device="cpu")
    for name in dist.SHARDED_ARRAYS:
        assert torch.equal(getattr(got_index, name), getattr(want, name)), name
    arch = registry.get_arch("warp-xtr")
    got = WarpFamily.smoke(arch, shape, device="cpu", index=got_index)["scores"]
    np.testing.assert_allclose(got.numpy(), z[f"{shape}/smoke"], **TOL)
