"""gin-tu training over (data, model) meshes of ranks, held to JAX's
``jit(GNNFamily.step_fn)`` under ``state_pspec`` / ``input_pspec`` and to
the one-process port.

One JAX subprocess (4 CPU devices) draws each reduced shape's initial
``TrainState`` and 3 graphs with numpy from a seed, with JAX's index edge
cases in every one: sources below 0 (wrapped once, those below -N clamped
to 0) and at N or above (clamped), destinations and graph ids outside
their range (dropped); minibatch_lg's padding edges and seed-only labels
masked. A fifth case, "nan", is full_graph_sm with one label >= n_classes.
JAX runs 3 steps of ``jit(GNNFamily.step_fn(..., reduced=True))`` on the
(2, 2) mesh, the parameters replicated and every node and edge array over
the data axes (GSPMD computes the unsharded function on any mesh). One
gloo world of 4 CPU ranks (``torch_mesh_train_world.gnn_world``) trains
each case at (1, 4), (2, 2) and (4, 1) from JAX's state; the one-process
port runs the same steps. Both take AdamW at warmup 1 (``W.OPT``) so that
3 steps move the parameters by lr. Compared, float32: metrics within 1e-5
relative (NaN where JAX's are NaN), the step-1 gradients (synced and
joined) within 1e-5 of each tensor's norm, params, m and v after 3 steps
within 1e-5 relative + 0.1 x lr. Every rank's metrics are rank 0's, every
replicated block is bit-identical on every rank after every step, every
step-1 gradient block is finite and nonzero, step 1's collectives per op
are the counts recorded here (``COUNTS``), which ``mesh_train_collectives``
must also give; each checkpoint leaf reaches rank 0 alone, and the (2, 2)
checkpoint restores in one process. A (1, 1) mesh trains as one process
bit for bit; the dry run and the train launcher run gin-tu over 4 ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_train_world as W
from repro_torch.configs.families import GNN_SHAPES_REDUCED
from repro_torch.core.distributed import RankGroup
from repro_torch.launch import dryrun
from repro_torch.launch.cost import mesh_train_collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_world
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.train import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = [f"{d}x{m}" for d, m in W.MESHES]
CASES = list(W.GNN_CASES)
LR = 3e-4
# Step 1's collectives per op at the reduced config's 2 layers, by mesh and
# readout: over data, each layer's all-gather and reduce-scatter and their
# transposes but layer 0's (x takes no gradient), the graph readout's
# reduce-scatter and its transpose, the loss's all-reduce and the
# gradients'; the norm's over the mesh. A change to what GIN sends must
# change a number here.
COUNTS = {
    ("node", "1x4"): {"all-reduce": 1},
    ("node", "2x2"): {"all-gather": 3, "all-reduce": 3, "reduce-scatter": 3},
    ("node", "4x1"): {"all-gather": 3, "all-reduce": 3, "reduce-scatter": 3},
    ("graph", "1x4"): {"all-reduce": 1},
    ("graph", "2x2"): {"all-gather": 4, "all-reduce": 3, "reduce-scatter": 4},
    ("graph", "4x1"): {"all-gather": 4, "all-reduce": 3, "reduce-scatter": 4},
}

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import set_mesh
from repro.configs import families
from repro.configs.families import GNN_SHAPES_REDUCED, GNNFamily
from repro.configs.registry import get_arch
from repro.launch.mesh import make_mesh
from repro.launch.sharding import replicated, tree_named_sharding
from repro.models.gnn import GIN
from repro.train.loop import TrainState
from repro.train.optimizer import AdamWConfig

out, STEPS = sys.argv[1], 3
CASES = %(cases)r
families._OPT = AdamWConfig(warmup_steps=1, total_steps=6)
res = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", None)))) for e in path]
        res[prefix + "/".join(keys)] = np.asarray(leaf)

def graph(s, rng, nan):
    n, e = s.n_nodes, s.n_edges
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    odd = rng.permutation(np.arange(16) * (e // 16))  # JAX's index edge cases, spread out
    src[odd[:4]] = rng.integers(-n, 0, 4)  # wrapped once
    src[odd[4:6]] = [-n - 3, -2 * n]  # below -n: clamped to 0 after the wrap
    src[odd[6:8]] = [n, n + 7]  # clamped to n - 1
    dst[odd[8:12]] = [-1, -n, n, n + 5]  # dropped
    b = {"x": rng.standard_normal((n, s.d_feat)).astype(np.float32),
         "edge_src": src.astype(np.int32), "edge_dst": dst.astype(np.int32),
         "labels": rng.integers(0, s.n_classes, s.n_graphs or n).astype(np.int32)}
    if s.batch_nodes:  # the sampled subgraph: padding edges at the end, seed-only labels
        b["edge_mask"] = (np.arange(e) < e - e // 3).astype(np.float32)
        b["label_mask"] = (np.arange(n) < s.batch_nodes).astype(np.float32)
        b["labels"] = rng.integers(0, s.n_classes, n).astype(np.int32)
    if s.n_graphs:
        gid = np.repeat(np.arange(s.n_graphs), n // s.n_graphs)
        gid[[3, n // 2 + 1]] = [-1, s.n_graphs]  # dropped
        b["graph_ids"] = gid.astype(np.int32)
    if nan:
        b["labels"][5] = s.n_classes
    return b

arch = get_arch("gin-tu")
mesh = make_mesh((2, 2), ("data", "model"))
with jax.default_matmul_precision("highest"):
    for i, (case, shape) in enumerate(CASES.items()):
        s = GNN_SHAPES_REDUCED[shape]
        cfg = GNNFamily._cfg_for(arch, s, True)
        params = GIN.init(jax.random.PRNGKey(60 + i), cfg)
        state0 = TrainState.create(params)
        flat(state0.params, f"{case}/init/params/")
        flat(state0.opt, f"{case}/init/opt/")
        rng = np.random.default_rng(70 + i)
        batches = [graph(s, rng, case == "nan") for _ in range(STEPS)]
        for t, b in enumerate(batches):
            for k, v in b.items():
                res[f"{case}/b{t}/{k}"] = v
        pp = replicated(params)  # state_pspec's rule, on the reduced config's tree
        st_ps = TrainState(params=pp, opt={"m": pp, "v": pp, "step": P()}, error_fb=None)
        in_ps = GNNFamily.input_pspec(arch, shape, mesh)
        in_sh = (tree_named_sharding(st_ps, mesh), tree_named_sharding(in_ps, mesh))
        extra = {"n_graphs": s.n_graphs} if s.n_graphs else {}
        with set_mesh(mesh):
            step = jax.jit(GNNFamily.step_fn(arch, shape, reduced=True), in_shardings=in_sh)
            grad = jax.jit(jax.grad(lambda p, b: GIN.loss(p, cfg, {**b, **extra})[0]),
                           in_shardings=(in_sh[0].params, in_sh[1]))
            state = jax.device_put(state0, in_sh[0])
            flat(grad(state.params, jax.device_put(batches[0], in_sh[1])), f"{case}/g/")
            ms = []
            for b in batches:
                state, m = step(jax.device_put(state, in_sh[0]), jax.device_put(b, in_sh[1]))
                ms.append({k: float(v) for k, v in m.items()})
        res[f"{case}/metric_names"] = np.asarray(sorted(ms[0]))
        res[f"{case}/metrics"] = np.asarray([[m[k] for k in sorted(m)] for m in ms])
        flat(state.params, f"{case}/final/params/")
        flat(state.opt, f"{case}/final/opt/")
np.savez(os.path.join(out, "jax.npz"), **res)
print("OK")
"""


def _readout(case: str) -> str:
    return "graph" if GNN_SHAPES_REDUCED[W.GNN_CASES[case]].n_graphs else "node"


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_gnn_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT % {"cases": W.GNN_CASES}, out],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    path = os.path.join(out, "jax.npz")
    return path, np.load(path)


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_gnn_world"))
    run_world(W.gnn_world, 4, backend="gloo", device="cpu", args=(jax_run[0], out), threads=1,
              join_timeout_s=500)
    return out, [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]


def _one_process_run(z, case, mesh=None):
    """3 steps of the family's step from JAX's state (over ``mesh`` when
    given) -> (state, metrics)."""
    state = state_from_jax(W.jax_state(z, f"{case}/init/"), W.gnn_cfg(case), device="cpu",
                           mesh=mesh)
    step = W.gnn_step(case, mesh)
    metrics = []
    for b in W.batches(z, f"{case}/"):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def one_process(jax_run):
    return {case: _one_process_run(jax_run[1], case) for case in CASES}


def _same(a: list, b: list) -> bool:
    """Two runs' metrics equal bit for bit, NaN where NaN."""
    return [sorted(m) for m in a] == [sorted(m) for m in b] and np.array_equal(
        [[m[k] for k in sorted(m)] for m in a], [[m[k] for k in sorted(m)] for m in b],
        equal_nan=True)


def _jax_metrics(z, case):
    names = [str(n) for n in z[f"{case}/metric_names"]]
    return [dict(zip(names, row)) for row in z[f"{case}/metrics"]]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", CASES)
def test_metrics_match_jax_and_one_process(jax_run, world, one_process, case, tag):
    got = world[1][0][f"{case}/{tag}"]["metrics"]
    for r, o in enumerate(world[1]):
        assert _same(o[f"{case}/{tag}"]["metrics"], got), f"rank {r}'s metrics differ"
    for want in (_jax_metrics(jax_run[1], case), one_process[case][1]):
        assert len(got) == len(want) == W.STEPS
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                assert np.isnan(g[k]) == np.isnan(w[k]), k
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)
    if case == "nan":
        assert all(np.isnan(m["loss"]) and np.isfinite(m["grad_norm"]) for m in got)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", CASES)
def test_step_one_gradients_and_final_state_match_jax(jax_run, world, case, tag):
    z = jax_run[1]
    cfg = W.gnn_cfg(case)
    out = world[1][0][f"{case}/{tag}"]
    want = params_from_jax(W.tree_of(z, f"{case}/g/"), cfg, device="cpu")
    assert list(out["grads"]) == list(want)
    for k, g in out["grads"].items():
        assert float((g - want[k]).norm() / want[k].norm()) <= 1e-5, k
    final = {}
    for what, sub in (("params", "params/"), ("opt.m", "opt/m/"), ("opt.v", "opt/v/")):
        for k, v in params_from_jax(W.tree_of(z, f"{case}/final/{sub}"), cfg, device="cpu").items():
            final[f"{what}.{k}"] = v
    assert set(out["final"]) == set(final)
    for k, v in out["final"].items():
        assert torch.equal(v.isnan(), final[k].isnan()), k
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=1e-5, atol=0.1 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", CASES)
def test_replicated_blocks_alike_and_gradients_whole(world, case, tag):
    outs = [o[f"{case}/{tag}"] for o in world[1]]
    for s in range(W.STEPS):
        for k in outs[0]["steps"][s]:
            assert all(o["keys"][k] == () for o in outs), k  # every parameter replicated
            for r, o in enumerate(outs):
                assert o["steps"][s][k] == outs[0]["steps"][s][k], (k, r, s)
    for r, o in enumerate(outs):
        bad = [k for k, (finite, nonzero) in o["grad_ok"].items() if not (finite and nonzero)]
        assert not bad, (r, bad)
    assert outs[0]["counts"] == COUNTS[_readout(case), tag]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", ["full_graph_sm", "molecule"])
def test_collective_formula_gives_the_recorded_counts(case, tag):
    """``mesh_train_collectives`` (the formula PERF.md states) reckons the
    counts recorded for each readout and mesh."""
    d, m = (int(x) for x in tag.split("x"))
    assert mesh_train_collectives(W.gnn_cfg(case), (d, m)) == COUNTS[_readout(case), tag]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", CASES)
def test_a_checkpoint_leaf_reaches_rank_0_alone(world, case, tag):
    """``TrainLayout.gather_to_root`` of every leaf after 3 steps: the
    joined tensor on rank 0, None on the other ranks."""
    assert all(o[f"{case}/{tag}"]["root"] for o in world[1])


@pytest.mark.parametrize("case", CASES)
def test_a_mesh_checkpoint_restores_in_one_process(jax_run, world, case):
    """The (2, 2) world's checkpoint (rank 0 the writer) restores in one
    process to the world's joined tensors, bit for bit."""
    got = world[1][0][f"{case}/2x2"]["final"]
    template = state_from_jax(W.jax_state(jax_run[1], f"{case}/init/"), W.gnn_cfg(case),
                              device="cpu")
    back, step = ckpt.restore_checkpoint(os.path.join(world[0], case), template)
    assert step == W.STEPS
    names = [k for k, _ in ckpt.flatten(back) if k in got]
    assert len(names) == 3 * len(template.params)
    for k, v in ckpt.flatten(back):
        if k in got:
            assert torch.equal(v.detach(), got[k]), k


@pytest.mark.parametrize("case", CASES)
def test_a_one_by_one_mesh_trains_as_one_process_bit_for_bit(jax_run, one_process, case):
    mesh = make_mesh((1, 1), ("data", "model"), RankGroup(0, 1, "gloo", "cpu"))
    state, metrics = _one_process_run(jax_run[1], case, mesh)
    want_state, want = one_process[case]
    assert _same(metrics, want)
    for (k, a), (_, b) in zip(ckpt.flatten(state), ckpt.flatten(want_state)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("shape,mesh", [("molecule", (2, 2)), ("minibatch_lg", (4, 1))])
def test_dry_run_over_four_ranks(shape, mesh):
    """gin-tu's train cells over 4 gloo CPU ranks: the record's mesh and
    MFU, and its step's collectives the formula's."""
    from repro_torch.configs.registry import get_arch

    rec = dryrun.run_cell("gin-tu", shape, device="cpu", reduced=True, ranks=4, mesh=mesh,
                          iters=1, verbose=False)
    assert rec["mesh"] == "ranks4" and rec["n_devices"] == 4 and rec["ok"]
    assert rec["measured"]["mfu"] > 0
    cfg = get_arch("gin-tu").family._cfg_for(get_arch("gin-tu"), GNN_SHAPES_REDUCED[shape], True)
    assert rec["collectives"]["counts"] == mesh_train_collectives(cfg, mesh)


def test_train_launcher_over_ranks_resumes_in_one_process(tmp_path, capsys):
    """``launch.train --arch gin-tu --ranks 4 --mesh 2,2`` on the CPU trains
    and writes the one-process checkpoint layout; one process resumes."""
    from repro_torch.launch import train as train_cli

    d = str(tmp_path / "ck")
    common = ["--arch", "gin-tu", "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "2"]
    assert train_cli.main([*common, "--steps", "2", "--ranks", "4", "--mesh", "2,2"]) == 0
    assert ckpt.latest_step(d) == 2
    assert train_cli.main([*common, "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 2" in out and "done" in out
