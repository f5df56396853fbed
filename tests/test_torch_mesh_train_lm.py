"""LM training over (data, model) meshes of ranks, held to JAX's
``jit(make_train_step)`` under its shardings and to the one-process port.

One JAX subprocess (4 CPU devices) draws the initial ``TrainState`` and 3
global batches (labels < 0 in some rows) and runs 3 steps of
``make_train_step`` (microbatches 2, JAX's global order) with the state
and batch placed by JAX's ``lm_param_pspec`` / ``zero1_opt_pspec`` and the
batch over the data axes: reduced qwen3-4b and mixtral (fsdp experts) on
the (2, 2) mesh (GSPMD computes the unsharded function on any mesh), and
mixtral with tp_only experts, local dispatch and ZeRO-1 moments on (2, 2)
and (4, 1) (each data shard routes its own tokens). One gloo world of 4 CPU
ranks (``torch_mesh_train_world.lm_world``) trains every case at (1, 4),
(2, 2) and (4, 1) from JAX's state (``state_from_jax``); the one-process
port runs the same steps. Compared, float32: losses, ce, aux, grad_norm and
lr within 1e-5 relative; the first microbatch's step-1 gradients, joined
from the ranks' blocks, within 1e-5 of each tensor's norm; params, m and v
after 3 steps within 1e-5 relative + 0.1 x lr. Every rank's metrics are
rank 0's, every replicated block is bit-identical on the ranks that hold
it after every step, every step-1 gradient block is finite and nonzero,
and step 1's collectives per op are the counts recorded here (``COUNTS``),
which ``mesh_train_collectives`` must also give; each checkpoint leaf
reaches rank 0 alone. ZeRO-1
moment blocks are the slices ``zero1_opt_pspec`` names; int8 compression
and error feedback over blocks equal one process's on the joined tensors
bit for bit; a one-process checkpoint restores into the mesh's blocks and
back bit for bit; a (1, 1) mesh is the one-process port bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_train_world as W
from repro_torch.configs.families import lm_loss_fn
from repro_torch.core.distributed import RankGroup
from repro_torch.launch import sharding
from repro_torch.launch.cost import mesh_train_collectives
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_world
from repro_torch.models.convert import params_from_jax, state_from_jax, train_layout
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.compression import compress_grads
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = [f"{d}x{m}" for d, m in W.MESHES]
LR = 3e-4
# Step 1's collectives per op (microbatches W.MB), by case and mesh: a
# change to what the layers send must change a number here.
COUNTS = {
    ("qwen3", "1x4"): {"all-gather": 4, "all-reduce": 28},
    ("qwen3", "2x2"): {"all-gather": 10, "all-reduce": 32, "reduce-scatter": 6},
    ("qwen3", "4x1"): {"all-gather": 6, "all-reduce": 6, "reduce-scatter": 6},
    ("mixtral", "1x4"): {"all-gather": 4, "all-reduce": 24},
    ("mixtral", "2x2"): {"all-gather": 14, "all-reduce": 28, "reduce-scatter": 10},
    ("mixtral", "4x1"): {"all-gather": 10, "all-reduce": 6, "reduce-scatter": 10},
    ("mixtral_tp", "1x4"): {"all-gather": 4, "all-reduce": 24},
    ("mixtral_tp", "2x2"): {"all-gather": 24, "all-reduce": 29, "reduce-scatter": 20},
    ("mixtral_tp", "4x1"): {"all-gather": 20, "all-reduce": 7, "reduce-scatter": 20},
}
# The dry run's (reduced mixtral, one layer, (2, 2), microbatches 2), by remat.
DRYRUN_COUNTS = {
    False: {"all-gather": 10, "all-reduce": 18, "reduce-scatter": 6},
    True: {"all-gather": 14, "all-reduce": 20, "reduce-scatter": 6},
}

JAX_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs.registry import get_arch
from repro.launch.mesh import make_mesh
from repro.launch.sharding import lm_param_pspec, tree_named_sharding, zero1_opt_pspec
from repro.models.transformer import TransformerLM
from repro.train.loop import TrainState, make_train_step
from repro.train.optimizer import AdamWConfig

out = sys.argv[1]
B, S, MB, STEPS = 8, 16, 2, 3
CASES = {"qwen3": ("qwen3-4b", {}, [(2, 2)]), "mixtral": ("mixtral-8x7b", {}, [(2, 2)]),
         "mixtral_tp": ("mixtral-8x7b", {"tp": True}, [(2, 2), (4, 1)])}
res = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", None)))) for e in path]
        res[prefix + "/".join(keys)] = np.asarray(leaf)

rng = np.random.default_rng(3)
batches = []
for i in range(STEPS):
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[1, :5] = -1  # a masked prefix in rows of both microbatches and of every data shard
    labels[6, 3:] = -1
    batches.append({"tokens": toks, "labels": labels})
    for k, v in batches[-1].items():
        res[f"lm/b{i}/{k}"] = v

with jax.default_matmul_precision("highest"):
    for ci, (case, (arch, over, meshes)) in enumerate(CASES.items()):
        cfg = get_arch(arch).reduced
        if over.get("tp"):
            cfg = dataclasses.replace(cfg, moe_weight_mode="tp_only",
                                      moe=dataclasses.replace(cfg.moe, local_dispatch=True))
        params = TransformerLM.init(jax.random.PRNGKey(11 + ci), cfg)
        state0 = TrainState.create(params)
        flat(state0.params, f"{case}/init/params/")
        flat(state0.opt, f"{case}/init/opt/")
        loss = lambda p, b: TransformerLM.loss(p, cfg, b["tokens"], b["labels"])
        for shape in meshes:
            tag = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"))
            pp = lm_param_pspec(params, mesh, moe_weight_mode=cfg.moe_weight_mode)
            opp = zero1_opt_pspec(pp, params, mesh) if over.get("tp") else pp
            st_ps = TrainState(params=pp, opt={"m": opp, "v": opp, "step": P()}, error_fb=None)
            in_ps = {"tokens": P("data", None), "labels": P("data", None)}
            in_sh = (tree_named_sharding(st_ps, mesh), tree_named_sharding(in_ps, mesh))
            with set_mesh(mesh):
                step = jax.jit(make_train_step(loss, AdamWConfig(warmup_steps=1, total_steps=6),
                                               microbatches=MB), in_shardings=in_sh)
                grad = jax.jit(jax.grad(lambda p, b: loss(p, b)[0]),
                               in_shardings=(in_sh[0].params, in_sh[1]))
                state = jax.device_put(state0, in_sh[0])
                mb0 = {k: v[: B // MB] for k, v in batches[0].items()}
                flat(grad(state.params, jax.device_put(mb0, in_sh[1])), f"{case}/{tag}/g/")
                ms = []
                for b in batches:  # the state placed as in_shardings name it each step
                    state, m = step(jax.device_put(state, in_sh[0]), jax.device_put(b, in_sh[1]))
                    ms.append([float(m[k]) for k in ("loss", "ce", "aux", "lr", "grad_norm")])
            res[f"{case}/{tag}/metrics"] = np.asarray(ms)
            flat(state.params, f"{case}/{tag}/final/params/")
            flat(state.opt, f"{case}/{tag}/final/opt/")
np.savez(os.path.join(out, "jax.npz"), **res)
print("OK")
"""
KEYS = ("loss", "ce", "aux", "lr", "grad_norm")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, out], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    path = os.path.join(out, "jax.npz")
    return path, np.load(path)


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_world"))
    # the one-process checkpoint the world restores into its blocks
    z = jax_run[1]
    cfg = W.lm_cfg("qwen3")
    ckpt.save_checkpoint(os.path.join(out, "one"), 0,
                         state_from_jax(W.jax_state(z, "qwen3/init/"), cfg, device="cpu"))
    run_world(W.lm_world, 4, backend="gloo", device="cpu", args=(jax_run[0], out), threads=1,
              join_timeout_s=500)
    return out, [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]


def _one_process_run(z, case):
    cfg = W.lm_cfg(case)
    state = state_from_jax(W.jax_state(z, f"{case}/init/"), cfg, device="cpu")
    step = make_train_step(lm_loss_fn(cfg), AdamWConfig(**W.OPT), microbatches=W.MB)
    metrics = []
    for b in W.batches(z, "lm/"):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.fixture(scope="module")
def one_process(jax_run):
    return {case: _one_process_run(jax_run[1], case) for case in W.LM_CASES}


def _jax_tag(case, tag):
    """The JAX run a port mesh is held to: the unsharded function's (the
    (2, 2) jit) for the gathered dispatch and for tp_only at data 1; each
    data size's own for a local dispatch."""
    if case == "mixtral_tp":
        return None if tag == "1x4" else tag
    return "2x2"


def _rel(got, want, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-7)


def _full_state(z, case, prefix, cfg):
    """A JAX state tree saved under ``prefix`` as the port's whole tensors:
    {"params.<n>", "opt.m.<n>", "opt.v.<n>"}."""
    out = {}
    for what, sub in (("params", "params/"), ("opt.m", "opt/m/"), ("opt.v", "opt/v/")):
        for k, v in params_from_jax(W.tree_of(z, prefix + sub), cfg, device="cpu").items():
            out[f"{what}.{k}"] = v
    return out


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_metrics_match_jax_and_one_process(jax_run, world, one_process, case, tag):
    z = jax_run[1]
    outs = world[1]
    got = outs[0][f"{case}/{tag}"]["metrics"]
    for r, o in enumerate(outs):
        assert o[f"{case}/{tag}"]["metrics"] == got, f"rank {r}'s metrics differ from rank 0's"
    jt = _jax_tag(case, tag)
    want = ([dict(zip(KEYS, row)) for row in z[f"{case}/{jt}/metrics"]] if jt
            else one_process[case][1])
    for g, w in zip(got, want):
        assert set(g) >= set(KEYS)
        for k in KEYS:
            _rel(g[k], w[k])
    if case != "qwen3":
        assert got[0]["aux"] > 0
    if jt is not None and case != "mixtral_tp":  # the one-process port too
        for g, w in zip(got, one_process[case][1]):
            for k in KEYS:
                _rel(g[k], w[k])


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_step_one_gradients_match_jax(jax_run, world, case, tag):
    """The first microbatch's gradients, joined from the ranks' blocks,
    within 1e-5 of each tensor's norm (at tp_only (1, 4), against the
    one-process port's)."""
    z = jax_run[1]
    cfg = W.lm_cfg(case)
    got = world[1][0][f"{case}/{tag}"]["grads"]
    jt = _jax_tag(case, tag)
    if jt is None:
        state = state_from_jax(W.jax_state(z, f"{case}/init/"), cfg, device="cpu")
        b = W.batches(z, "lm/")[0]
        loss, _ = lm_loss_fn(cfg)(state.params, {k: v[: W.B // W.MB] for k, v in b.items()})
        want = dict(zip(state.params, torch.autograd.grad(loss, list(state.params.values()))))
    else:
        want = params_from_jax(W.tree_of(z, f"{case}/{jt}/g/"), cfg, device="cpu")
    assert list(got) == list(want)
    for k, g in got.items():
        assert float((g - want[k]).norm() / want[k].norm()) <= 1e-5, k


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_params_and_moments_after_three_steps(jax_run, world, one_process, case, tag):
    z = jax_run[1]
    cfg = W.lm_cfg(case)
    got = world[1][0][f"{case}/{tag}"]["final"]
    jt = _jax_tag(case, tag)
    if jt is None:
        from repro_torch.train.checkpoint import flatten

        want = {k: v.detach() for k, v in flatten(one_process[case][0]) if k != "opt.step"}
    else:
        want = _full_state(z, case, f"{case}/{jt}/final/", cfg)
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=0.1 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_replicated_blocks_alike_and_gradients_whole(world, case, tag):
    """After every step each block is bit-identical on every rank that holds
    it; every rank's step-1 gradient blocks are finite and nonzero; step 1
    ran the recorded collectives."""
    outs = [o[f"{case}/{tag}"] for o in world[1]]
    for s in range(W.STEPS):
        for k in outs[0]["steps"][s]:
            seen = {}
            for r, o in enumerate(outs):
                key = o["keys"][k]
                if key in seen:
                    assert o["steps"][s][k] == seen[key][1], (k, key, seen[key][0], r, s)
                seen.setdefault(key, (r, o["steps"][s][k]))
    for r, o in enumerate(outs):
        bad = [k for k, (finite, nonzero) in o["grad_ok"].items() if not (finite and nonzero)]
        assert not bad, (r, bad)
    assert outs[0]["counts"] == COUNTS[case, tag]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_collective_formula_gives_the_recorded_counts(case, tag):
    """``mesh_train_collectives`` (the formula PERF.md states) reckons the
    counts recorded for each case and mesh."""
    d, m = (int(x) for x in tag.split("x"))
    assert mesh_train_collectives(W.lm_cfg(case), (d, m), microbatches=W.MB) == COUNTS[case, tag]


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_a_checkpoint_leaf_reaches_rank_0_alone(world, case, tag):
    """``TrainLayout.gather_to_root`` of every leaf after 3 steps: the
    joined tensor on rank 0 (ZeRO-1 slices and shared kv heads placed
    back), None on the other ranks."""
    assert all(o[f"{case}/{tag}"]["root"] for o in world[1])


@pytest.mark.parametrize("tag", TAGS)
def test_zero1_moment_blocks_are_the_named_slices(world, tag):
    """Under tp_only each rank's m of a parameter replicated over the data
    axes is the slice ``zero1_opt_pspec`` names of the joined m."""
    d, m = (int(x) for x in tag.split("x"))
    cfg = W.lm_cfg("mixtral_tp")
    for r, o in enumerate(world[1]):
        mesh = make_mesh((d, m), ("data", "model"))
        mesh.coords = dict(zip(mesh.axis_names, divmod(r, m)))
        layout = train_layout(cfg, mesh)
        out = o[f"mixtral_tp/{tag}"]
        split = [k for k, dim in out["zero1_dims"].items() if dim is not None]
        assert split if d > 1 else True
        for k, block in out["m_blocks"].items():
            full = out["final"][f"opt.m.{k}"]
            want = sharding.lm_local_block(k, full, layout.param_specs[k], mesh, cfg)
            if k in split:  # the dim the moments split further over the data axes
                p_spec, o_spec = layout.param_specs[k], layout.opt_specs[k]
                assert tuple(o_spec) != tuple(p_spec)
                want = sharding.local_block(
                    want, [o if o != p else None for p, o in zip(p_spec, o_spec)], mesh)
            assert torch.equal(block, want), (r, k)


def test_compression_over_blocks_is_the_one_process_bit_for_bit(world):
    """Two int8 rounds with error feedback over the (2, 2) ranks' blocks
    (ZeRO-1 slices included): the joined results equal one process's on
    the joined gradients, bit for bit."""
    got = world[1][0]["compress"]
    err = {k: torch.zeros_like(v) for k, v in got["grads"].items()}
    for scale, rnd in zip((1.0, 0.5), got["rounds"]):
        deq, err = compress_grads({k: v * scale for k, v in got["grads"].items()}, err)
        for k in deq:
            assert torch.equal(rnd["deq"][k], deq[k]), k
            assert torch.equal(rnd["err"][k], err[k]), k
    for o in world[1][1:]:
        for a, b in zip(o["compress"]["rounds"], got["rounds"]):
            assert all(torch.equal(a["deq"][k], b["deq"][k]) for k in a["deq"])


def test_checkpoint_round_trip_one_process_mesh_one_process(jax_run, world):
    """A one-process checkpoint restores into each rank's blocks bit for
    bit; saved again over the mesh, it restores in one process to the
    original bits; the state trained over the mesh restores in one process
    to the world's joined tensors bit for bit."""
    out, outs = world
    assert all(o["ckpt"]["restored_equal_blocks"] for o in outs)
    z = jax_run[1]
    cfg = W.lm_cfg("qwen3")
    template = state_from_jax(W.jax_state(z, "qwen3/init/"), cfg, device="cpu")
    first, _ = ckpt.restore_checkpoint(os.path.join(out, "one"), template)
    again, step = ckpt.restore_checkpoint(os.path.join(out, "mesh"), template)
    assert step == 0
    for (k, a), (_, b) in zip(ckpt.flatten(first), ckpt.flatten(again)):
        assert torch.equal(a, b), k
    trained, step = ckpt.restore_checkpoint(os.path.join(out, "trained"), template)
    assert step == W.STEPS
    final = outs[0]["qwen3/2x2"]["final"]
    for k, v in ckpt.flatten(trained):
        if k in final:
            assert torch.equal(v.detach(), final[k]), k
    with open(os.path.join(out, "mesh", "step_00000000", "manifest.json")) as f:
        assert f.read() == open(os.path.join(out, "one", "step_00000000", "manifest.json")).read()


@pytest.mark.parametrize("case", list(W.LM_CASES))
def test_a_one_by_one_mesh_trains_as_one_process_bit_for_bit(jax_run, one_process, case):
    z = jax_run[1]
    cfg = W.lm_cfg(case)
    mesh = make_mesh((1, 1), ("data", "model"), RankGroup(0, 1, "gloo", "cpu"))
    state = state_from_jax(W.jax_state(z, f"{case}/init/"), cfg, device="cpu", mesh=mesh)
    step = make_train_step(lm_loss_fn(cfg, mesh), AdamWConfig(**W.OPT), microbatches=W.MB,
                           layout=train_layout(cfg, mesh))
    metrics = []
    for b in W.batches(z, "lm/"):
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    want_state, want = one_process[case]
    assert metrics == want
    for (k, a), (_, b) in zip(ckpt.flatten(state), ckpt.flatten(want_state)):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("remat", [False, True])
def test_dry_run_of_a_train_cell_over_four_ranks(remat):
    """mixtral's train_4k (reduced, one layer) over 4 gloo CPU ranks at
    (2, 2), from a batch of 4: the record's mesh and MFU, and its step's
    collectives the formula's (the backward's reduce-scatters included;
    under remat the recomputed forward gathers the FSDP blocks again)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun

    arch = get_arch("mixtral-8x7b")
    cut = dataclasses.replace(arch, reduced=dataclasses.replace(arch.reduced, n_layers=1,
                                                                remat=remat))
    rec = dryrun.run_cell("mixtral-8x7b", "train_4k", device="cpu", reduced=True, ranks=4,
                          mesh=(2, 2), iters=1, arch=cut, batch=4, verbose=False)
    assert rec["mesh"] == "ranks4" and rec["n_devices"] == 4 and rec["ok"]
    assert rec["measured"]["mfu"] > 0
    want = mesh_train_collectives(cut.reduced, (2, 2), microbatches=arch.train_microbatches)
    assert rec["collectives"]["counts"] == want == DRYRUN_COUNTS[remat]
    assert want["reduce-scatter"] > 0
    plain = mesh_train_collectives(dataclasses.replace(cut.reduced, remat=False), (2, 2),
                                   microbatches=arch.train_microbatches)
    assert (want["all-gather"] > plain["all-gather"]) == remat


def test_train_launcher_over_ranks_resumes_in_one_process(tmp_path, capsys):
    """``launch.train --ranks 4 --mesh 2,2`` on the CPU trains and writes the
    one-process checkpoint layout; one process resumes from it."""
    from repro_torch.launch import train as train_cli

    d = str(tmp_path / "ck")
    common = ["--arch", "qwen3-4b", "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "2"]
    assert train_cli.main([*common, "--steps", "2", "--ranks", "4", "--mesh", "2,2"]) == 0
    assert ckpt.latest_step(d) == 2
    assert train_cli.main([*common, "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 2" in out and "done" in out
