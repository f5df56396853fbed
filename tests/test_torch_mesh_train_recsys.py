"""Recsys training over (data, model) meshes of ranks, held to JAX's
``jit(make_train_step)`` under its shardings and to the one-process port.

One JAX subprocess (4 CPU devices) draws each reduced recsys model's
initial ``TrainState`` and 3 global batches of train_batch's 64 rows (ids
over the whole vocabulary, masks with 1..width valid slots, labels 0/1,
log_q normal) and runs 3 steps of ``make_train_step`` on the (2, 2) mesh,
the tables row-split by JAX's ``recsys_param_pspec`` and the batch over the
data axes. One gloo world of 4 CPU ranks
(``torch_mesh_train_world.recsys_world``) trains each model at both
executors (the kernel's bag Functions run their plain versions on the CPU)
at (1, 4), (2, 2) and (4, 1) from JAX's state. Compared, float32: losses
and lr within 1e-5 relative, the step-1 gradients (joined from the ranks'
blocks) within 1e-5 of each tensor's norm, params, m and v after 3 steps
within 1e-5 relative + 0.1 x lr. Two-tower's in-batch softmax runs over
the global batch (each rank's rows against every item), SASRec's masked
mean and xDeepFM's and DIN's means over the global batch; DIN's bag
weights are summed over the model axis (``copy_to``), so its attention
MLP's gradients are whole. Every rank's metrics are rank 0's, every
replicated block is bit-identical where it is held after every step, every
step-1 gradient block is finite and nonzero, and step 1's collectives per op
are the counts recorded here (``COUNTS``), which ``mesh_train_collectives``
must also give; each checkpoint leaf reaches rank 0 alone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_train_world as W
from repro_torch.configs.families import RECSYS_SHAPES_REDUCED
from repro_torch.launch.cost import mesh_train_collectives
from repro_torch.launch.ranks import run_world
from repro_torch.models.convert import params_from_jax, state_from_jax
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import make_train_step
from repro_torch.train.optimizer import AdamWConfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAGS = [f"{d}x{m}" for d, m in W.MESHES]
LR = 3e-4
# Step 1's collectives per op, by model and mesh (both executors alike but
# DIN's: the kernel's bag weights pass through copy_to over model): a
# change to what the models send must change a number here.
COUNTS = {
    ("two-tower-retrieval", "1x4"): {"all-reduce": 3},
    ("two-tower-retrieval", "2x2"): {"all-gather": 2, "all-reduce": 5, "reduce-scatter": 1},
    ("two-tower-retrieval", "4x1"): {"all-gather": 2, "all-reduce": 3, "reduce-scatter": 1},
    ("sasrec", "1x4"): {"all-reduce": 4},
    ("sasrec", "2x2"): {"all-reduce": 7},
    ("sasrec", "4x1"): {"all-reduce": 4},
    ("xdeepfm", "1x4"): {"all-reduce": 3},
    ("xdeepfm", "2x2"): {"all-reduce": 5},
    ("xdeepfm", "4x1"): {"all-reduce": 3},
    ("din", "1x4"): {"all-reduce": 3},
    ("din", "2x2"): {"all-reduce": 5},
    ("din", "4x1"): {"all-reduce": 3},
}
DIN_KERNEL_COUNTS = {"1x4": {"all-reduce": 5}, "2x2": {"all-reduce": 7}, "4x1": {"all-reduce": 3}}


def recorded_counts(arch: str, tag: str, ex: str) -> dict:
    if arch == "din" and ex == "kernel":
        return DIN_KERNEL_COUNTS[tag]
    return COUNTS[arch, tag]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import set_mesh
from repro.configs.registry import get_arch
from repro.launch.mesh import make_mesh
from repro.launch.sharding import recsys_param_pspec, tree_named_sharding
from repro.train.loop import TrainState, make_train_step
from repro.train.optimizer import AdamWConfig

out, B, STEPS = sys.argv[1], %(b)d, 3
res = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", None)))) for e in path]
        res[prefix + "/".join(keys)] = np.asarray(leaf)

def mask(rng, rows, width, left=False):
    n = rng.integers(1, width + 1, (rows, 1))
    pos = np.arange(width)
    return (pos >= width - n if left else pos < n).astype(np.float32)

def batch(cfg, rng):
    ids = lambda v, *d: rng.integers(0, v, d).astype(np.int32)
    name = type(cfg).__name__
    if name == "TwoTowerConfig":
        return {"user_ids": ids(cfg.user_vocab, B, cfg.user_fields),
                "user_mask": mask(rng, B, cfg.user_fields),
                "item_ids": ids(cfg.item_vocab, B, cfg.item_fields),
                "item_mask": mask(rng, B, cfg.item_fields),
                "log_q": rng.standard_normal(B).astype(np.float32)}
    if name == "SASRecConfig":
        return {"seq_ids": ids(cfg.item_vocab, B, cfg.seq_len),
                "seq_mask": mask(rng, B, cfg.seq_len, left=True),
                "pos_ids": ids(cfg.item_vocab, B, cfg.seq_len),
                "neg_ids": ids(cfg.item_vocab, B, cfg.seq_len)}
    labels = rng.integers(0, 2, B).astype(np.float32)
    if name == "XDeepFMConfig":
        return {"field_ids": ids(cfg.vocab, B, cfg.n_fields), "labels": labels}
    return {"target_ids": ids(cfg.item_vocab, B), "hist_ids": ids(cfg.item_vocab, B, cfg.seq_len),
            "hist_mask": mask(rng, B, cfg.seq_len), "labels": labels}

mesh = make_mesh((2, 2), ("data", "model"))
with jax.default_matmul_precision("highest"):
    for i, arch in enumerate(("two-tower-retrieval", "sasrec", "xdeepfm", "din")):
        a = get_arch(arch)
        cfg = a.reduced
        model = a.family._model(cfg)
        params = model.init(jax.random.PRNGKey(40 + i), cfg)
        state0 = TrainState.create(params)
        flat(state0.params, f"{arch}/init/params/")
        flat(state0.opt, f"{arch}/init/opt/")
        rng = np.random.default_rng(50 + i)
        batches = [batch(cfg, rng) for _ in range(STEPS)]
        for s, b in enumerate(batches):
            for k, v in b.items():
                res[f"{arch}/b{s}/{k}"] = v
        loss = lambda p, b: model.loss(p, cfg, b)
        pp = recsys_param_pspec(params, mesh)
        st_ps = TrainState(params=pp, opt={"m": pp, "v": pp, "step": P()}, error_fb=None)
        in_ps = {k: P("data", *([None] * (v.ndim - 1))) for k, v in batches[0].items()}
        in_sh = (tree_named_sharding(st_ps, mesh), tree_named_sharding(in_ps, mesh))
        with set_mesh(mesh):
            step = jax.jit(make_train_step(loss, AdamWConfig(warmup_steps=1, total_steps=6)),
                           in_shardings=in_sh)
            grad = jax.jit(jax.grad(lambda p, b: loss(p, b)[0]),
                           in_shardings=(in_sh[0].params, in_sh[1]))
            state = jax.device_put(state0, in_sh[0])
            flat(grad(state.params, jax.device_put(batches[0], in_sh[1])), f"{arch}/g/")
            ms = []
            for b in batches:
                state, m = step(jax.device_put(state, in_sh[0]), jax.device_put(b, in_sh[1]))
                ms.append({k: float(v) for k, v in m.items()})
        res[f"{arch}/metric_names"] = np.asarray(sorted(ms[0]))
        res[f"{arch}/metrics"] = np.asarray([[m[k] for k in sorted(m)] for m in ms])
        flat(state.params, f"{arch}/final/params/")
        flat(state.opt, f"{arch}/final/opt/")
np.savez(os.path.join(out, "jax.npz"), **res)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_recsys_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    script = JAX_SCRIPT % {"b": RECSYS_SHAPES_REDUCED["train_batch"].batch}
    proc = subprocess.run([sys.executable, "-c", script, out], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    path = os.path.join(out, "jax.npz")
    return path, np.load(path)


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_train_recsys_world"))
    run_world(W.recsys_world, 4, backend="gloo", device="cpu", args=(jax_run[0], out), threads=1,
              join_timeout_s=500)
    return out, [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(4)]


@pytest.fixture(scope="module")
def one_process(jax_run):
    """The one-process port's 3 steps of each model at each executor."""
    z = jax_run[1]
    out = {}
    for arch in W.RECSYS_ARCHS:
        cfg = W.recsys_cfg(arch)
        for ex in W.EXECUTORS:
            state = state_from_jax(W.jax_state(z, f"{arch}/init/"), cfg, device="cpu")
            step = make_train_step(W.recsys_loss_fn(cfg, ex), AdamWConfig(**W.OPT))
            metrics = []
            for b in W.batches(z, f"{arch}/"):
                state, m = step(state, b)
                metrics.append({k: float(v) for k, v in m.items()})
            out[(arch, ex)] = (state, metrics)
    return out


def _jax_metrics(z, arch):
    names = [str(n) for n in z[f"{arch}/metric_names"]]
    return [dict(zip(names, row)) for row in z[f"{arch}/metrics"]]


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_metrics_match_jax_and_one_process(jax_run, world, one_process, arch, tag, ex):
    got = world[1][0][f"{arch}/{tag}/{ex}"]["metrics"]
    for r, o in enumerate(world[1]):
        assert o[f"{arch}/{tag}/{ex}"]["metrics"] == got, f"rank {r}'s metrics differ"
    for want in (_jax_metrics(jax_run[1], arch), one_process[(arch, ex)][1]):
        assert len(got) == len(want) == W.STEPS
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_step_one_gradients_and_final_state_match_jax(jax_run, world, arch, tag, ex):
    z = jax_run[1]
    cfg = W.recsys_cfg(arch)
    out = world[1][0][f"{arch}/{tag}/{ex}"]
    want = params_from_jax(W.tree_of(z, f"{arch}/g/"), cfg, device="cpu")
    assert list(out["grads"]) == list(want)
    for k, g in out["grads"].items():
        assert float((g - want[k]).norm() / want[k].norm()) <= 1e-5, k
    final = {}
    for what, sub in (("params", "params/"), ("opt.m", "opt/m/"), ("opt.v", "opt/v/")):
        for k, v in params_from_jax(W.tree_of(z, f"{arch}/final/{sub}"), cfg, device="cpu").items():
            final[f"{what}.{k}"] = v
    assert set(out["final"]) == set(final)
    for k, v in out["final"].items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), rtol=1e-5, atol=0.1 * LR,
                                   err_msg=k)


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_replicated_blocks_alike_and_gradients_whole(world, arch, tag, ex):
    outs = [o[f"{arch}/{tag}/{ex}"] for o in world[1]]
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
    assert outs[0]["counts"] == recorded_counts(arch, tag, ex)


@pytest.mark.parametrize("ex", W.EXECUTORS)
@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_collective_formula_gives_the_recorded_counts(arch, tag, ex):
    """``mesh_train_collectives`` (the formula PERF.md states) reckons the
    counts recorded for each model, mesh and executor."""
    d, m = (int(x) for x in tag.split("x"))
    got = mesh_train_collectives(W.recsys_cfg(arch), (d, m), executor=ex)
    assert got == recorded_counts(arch, tag, ex)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_a_checkpoint_leaf_reaches_rank_0_alone(world, arch, tag):
    """``TrainLayout.gather_to_root`` of every leaf after 3 steps: the
    joined tensor on rank 0, None on the other ranks."""
    assert all(o[f"{arch}/{tag}/{ex}"]["root"] for o in world[1] for ex in W.EXECUTORS)


@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_a_mesh_checkpoint_restores_in_one_process(jax_run, world, arch):
    """The (2, 2) world's checkpoint (written over the mesh, rank 0 the
    writer) restores in one process to the world's joined tensors, bit for
    bit, at the step it was written."""
    z = jax_run[1]
    cfg = W.recsys_cfg(arch)
    got = world[1][0][f"{arch}/2x2/reference"]["final"]
    template = state_from_jax(W.jax_state(z, f"{arch}/init/"), cfg, device="cpu")
    back, step = ckpt.restore_checkpoint(os.path.join(world[0], arch), template)
    assert step == W.STEPS
    names = [k for k, _ in ckpt.flatten(back) if k in got]
    assert len(names) == 3 * len(template.params)
    for k, v in ckpt.flatten(back):
        if k in got:
            assert torch.equal(v.detach(), got[k]), k
