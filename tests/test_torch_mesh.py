"""The LM and recsys families served over (data, model) meshes of ranks,
held to the one-process port and to JAX.

One JAX subprocess (4 CPU devices, ``--xla_force_host_platform_device_count
=4``) draws the weights and inputs and runs reduced mixtral-8x7b and
qwen3-4b on the JAX mesh (2, 2) with the params placed by JAX's
``lm_param_pspec`` (prefill and greedy decode), batch-1 decode over a
cache split by sequence on (4, 1), JAX's local-dispatch MoE at data 2, and
the four recsys models' serve steps; every port mesh is held to those
results (GSPMD computes the unsharded function on any mesh). One gloo world of 4 CPU ranks
(``torch_mesh_world.serve_world``) runs the port over the same meshes.
Compared: logits rtol = atol = 1e-5, tokens equal, the cache blocks equal to
the one-process cache's slices within 1e-6 of their norm (layer 0, which no
collective precedes, bit for bit), the local dispatch's top_e,
counts and drops exactly (y within 1e-5), the recsys outputs within 1e-5
with identical NaN patterns for out-of-range ids. A (1, 1) mesh equals the
one-process port bit for bit. The dry run runs one LM cell and one recsys
cell over 4 ranks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_world as W
from repro_torch.configs.families import RECSYS_SHAPES_REDUCED
from repro_torch.configs.registry import get_arch
from repro_torch.core.distributed import RankGroup
from repro_torch.launch import dryrun, sharding
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.ranks import run_world
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.models.recsys import RECSYS_MODELS, serve_step

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5

JAX_SCRIPT = r"""
import os, sys
# 4 CPU devices; the cheaper LLVM passes halve the compile time of the jits.
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.compat import set_mesh
from repro.configs.registry import get_arch
from repro.configs.families import RECSYS_SHAPES_REDUCED
from repro.launch.mesh import make_mesh
from repro.launch.sharding import kv_cache_pspec, lm_param_pspec, tree_named_sharding
from repro.models.moe import MoEConfig, moe_apply, moe_init
from repro.models.transformer import KVCache, TransformerLM

out = sys.argv[1]
B, S, N, SEQ_LEN = 4, 40, 4, 48
res = {}

def flat(tree, prefix):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(e, "key", getattr(e, "name", getattr(e, "idx", None)))) for e in path]
        res[prefix + "/".join(keys)] = np.asarray(leaf)

def put(x, spec, mesh):
    return jax.device_put(x, NamedSharding(mesh, spec))

with jax.default_matmul_precision("highest"):
    for i, arch in enumerate(("mixtral-8x7b", "qwen3-4b")):
        cfg = get_arch(arch).reduced
        params = TransformerLM.init(jax.random.PRNGKey(7 + i), cfg)
        flat(params, f"lm/{arch}/p/")
        rng = np.random.default_rng(20 + i)
        prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        seq_prompt = rng.integers(0, cfg.vocab, (1, S)).astype(np.int32)
        res[f"lm/{arch}/prompt"], res[f"lm/{arch}/seq_prompt"] = prompt, seq_prompt
        prefill = jax.jit(lambda p, t, c: TransformerLM.prefill(p, cfg, t, c))
        decode = jax.jit(lambda p, t, c: TransformerLM.decode_step(p, cfg, t, c))
        for shape in ((2, 2), (4, 1)):
            tag = f"{shape[0]}x{shape[1]}"
            mesh = make_mesh(shape, ("data", "model"))
            p = jax.device_put(params, tree_named_sharding(lm_param_pspec(params, mesh), mesh))
            if shape == (4, 1):  # long_500k's rule: the cache split by sequence
                c1 = KVCache.empty(cfg, 1, SEQ_LEN, jnp.float32)
                lg, c1 = prefill(params, jnp.asarray(seq_prompt), c1)
                forced = [int(np.asarray(lg).argmax())]
                c1 = jax.device_put(c1, tree_named_sharding(kv_cache_pspec(c1, mesh, shard_seq=True), mesh))
                out_l = []
                for t in range(N):
                    lg, c1 = decode(p, jnp.asarray([forced[t]], jnp.int32), c1)
                    out_l.append(np.asarray(lg))
                    forced.append(int(np.asarray(lg).argmax()))
                res[f"lm/{arch}/seq"] = np.stack(out_l)
                res[f"lm/{arch}/seq_forced"] = np.asarray(forced[:N], np.int32)
                continue
            cache = KVCache.empty(cfg, B, S + N, jnp.float32)
            cache = jax.device_put(cache, tree_named_sharding(
                kv_cache_pspec(cache, mesh, shard_seq=False), mesh))
            logits, cache = prefill(p, put(prompt, P("data", None), mesh), cache)
            res[f"lm/{arch}/k"], res[f"lm/{arch}/v"] = np.asarray(cache.k), np.asarray(cache.v)
            steps, toks = [np.asarray(logits)], [np.asarray(logits).argmax(-1)]
            for _ in range(N - 1):
                logits, cache = decode(p, jnp.asarray(toks[-1], jnp.int32), cache)
                steps.append(np.asarray(logits))
                toks.append(np.asarray(logits).argmax(-1))
            res[f"lm/{arch}/logits"] = np.stack(steps)
            res[f"lm/{arch}/tokens"] = np.stack(toks, 1)

    # JAX's local-dispatch MoE at data 2: each data shard routes its own tokens.
    mcfg = MoEConfig(n_experts=4, top_k=2, local_dispatch=True)
    mp = moe_init(jax.random.PRNGKey(11), mcfg, 16, 32)
    x = np.random.default_rng(12).standard_normal((32, 16)).astype(np.float32)
    mesh = make_mesh((2, 2), ("data", "model"))
    with set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_apply(p, mcfg, x))(mp, jnp.asarray(x))
    res.update({"moe/x": x, "moe/router": np.asarray(mp["router"]["w"]),
                "moe/gate": np.asarray(mp["gate"]), "moe/up": np.asarray(mp["up"]),
                "moe/down": np.asarray(mp["down"]), "moe/y": np.asarray(y),
                "moe/aux": np.asarray(aux)})
    for d in range(2):
        xd = jnp.asarray(x[16 * d: 16 * (d + 1)])
        probs = jax.nn.softmax(xd @ mp["router"]["w"], axis=-1)
        res[f"moe/top_e{d}"] = np.asarray(jax.lax.top_k(probs, 2)[1])

    # The recsys serve steps (one device), ids out of range in some rows.
    for i, arch in enumerate(("two-tower-retrieval", "sasrec", "xdeepfm", "din")):
        a = get_arch(arch)
        cfg = a.reduced
        params = a.family._model(cfg).init(jax.random.PRNGKey(30 + i), cfg)
        flat(params, f"rs/{arch}/p/")
        rng = np.random.default_rng(40 + i)
        for shape in ("serve_p99", "retrieval_cand"):
            specs = a.family.input_specs(a, shape, reduced=True)
            batch = {}
            for name, sds in specs.items():
                if sds.dtype == jnp.int32:
                    v = cfg.user_vocab if name.startswith("user") else getattr(
                        cfg, "item_vocab", getattr(cfg, "vocab", None))
                    ids = rng.integers(0, v, sds.shape).astype(np.int32)
                    if sds.shape[0] > 1:  # one user's row is left whole
                        flat_ids = ids.reshape(-1)
                        flat_ids[[1, 5]] = [v + 7, -v - 3]  # outside [-V, V): NaN
                        flat_ids[3] = -2  # in [-V, 0): wraps
                    batch[name] = ids
                elif "mask" in name:
                    batch[name] = (rng.random(sds.shape) < 0.8).astype(np.float32)
                else:
                    e = rng.standard_normal(sds.shape).astype(np.float32)
                    batch[name] = e / np.linalg.norm(e, axis=-1, keepdims=True)
            step = jax.jit(a.family.step_fn(a, shape, reduced=True))
            res[f"rs/{arch}/{shape}"] = np.asarray(step(params, {k: jnp.asarray(v) for k, v in batch.items()}))
            for k, v in batch.items():
                res[f"rs/{arch}/{shape}/b/{k}"] = v
np.savez(os.path.join(out, "jax.npz"), **res)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, out], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=400)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    path = os.path.join(out, "jax.npz")
    return path, dict(np.load(path))


@pytest.fixture(scope="module")
def world(jax_run, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_world"))
    run_world(W.serve_world, 4, backend="gloo", device="cpu", args=(jax_run[0], out),
              threads=1, join_timeout_s=300)
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(4)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _lm(z, arch):
    cfg = get_arch(arch).reduced
    tree = W.tree_of(np.load(z[0]) if isinstance(z, tuple) else z, f"lm/{arch}/p/")
    return cfg, tree


@pytest.fixture(scope="module")
def one_process(jax_run):
    """The one-process port on JAX's weights: per LM its greedy run and its
    batch-1 decode over the whole cache; per recsys model and shape its
    outputs at both executors."""
    z = np.load(jax_run[0])
    out = {}
    for arch in W.LM_ARCHS:
        cfg = get_arch(arch).reduced
        tree = W.tree_of(z, f"lm/{arch}/p/")
        model = TransformerLM.from_params(cfg, params_from_jax(tree, cfg, device="cpu"))
        prompt = torch.from_numpy(z[f"lm/{arch}/prompt"]).long()
        out[arch] = W.lm_run(model, prompt, W.N, W.S + W.N, W.B)
        out[arch + "/seq"] = W.seq_decode(model, model, torch.from_numpy(
            z[f"lm/{arch}/seq_prompt"]).long(), z[f"lm/{arch}/seq_forced"])
    for arch in W.RECSYS_ARCHS:
        cfg = get_arch(arch).reduced
        params = params_from_jax(W.tree_of(z, f"rs/{arch}/p/"), cfg, device="cpu")
        for shape in W.RECSYS_SHAPES:
            for ex in ("reference", "kernel"):
                model = RECSYS_MODELS[type(cfg)].from_params(cfg, params)
                model.executor = ex
                out[f"rs/{arch}/{shape}/{ex}"] = serve_step(model, RECSYS_SHAPES_REDUCED[shape])(
                    W.recsys_batch(z, arch, shape))
    return out


MESH_TAGS = [f"{d}x{m}" for d, m in W.LM_MESHES]


def _rows(tag, rank):
    """The batch rows rank ``rank`` holds on mesh ``tag`` (data-major)."""
    d, m = (int(x) for x in tag.split("x"))
    per = W.B // d
    return slice((rank // m) * per, (rank // m + 1) * per)


@pytest.mark.parametrize("tag", MESH_TAGS)
@pytest.mark.parametrize("arch", W.LM_ARCHS)
def test_lm_mesh_equals_one_process_and_jax(jax_run, world, one_process, arch, tag):
    z = jax_run[1]
    logits1, toks1, _ = one_process[arch]
    for r, got in enumerate(world):
        rows = _rows(tag, r)
        _close(got[f"{arch}/{tag}/logits"], logits1.numpy()[:, rows])
        _close(got[f"{arch}/{tag}/logits"], z[f"lm/{arch}/logits"][:, rows])
        np.testing.assert_array_equal(got[f"{arch}/{tag}/tokens"], toks1.numpy())
        np.testing.assert_array_equal(got[f"{arch}/{tag}/tokens"], z[f"lm/{arch}/tokens"])
    for got in world[1:]:  # every rank holds rank 0's bits where it holds its rows
        np.testing.assert_array_equal(got[f"{arch}/{tag}/tokens"], world[0][f"{arch}/{tag}/tokens"])


@pytest.mark.parametrize("tag", MESH_TAGS)
@pytest.mark.parametrize("arch", W.LM_ARCHS)
def test_lm_cache_blocks_are_slices_of_the_one_process_cache(jax_run, world, one_process,
                                                             arch, tag):
    cfg = get_arch(arch).reduced
    d, m = (int(x) for x in tag.split("x"))
    _, _, (k1, v1) = one_process[arch]
    for r, got in enumerate(world):
        mesh = make_mesh((d, m), ("data", "model"))
        mesh.coords = dict(zip(mesh.axis_names, divmod(r, m)))
        first, count = sharding.kv_heads_of_rank(cfg, mesh)
        rows = _rows(tag, r)
        for name, full, jax_full in (("k", k1, jax_run[1][f"lm/{arch}/k"]),
                                     ("v", v1, jax_run[1][f"lm/{arch}/v"])):
            block = got[f"{arch}/{tag}/{name}"]
            want = full.numpy()[:, rows, :, first:first + count]
            assert block.shape == want.shape
            np.testing.assert_array_equal(block[0], want[0])
            for layer in range(cfg.n_layers):
                diff = np.linalg.norm(block[layer] - want[layer])
                assert diff <= 1e-6 * np.linalg.norm(want[layer]), (name, layer, diff)
            _close(block, jax_full[:, rows, :, first:first + count])


@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in W.SEQ_MESHES])
@pytest.mark.parametrize("arch", W.LM_ARCHS)
def test_shard_seq_decode_merges_to_the_whole_cache(jax_run, world, one_process, arch, tag):
    for got in world:
        _close(got[f"{arch}/{tag}/seq"], one_process[arch + "/seq"].numpy())
        _close(got[f"{arch}/{tag}/seq"], jax_run[1][f"lm/{arch}/seq"])
        np.testing.assert_array_equal(got[f"{arch}/{tag}/seq"], world[0][f"{arch}/{tag}/seq"])


def test_local_dispatch_at_data_two_matches_jax(jax_run, world):
    """Each data shard routes its own 16 tokens with its own capacity (10
    slots per expert, where one device's 32 tokens get 20): top_e, counts
    and drops exactly JAX's, y within 1e-5, every model rank alike."""
    z = jax_run[1]
    cap = 10
    assert max(1, int(1.25 * 16 * 2 / 4)) == cap != max(1, int(1.25 * 32 * 2 / 4))
    for r, got in enumerate(world):
        d = r // 2
        want_e = z[f"moe/top_e{d}"]
        np.testing.assert_array_equal(got["moe/top_e"], want_e)
        counts = np.bincount(want_e.ravel(), minlength=4)
        np.testing.assert_array_equal(got["moe/counts"], counts)
        np.testing.assert_array_equal(np.clip(got["moe/counts"] - cap, 0, None),
                                      np.clip(counts - cap, 0, None))
        _close(got["moe/y"], z["moe/y"][16 * d:16 * (d + 1)])
    # Both shards drop a pair (11 routed to one expert of 10 slots).
    assert all(np.clip(np.bincount(z[f"moe/top_e{d}"].ravel(), minlength=4) - cap, 0, None).sum()
               == 1 for d in range(2))
    for r in range(1, 4):
        np.testing.assert_array_equal(world[r]["moe/y"], world[r - (r % 2)]["moe/y"])


def test_generate_over_a_mesh_returns_every_row_on_every_rank(world, one_process):
    """``generate`` at (2, 2): each rank prefills and decodes its rows, and
    every rank returns all four rows' tokens, the one-process run's."""
    for got in world:
        np.testing.assert_array_equal(got["generate"], one_process["qwen3-4b"][1].numpy())


@pytest.mark.parametrize("arch,at,overrides", W.LM_VARIANTS)
def test_embed_head_and_expert_layouts_equal_one_process(jax_run, world, arch, at, overrides):
    """The vocab-split and replicated embeddings, the tied head (its product
    all-reduced from the D-split table, or gathered from the V-split one)
    and tp_only experts, against one process on the same draw."""
    cfg, key = W.variant(arch, overrides)
    from repro_torch.models import init_params

    z = jax_run[1]
    model = TransformerLM.from_params(cfg, init_params(cfg, torch.Generator().manual_seed(9),
                                                       device="cpu"))
    logits1, toks1, _ = W.lm_run(model, torch.from_numpy(z[f"lm/{arch}/prompt"]).long(), W.N,
                                 W.S + W.N, W.B)
    tag = f"{at[0]}x{at[1]}"
    for r, got in enumerate(world):
        _close(got[f"{key}/logits"], logits1.numpy()[:, _rows(tag, r)])
        np.testing.assert_array_equal(got[f"{key}/tokens"], toks1.numpy())


@pytest.mark.parametrize("ex", ["reference", "kernel"])
@pytest.mark.parametrize("shape", W.RECSYS_SHAPES)
@pytest.mark.parametrize("tag", [f"{d}x{m}" for d, m in W.RECSYS_MESHES])
@pytest.mark.parametrize("arch", W.RECSYS_ARCHS)
def test_recsys_mesh_equals_one_process_and_jax(jax_run, world, one_process, arch, tag, shape, ex):
    want1 = one_process[f"rs/{arch}/{shape}/{ex}"].numpy()
    for got in world:
        out = got[f"rs/{arch}/{tag}/{shape}/{ex}"]
        np.testing.assert_array_equal(np.isnan(out), np.isnan(want1))
        _close(out, want1)
        if ex == "reference":  # JAX's gathers: NaN rows where an id is out of range
            want = jax_run[1][f"rs/{arch}/{shape}"]
            np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
            _close(out, want)
    assert not np.isnan(want1).all()
    if ex == "reference" and shape == "serve_p99":
        assert np.isnan(want1).any()


@pytest.mark.parametrize("shape", W.RECSYS_SHAPES)
def test_a_table_that_does_not_divide_stays_whole(jax_run, world, shape):
    """Two-tower with 1,002 user rows at model 4: the user table stays
    replicated, the item table is split, and the outputs equal one process."""
    z = np.load(jax_run[0])
    cfg = W.recsys_cfg("two-tower-retrieval", split_all=False)
    from repro_torch.models import init_params

    mesh = make_mesh((1, 4), ("data", "model"))
    specs = sharding.recsys_param_pspec(init_params(cfg, torch.Generator(), device="meta"), mesh)
    assert tuple(specs["user_table"]) == (None, None)
    assert tuple(specs["item_table"]) == (("model",), None)
    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    for ex in ("reference", "kernel"):
        model = RECSYS_MODELS[type(cfg)].from_params(cfg, params)
        model.executor = ex
        want = serve_step(model, RECSYS_SHAPES_REDUCED[shape])(
            W.recsys_batch(z, "two-tower-retrieval", shape)).numpy()
        for tag in ("1x4", "2x2"):
            for got in world:
                out = got[f"rs/two-tower-retrieval/{tag}/{shape}/{ex}/whole"]
                np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
                _close(out, want)


@pytest.mark.parametrize("arch", W.LM_ARCHS + W.RECSYS_ARCHS)
def test_a_one_by_one_mesh_is_the_one_process_port_bit_for_bit(jax_run, one_process, arch):
    z = np.load(jax_run[0])
    mesh = make_mesh((1, 1), ("data", "model"), RankGroup(0, 1, "gloo", "cpu"))
    cfg = get_arch(arch).reduced
    if arch in W.LM_ARCHS:
        tree = W.tree_of(z, f"lm/{arch}/p/")
        model = TransformerLM.from_params(cfg, params_from_jax(tree, cfg, device="cpu",
                                                               mesh=mesh), mesh=mesh)
        prompt = torch.from_numpy(z[f"lm/{arch}/prompt"]).long()
        got = W.lm_run(model, prompt, W.N, W.S + W.N, W.B)
        want = one_process[arch]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(got[2][0], want[2][0]) and torch.equal(got[2][1], want[2][1])
        return
    params = params_from_jax(W.tree_of(z, f"rs/{arch}/p/"), cfg, device="cpu", mesh=mesh)
    for shape in W.RECSYS_SHAPES:
        for ex in ("reference", "kernel"):
            got = W.serve(mesh, z, arch, shape, ex, params, cfg)
            assert torch.equal(got.isnan(), one_process[f"rs/{arch}/{shape}/{ex}"].isnan())
            torch.testing.assert_close(got, one_process[f"rs/{arch}/{shape}/{ex}"], rtol=0,
                                       atol=0, equal_nan=True)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("mixtral-8x7b", "decode_32k", (1, 4)),
    ("din", "serve_p99", (2, 2)),
])
def test_dry_run_over_four_ranks(arch, shape, mesh):
    """One LM cell and one recsys cell over a mesh of 4 gloo CPU ranks:
    the record's mesh, devices and MFU, and its collectives counted per op
    as the layers' code implies (mixtral at (1, 4): an all-reduce after wo
    and one after the MoE per layer, one all-gather each for the embedding
    and the logits; DIN at (2, 2): one all-reduce per table gather)."""
    rec = dryrun.run_cell(arch, shape, device="cpu", reduced=True, ranks=4, mesh=mesh, iters=1,
                          verbose=False)
    assert rec["mesh"] == "ranks4" and rec["n_devices"] == 4 and rec["ok"]
    assert rec["measured"]["mfu"] > 0
    layers = get_arch(arch).reduced.n_layers if arch == "mixtral-8x7b" else 0
    want = ({"all-reduce": 2 * layers, "all-gather": 2} if layers else {"all-reduce": 2})
    assert rec["collectives"]["counts"] == want


def test_train_cells_over_ranks_raise():
    """Every family's train cells run over ranks (gin-tu's in tests/test_
    torch_mesh_train_gnn.py); a train cell over a mesh whose shape is not of
    the ranks given still raises."""
    with pytest.raises(ValueError, match="does not have 4 ranks"):
        dryrun.run_cell("gin-tu", "molecule", device="cpu", reduced=True, ranks=4, mesh=(2, 3))
