"""Port parity of LM training on the CPU: ``repro_torch.train``,
``repro_torch.data.pipeline`` and ``repro_torch.launch.train`` against
``repro.train`` / ``repro.data``.

The optimizer's schedule, clipping and update, and three train steps of
the reduced qwen2-0.5b and mixtral-8x7b from the same weights and batches,
agree within 1e-5 relative in float32 (losses, ce, aux, grad_norm, lr and
the step-1 gradients; float32 sums in another order), at JAX's default
learning rate of 3e-4 after one warmup step. The trained parameters agree
within 1e-5 relative plus 0.1 x lr absolute over the three steps: Adam
divides each gradient by its own root mean square, so an element whose
gradient is near ``eps`` or cancels to float32 noise moves by ``lr`` times
a ratio that the noise can shift (by up to 0.05 here); a flipped sign
would move it by 2 x lr. With compression on, a float32 difference can
move a gradient element across a rounding boundary of the int8 grid, one
quantum (max |g| / 127), which can flip such a sign: there lr agrees
within 1e-5, the loss terms within 1e-4, grad_norm within 1e-3 and the
parameters within 2 x lr per step. Microbatches 2 equal 1 for the dense
qwen2 only: an MoE layer's capacity and aux loss are per microbatch
(JAX's too). int8 quantization
is bit for bit (exact halves round to even in both), and so is error
feedback over 5 steps. Checkpoints keep JAX's layout file for file; the
batch pipeline is JAX's to the bit.
"""

import dataclasses
import functools
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x7b as jmix
from repro.configs import qwen2_0_5b as jq2
from repro.data import pipeline as jpipe
from repro.models.transformer import TransformerLM as JLM
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import mixtral_8x7b, qwen2_0_5b
from repro_torch.configs.families import lm_loss_fn
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as train_cli
from repro_torch.models import TransformerLM, params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import compression as tcomp
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)  # xdist runs one test process per core

REL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(warmup_steps=1, total_steps=6)
TRAINED = dict(rtol=1e-5, atol=0.1 * 3e-4)  # 3 steps; see the module docstring
MODELS = {"qwen2": (jq2.REDUCED, qwen2_0_5b.REDUCED), "mixtral": (jmix.REDUCED, mixtral_8x7b.REDUCED)}


def _tree(seed=0):
    """A small dict of float32 arrays (numpy) and gradients for it."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 2, 3)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    return p, g


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 2500, 9999, 10000, 10001, 25000])
def test_schedule_matches_jax(step):
    cfg = topt.AdamWConfig()
    got = float(topt.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(jopt.schedule(jopt.AdamWConfig(), jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.01, 100.0])  # clipping off, on
def test_adamw_update_and_clip_match_jax(grad_scale):
    p, _ = _tree(1)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    tp, tstate = _t(p), topt.adamw_init(_t(p))
    jp, jstate = {k: jnp.asarray(v) for k, v in p.items()}, jopt.adamw_init(p)
    for s in range(3):
        _, g = _tree(10 + s)
        g = {k: v * grad_scale for k, v in g.items()}
        clipped, gnorm = topt.clip_by_global_norm(_t(g), 1.0)
        jclipped, jgnorm = jopt.clip_by_global_norm(g, 1.0)
        np.testing.assert_allclose(float(gnorm), float(jgnorm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(clipped[k].numpy(), np.asarray(jclipped[k]), **REL)
        tp, tstate, tm = topt.adamw_update(topt.AdamWConfig(**cfg), tp, _t(g), tstate)
        jp, jstate, jm = jopt.adamw_update(jopt.AdamWConfig(**cfg), jp, g, jstate)
        assert int(tstate["step"]) == int(jstate["step"]) == s + 1
        assert tstate["step"].dtype == torch.int32
        for name in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-6)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **REL)
            for mv in ("m", "v"):
                assert tstate[mv][k].dtype == torch.float32
                np.testing.assert_allclose(tstate[mv][k].numpy(), np.asarray(jstate[mv][k]), **REL)


def test_quantize_int8_bit_for_bit_with_exact_halves():
    # scale = 127 / 127 (+1e-12, lost in float32) = 1: x / scale holds exact halves.
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5, 0.49999997], np.float32)
    q, scale = tcomp.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert float(scale) == float(jscale) == 1.0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.numpy().tolist() == [127, 0, 2, 2, 0, -2, 4, -126, 0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    q, scale = tcomp.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_error_feedback_over_five_steps_matches_jax():
    p, _ = _tree(2)
    terr, jerr = tcomp.init_error_state(_t(p)), jcomp.init_error_state(p)
    for s in range(5):
        _, g = _tree(20 + s)
        tg, terr = tcomp.compress_grads(_t(g), terr)
        jg, jerr = jcomp.compress_grads(g, jerr)
        for k in g:
            np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]))
    assert tcomp.compress_grads(_t(g), terr, enabled=False)[0]["a"] is not None


# ---------------------------------------------------------------------------
# training the reduced LMs
# ---------------------------------------------------------------------------


def _batches(cfg, n, b=4, s=24, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        labels = toks.copy()
        labels[:, :3] = -1  # masked positions
        out.append({"tokens": toks, "labels": labels})
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(name, microbatches, compression, steps=3):
    jcfg = MODELS[name][0]
    params = JLM.init(jax.random.PRNGKey(5), jcfg)
    step = jax.jit(jloop.make_train_step(
        lambda p, b: JLM.loss(p, jcfg, b["tokens"], b["labels"]), jopt.AdamWConfig(**OPT),
        microbatches=microbatches, compression=compression,
    ))
    state = jloop.TrainState.create(params, compression=compression)
    metrics = []
    for b in _batches(jcfg, steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state.params), metrics


def _port_run(name, microbatches, compression, steps=3, remat=False):
    jcfg, cfg = MODELS[name]
    cfg = dataclasses.replace(cfg, remat=remat)
    init, _, _ = _jax_run(name, microbatches, compression)
    state = tloop.TrainState.create(params_from_jax(init, cfg, device="cpu"), compression=compression)
    step = tloop.make_train_step(lm_loss_fn(cfg), topt.AdamWConfig(**OPT),
                                 microbatches=microbatches, compression=compression)
    metrics = []
    for b in _batches(jcfg, steps):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("name,microbatches,compression", [
    ("qwen2", 1, False), ("mixtral", 2, False), ("qwen2", 1, True),
])
def test_three_train_steps_match_jax(name, microbatches, compression):
    jcfg, cfg = MODELS[name]
    _, jfinal, jmetrics = _jax_run(name, microbatches, compression)
    state, metrics = _port_run(name, microbatches, compression)
    for got, want in zip(metrics, jmetrics):
        assert set(got) == set(want) == {"loss", "ce", "aux", "lr", "grad_norm"}
        for k in want:
            rtol = 1e-5
            if compression and k != "lr":
                rtol = 1e-3 if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)
    if jcfg.moe is not None:
        assert metrics[0]["aux"] > 0
    want = params_from_jax(jfinal, cfg, device="cpu")
    assert list(state.params) == list(want)
    for k, p in state.params.items():
        p, w = p.detach(), want[k]
        tol = dict(rtol=1e-5, atol=3 * 2 * 3e-4) if compression else TRAINED
        np.testing.assert_allclose(p.numpy(), w.numpy(), **tol, err_msg=k)
    assert (state.error_fb is not None) == compression


@pytest.mark.parametrize("name", list(MODELS))
def test_step_one_gradients_match_jax(name):
    """Every parameter's gradient (one per layer in the port, stacked in
    JAX) within 1e-5 of its norm."""
    jcfg, cfg = MODELS[name]
    init = _jax_run(name, 1, False)[0]
    b = _batches(jcfg, 1)[0]
    jgrad = jax.jit(jax.grad(lambda p, t, y: JLM.loss(p, jcfg, t, y)[0]))(
        jax.tree.map(jnp.asarray, init), jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]))
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg, device="cpu")
    params = tloop.TrainState.create(params_from_jax(init, cfg, device="cpu")).params
    loss, _ = lm_loss_fn(cfg)(params, {k: torch.from_numpy(v) for k, v in b.items()})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32
        assert float((g - want[k]).norm() / want[k].norm()) <= 1e-5, k


def test_microbatches_two_equal_one():
    s1, m1 = _port_run("qwen2", 1, False, steps=1)
    s2, m2 = _port_run("qwen2", 2, False, steps=1)
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(m2[0][k], m1[0][k], rtol=1e-5)
    for k in s1.params:
        np.testing.assert_allclose(s2.params[k].detach().numpy(), s1.params[k].detach().numpy(),
                                   **TRAINED)


def test_remat_gives_the_same_step_and_every_parameter_a_gradient():
    s0, m0 = _port_run("mixtral", 1, False, steps=1)
    s1, m1 = _port_run("mixtral", 1, False, steps=1, remat=True)
    assert m0 == m1
    for k in s0.params:
        assert torch.equal(s0.params[k], s1.params[k]), k
    # Every parameter moved (each got a gradient; autograd.grad refuses an unused one).
    init = params_from_jax(_jax_run("mixtral", 1, False)[0], MODELS["mixtral"][1], device="cpu")
    assert all(not torch.equal(s0.params[k], init[k]) for k in init)


def test_loss_under_no_grad_equals_the_differentiated_loss():
    jcfg, cfg = MODELS["mixtral"]
    init = params_from_jax(_jax_run("mixtral", 1, False)[0], cfg, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batches(jcfg, 1)[0].items()}
    model = TransformerLM.from_params(cfg, tloop.TrainState.create(init).params, trainable=True)
    with torch.no_grad():
        want, _ = model.loss(b["tokens"], b["labels"])
    got, _ = model.loss(b["tokens"], b["labels"])
    assert got.requires_grad and float(got) == float(want)
    jl, _ = jax.jit(lambda p, t, y: JLM.loss(p, jcfg, t, y))(
        _jax_run("mixtral", 1, False)[0], jnp.asarray(b["tokens"].numpy()), jnp.asarray(b["labels"].numpy()))
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    fused = dataclasses.replace(cfg, fused_ce=True)
    got_f, _ = TransformerLM.from_params(fused, init).loss(b["tokens"], b["labels"])
    np.testing.assert_allclose(float(got_f), float(jl), rtol=1e-5)


def test_flash_wrapper_refuses_inputs_that_require_grad():
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    with pytest.raises(ValueError, match="forward only"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == q.shape


# ---------------------------------------------------------------------------
# checkpoints and the loop
# ---------------------------------------------------------------------------


def _files(d):
    return {
        os.path.relpath(os.path.join(r, f), d)
        for r, _, fs in os.walk(d) for f in fs
    } | {os.path.relpath(os.path.join(r, x), d) for r, xs, _ in os.walk(d) for x in xs}


def test_checkpoint_layout_matches_jax_file_for_file(tmp_path):
    p, _ = _tree(4)
    for step in (3, 7):
        jckpt.save_checkpoint(str(tmp_path / "jax"), step, p)
        tckpt.save_checkpoint(str(tmp_path / "port"), step, _t(p))
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    for f in _files(tmp_path / "jax"):
        a, b = tmp_path / "jax" / f, tmp_path / "port" / f
        if f.endswith(".npy"):
            assert a.read_bytes() == b.read_bytes(), f
        elif f.endswith("manifest.json"):
            ja, tb = json.loads(a.read_text()), json.loads(b.read_text())
            assert ja["step"] == tb["step"]
            assert [{k: x[k] for k in ("file", "shape", "dtype")} for x in tb["leaves"]] == ja["leaves"]
            assert [x["name"] for x in tb["leaves"]] == ["a", "b", "c"]
    # Each reads the other's steps.
    assert jckpt.latest_step(str(tmp_path / "port")) == tckpt.latest_step(str(tmp_path / "jax")) == 7
    back, step = tckpt.restore_checkpoint(str(tmp_path / "jax"), _t(p), 3)
    assert step == 3 and all(torch.equal(back[k], _t(p)[k]) for k in p)


def test_train_state_checkpoint_roundtrip_and_layout(tmp_path):
    state, _ = _port_run("qwen2", 1, False, steps=1)
    init, jfinal, _ = _jax_run("qwen2", 1, False)
    jstate = jloop.TrainState.create(jax.tree.map(jnp.asarray, init))
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, jstate)
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, state)
    jm = json.loads((tmp_path / "jax" / "step_00000001" / "manifest.json").read_text())
    tm = json.loads((tmp_path / "port" / "step_00000001" / "manifest.json").read_text())
    # JAX stacks layers; both hold params, m, v (float32) and one int32 step.
    size = lambda m: sum(int(np.prod(x["shape"])) for x in m["leaves"])  # noqa: E731
    assert size(tm) == size(jm)
    assert sorted({x["dtype"] for x in tm["leaves"]}) == sorted({x["dtype"] for x in jm["leaves"]})
    names = _files(tmp_path / "port" / "step_00000001")
    assert names == {"manifest.json", "_COMMITTED"} | {f"leaf_{i:05d}.npy" for i in range(len(tm["leaves"]))}
    fresh = tloop.TrainState.create(params_from_jax(init, qwen2_0_5b.REDUCED, device="cpu"))
    back, step = tckpt.restore_checkpoint(str(tmp_path / "port"), fresh)
    assert step == 1 and isinstance(back.params["embed"], torch.nn.Parameter)
    for (n, a), (_, b) in zip(tckpt.flatten(back), tckpt.flatten(state)):
        assert torch.equal(a, b), n
    assert back.opt["step"].dtype == torch.int32


def test_uncommitted_steps_are_ignored_and_retain_last_keeps_the_newest(tmp_path):
    d = str(tmp_path / "c")
    p, _ = _tree(5)
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, step, _t(p))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a torn write
    os.makedirs(os.path.join(d, "step_00000008"))  # no commit marker
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 5
    tckpt.retain_last(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005", "step_00000008",
                                     "step_00000009.tmp"]
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), _t(p))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(d, {"a": _t(p)["a"]})


def test_train_loop_resumes_after_an_injected_failure(tmp_path):
    jcfg, cfg = MODELS["mixtral"]
    init = _jax_run("mixtral", 1, False)[0]
    batches = _batches(jcfg, 6)
    kw = dict(
        init_params_fn=lambda: params_from_jax(init, cfg, device="cpu"),
        loss_fn=lm_loss_fn(cfg), batch_iter=lambda s: batches[s],
        opt_cfg=topt.AdamWConfig(**OPT), n_steps=6, ckpt_every=2, log_every=100,
        log_fn=lambda s: None, device="cpu",
    )
    d = str(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="injected failure"):
        tloop.train_loop(ckpt_dir=d, failure=tloop.FailureInjector(fail_at=(3,)), **kw)
    assert tckpt.latest_step(d) == 2
    logs = []
    resumed, _ = tloop.train_loop(ckpt_dir=d, **{**kw, "log_fn": logs.append})
    assert logs[0].startswith("[resume] restored step 2")
    clean, hist = tloop.train_loop(ckpt_dir=None, **kw)
    assert hist[-1]["step"] == 6
    for (n, a), (_, b) in zip(tckpt.flatten(resumed), tckpt.flatten(clean)):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------------------
# the data pipeline and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_samples", [None, 50])
def test_sharded_batcher_and_reassign_match_jax(n_samples):
    kw = dict(global_batch=24, n_shards=4, seed=7, n_samples=n_samples)
    t, j = tpipe.ShardedBatcher(**kw), jpipe.ShardedBatcher(**kw)
    for step in (0, 1, 3, 9):
        for shard in range(4):
            np.testing.assert_array_equal(t.shard_ids(step, shard), j.shard_ids(step, shard))
        for dead in ({1}, {0, 3}):
            got, want = t.reassign(step, dead), j.reassign(step, dead)
            assert sorted(got) == sorted(want)
            for s in got:
                np.testing.assert_array_equal(got[s], want[s])
    fetch_t, fetch_j = tpipe.synthetic_lm_fetch(256, 16), jpipe.synthetic_lm_fetch(256, 16)
    ids = t.shard_ids(2, 1)
    for k, v in fetch_j(ids).items():
        np.testing.assert_array_equal(fetch_t(ids)[k], v)
    with pytest.raises(ValueError):
        tpipe.ShardedBatcher(global_batch=10, n_shards=4)


def test_train_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    d = str(tmp_path / "run")
    args = ["--device", "cpu", "--arch", "qwen2-0.5b", "--ckpt-dir", d, "--ckpt-every", "2"]
    assert train_cli.main(args + ["--steps", "4"]) == 0
    assert tckpt.latest_step(d) == 4 and "done" in capsys.readouterr().out
    assert train_cli.main(args + ["--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 4" in out and "step 6/6" in out
    # The batch key is stable across processes (crc32, not the salted hash).
    assert train_cli.batch_key(0, 3, "tokens") == [0, 3, zlib.crc32(b"tokens")] == [0, 3, 2858029454]


@pytest.mark.parametrize("arch,err", [
    ("din", NotImplementedError), ("gin-tu", KeyError), ("warp-xtr", SystemExit),
])
def test_train_launcher_refuses_archs_it_does_not_train(arch, err):
    with pytest.raises(err):
        train_cli.main(["--device", "cpu", "--arch", arch])
    with pytest.raises(SystemExit, match="not a training shape"):
        train_cli.main(["--device", "cpu", "--arch", "qwen2-0.5b", "--shape", "prefill_32k"])
