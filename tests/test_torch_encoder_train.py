"""Training the port's XTR token encoder against the JAX package's (CPU).

``examples/train_encoder.py`` (the JAX package) and its port
``examples/train_encoder_torch.py`` are loaded by path; the JAX module's
``CFG`` is set with ``monkeypatch`` (the file is not edited). From the same
JAX ``TokenEncoder.init`` weights (``params_from_jax``) and numpy-seeded
batches with ragged query and document masks (one query and its document
wholly masked, so a row of -1e30 keys must stay finite), at the example's
width (2 layers, d 64, vocab 512, out 32) and at full width with 2 layers:

- the XTR in-batch loss within 1e-5 relative (JAX's matmuls at "highest"
  precision; float32 sums in another order);
- each step-1 gradient within 1e-5 of its norm, the embedding's exactly 0
  on rows the batch does not name;
- three steps of ``make_train_step`` against JAX's ``jit(make_train_step)``
  at the example's AdamW, at 1 and 2 microbatches: metrics within 1e-5
  relative, parameters within 1e-5 relative + 0.1 x lr (the LM training
  rule: Adam divides each gradient by its own root mean square, so float32
  noise in near-zero gradients moves an element by a fraction of lr).

Then the port alone: the loss under ``no_grad`` equals the differentiated
loss, a frozen and a trainable encoder encode bit for bit alike,
``train_loop`` resumed after an injected failure ends bit for bit, and the
example runs (``--steps 3 --device cpu``), imports neither JAX nor
``repro`` and refuses to fall back to the CPU without a card.
"""

import ast
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.encoder import EncoderConfig as JaxEncoderConfig
from repro.models.encoder import TokenEncoder as JaxEncoder
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs.families import encoder_loss_fn
from repro_torch.models import EncoderConfig, TokenEncoder, params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt

torch.set_num_threads(1)  # xdist runs one test process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(ROOT, "examples", "train_encoder.py")
PORT_EXAMPLE = os.path.join(ROOT, "examples", "train_encoder_torch.py")

WIDTHS = {
    "example": dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=512, out_dim=32),
    "full_2_layers": dict(n_layers=2),
}
DOC_LEN, Q_LEN = 12, 6
D_LENS = (12, 9, 5, 0, 12, 3)  # document 3 wholly masked ...
Q_LENS = (6, 4, 6, 0, 2, 6)  # ... and so its query
OPT = dict(lr=3e-3, warmup_steps=20, total_steps=200)  # the example's AdamW at its default steps
REL = 1e-5
TRAINED = dict(rtol=1e-5, atol=0.1 * OPT["lr"])


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jex = _load("train_encoder_jax_example", JAX_EXAMPLE)
tex = _load("train_encoder_torch_example", PORT_EXAMPLE)


@pytest.fixture(params=sorted(WIDTHS))
def width(request, monkeypatch):
    """A width's name, with both examples' ``CFG`` set to it."""
    monkeypatch.setattr(jex, "CFG", JaxEncoderConfig(**WIDTHS[request.param]))
    monkeypatch.setattr(tex, "CFG", EncoderConfig(**WIDTHS[request.param]))
    return request.param


def _batch(vocab: int, seed: int) -> dict:
    """Queries that are noisy sub-sequences of their document's valid
    tokens, ragged masks (numpy)."""
    rng = np.random.default_rng(seed)
    b = len(D_LENS)
    d_tok = rng.integers(0, vocab, (b, DOC_LEN)).astype(np.int32)
    q_tok = rng.integers(0, vocab, (b, Q_LEN)).astype(np.int32)
    for i, (dl, ql) in enumerate(zip(D_LENS, Q_LENS)):
        if ql and dl >= ql:
            s = rng.integers(0, dl - ql + 1)
            q_tok[i, :ql] = d_tok[i, s:s + ql]
    d_mask = (np.arange(DOC_LEN)[None] < np.asarray(D_LENS)[:, None]).astype(np.float32)
    q_mask = (np.arange(Q_LEN)[None] < np.asarray(Q_LENS)[:, None]).astype(np.float32)
    return {"q_tok": q_tok * (q_mask > 0), "q_mask": q_mask,
            "d_tok": d_tok * (d_mask > 0), "d_mask": d_mask}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _init(name):
    """JAX ``TokenEncoder.init`` of a width, as numpy."""
    params = JaxEncoder.init(jax.random.PRNGKey(7), JaxEncoderConfig(**WIDTHS[name]))
    return jax.tree.map(np.asarray, params)


def _port_params(name):
    return params_from_jax(_init(name), EncoderConfig(**WIDTHS[name]), device="cpu")


def test_loss_matches_jax(width):
    batch = _batch(WIDTHS[width].get("vocab", 32128), seed=1)
    with jax.default_matmul_precision("highest"):
        want, wm = jax.jit(jex.xtr_inbatch_loss)(_init(width), _j(batch))
    got, m = tex.xtr_inbatch_loss(_port_params(width), _t(batch))
    got = got.detach()
    assert np.isfinite(float(want)) and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=REL)
    assert set(m) == set(wm) == {"xtr_ce"} and float(m["xtr_ce"].detach()) == float(got)


def test_step_one_gradients_match_jax(width):
    cfg = EncoderConfig(**WIDTHS[width])
    batch = _batch(cfg.vocab, seed=2)
    with jax.default_matmul_precision("highest"):
        jgrad = jax.jit(jax.grad(lambda p, b: jex.xtr_inbatch_loss(p, b)[0]))(_init(width), _j(batch))
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg, device="cpu")
    params = tloop.TrainState.create(_port_params(width)).params
    loss, _ = encoder_loss_fn(cfg, tex.xtr_inbatch_loss)(params, _t(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all()), k
        assert float((g - want[k]).norm() / want[k].norm()) <= REL, k
    named = np.zeros(cfg.vocab, bool)  # the ids at valid places; a masked place's output is 0
    named[batch["q_tok"][batch["q_mask"] > 0]] = named[batch["d_tok"][batch["d_mask"] > 0]] = True
    rows = grads["embed"].abs().sum(-1).numpy()
    assert (rows[~named] == 0).all() and (rows[named] > 0).all()


@functools.lru_cache(maxsize=None)
def _jax_run(name, microbatches, steps=3):
    jcfg = JaxEncoderConfig(**WIDTHS[name])
    jex.CFG, saved = jcfg, jex.CFG
    try:
        with jax.default_matmul_precision("highest"):
            step = jax.jit(jloop.make_train_step(jex.xtr_inbatch_loss, jopt.AdamWConfig(**OPT),
                                                 microbatches=microbatches))
            state = jloop.TrainState.create(jax.tree.map(jnp.asarray, _init(name)))
            metrics = []
            for s in range(steps):
                state, m = step(state, _j(_batch(jcfg.vocab, seed=10 + s)))
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        jex.CFG = saved
    return jax.tree.map(np.asarray, state.params), metrics


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_match_jax(width, microbatches):
    cfg = EncoderConfig(**WIDTHS[width])
    jfinal, jmetrics = _jax_run(width, microbatches)
    state = tloop.TrainState.create(_port_params(width))
    step = tloop.make_train_step(encoder_loss_fn(cfg, tex.xtr_inbatch_loss),
                                 topt.AdamWConfig(**OPT), microbatches=microbatches)
    for s, want in enumerate(jmetrics):
        state, m = step(state, _t(_batch(cfg.vocab, seed=10 + s)))
        got = {k: float(v) for k, v in m.items()}
        assert set(got) == set(want) == {"loss", "xtr_ce", "lr", "grad_norm"}
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=1e-7, err_msg=k)
    want = params_from_jax(jfinal, cfg, device="cpu")
    assert list(state.params) == list(want)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), **TRAINED, err_msg=k)


def test_loss_under_no_grad_equals_the_differentiated_loss(width):
    cfg = EncoderConfig(**WIDTHS[width])
    batch = _t(_batch(cfg.vocab, seed=3))
    model = TokenEncoder.from_params(cfg, tloop.TrainState.create(_port_params(width)).params,
                                     trainable=True)
    with torch.no_grad():
        want, _ = tex.xtr_inbatch_loss(model, batch)
    got, _ = tex.xtr_inbatch_loss(model, batch)
    assert got.requires_grad and not want.requires_grad
    assert float(got.detach()) == float(want)


def test_frozen_and_trainable_encoders_encode_alike(width):
    cfg = EncoderConfig(**WIDTHS[width])
    batch = _batch(cfg.vocab, seed=4)
    params = tloop.TrainState.create(_port_params(width)).params
    trainable = TokenEncoder.from_params(cfg, params, trainable=True)
    frozen = TokenEncoder.from_params(cfg, params)
    # The trainable module's parameters are the state's objects; freezing a
    # view of them leaves them trainable and shares their storage.
    assert all(p is params[k] for k, p in trainable.named_parameters())
    assert all(p.requires_grad for p in params.values())
    assert not any(p.requires_grad for p in frozen.parameters())
    assert frozen.embed.data_ptr() == params["embed"].data_ptr()
    tok, mask = torch.from_numpy(batch["d_tok"]), torch.from_numpy(batch["d_mask"] > 0)
    served = frozen.encode(tok, mask)
    assert not served.requires_grad
    assert torch.equal(trainable.encode(tok, mask), served)
    out = trainable(tok, mask)
    assert out.requires_grad and torch.equal(out.detach(), served)
    assert torch.equal(frozen(tok, mask), served)


def test_train_loop_resumes_after_an_injected_failure(tmp_path, monkeypatch):
    cfg = EncoderConfig(**WIDTHS["example"])
    monkeypatch.setattr(tex, "CFG", cfg)
    kw = dict(
        init_params_fn=lambda: _port_params("example"),
        loss_fn=encoder_loss_fn(cfg, tex.xtr_inbatch_loss),
        batch_iter=lambda s: _batch(cfg.vocab, seed=20 + s),
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
    assert hist[-1]["step"] == 6 and np.isfinite(hist[-1]["loss"])
    for (n, a), (_, b) in zip(tckpt.flatten(resumed), tckpt.flatten(clean)):
        assert torch.equal(a, b), n


def test_make_batch_draws_the_jax_examples_numbers():
    for step in (0, 5):
        got, want = tex.make_batch(step), jex.make_batch(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    big = tex.make_batch(1, cfg=EncoderConfig(), doc_len=192, q_len=32, batch=128)
    assert big["q_tok"].shape == (128, 32) and big["d_tok"].shape == (128, 192)
    assert big["q_tok"].dtype == torch.int32 and int(big["d_tok"].max()) < EncoderConfig().vocab


def test_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, PORT_EXAMPLE, "--steps", "3", "--device", "cpu"],
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "untrained encoder success@5" in out.stdout and "trained encoder success@5" in out.stdout


def test_example_imports_neither_jax_nor_repro_and_needs_a_card_by_default(monkeypatch):
    tree = ast.parse(open(PORT_EXAMPLE).read(), PORT_EXAMPLE)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert {m.split(".")[0] for m in names} <= {"argparse", "tempfile", "numpy", "torch",
                                                 "repro_torch"}
    code = (
        "import importlib.util, sys; "
        f"spec = importlib.util.spec_from_file_location('ex', {PORT_EXAMPLE!r}); "
        "spec.loader.exec_module(importlib.util.module_from_spec(spec)); "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tex.main(["--steps", "1"])


def test_encoder_configs_agree():
    assert dataclasses.asdict(tex.CFG) == dataclasses.asdict(jex.CFG)
    assert (tex.DOC_LEN, tex.Q_LEN, tex.BATCH) == (jex.DOC_LEN, jex.Q_LEN, jex.BATCH)
