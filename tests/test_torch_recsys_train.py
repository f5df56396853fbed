"""Port parity of recsys training on the CPU: the four recsys losses of
``repro_torch.models.recsys``, ``RecsysFamily.step_fn("train_batch")`` and
``RecsysFamily.smoke`` against the JAX package, at the ``REDUCED`` configs
and ``train_batch`` shape, JAX's ``init`` weights carried across by
``params_from_jax``, batches made with numpy from a seed; and the
embedding bag's autograd Function (its plain backward on CPU tensors)
against autograd through ``ref.take`` + sum.

Tolerances: losses and metrics 1e-5 relative; step-1 gradients per tensor
within 1e-5 of the JAX gradient's norm (float32 sums in another order);
three optimizer steps, params within 1e-5 relative + 0.1 x lr at lr 3e-4
(Adam divides each gradient by its own root mean square, so float32 noise
in a near-zero gradient moves an element by a fraction of lr; see
``tests/test_torch_train.py``). Both executors: "reference" is JAX's code
line for line; "kernel" (set on a CPU model) routes the bag sums through
the bag's Function, whose plain backward the card holds the CUDA
backward to. The bag Function's gradients match autograd through take +
sum per element within the backward's error bound.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import din as jdin
from repro.configs import sasrec as jsasrec
from repro.configs import two_tower_retrieval as jtt
from repro.configs import xdeepfm as jxdeepfm
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import din, sasrec, two_tower_retrieval, xdeepfm
from repro_torch.configs.families import RECSYS_SHAPES_REDUCED, RecsysFamily, recsys_loss_fn
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.models import params_from_jax
from repro_torch.models.recsys import RECSYS_MODELS
from repro_torch.train import AdamWConfig, TrainState, make_train_step

torch.set_num_threads(1)  # xdist runs one test process per core
torch.set_float32_matmul_precision("highest")

ARCHS = {
    "two_tower": (jtt, two_tower_retrieval),
    "sasrec": (jsasrec, sasrec),
    "din": (jdin, din),
    "xdeepfm": (jxdeepfm, xdeepfm),
}
BAG_ARCHS = ("two_tower", "din", "xdeepfm")
EXECUTORS = [(a, "reference") for a in ARCHS] + [(a, "kernel") for a in BAG_ARCHS]
WARM = dict(warmup_steps=1, total_steps=6)  # lr 3e-4 from the first step
TRAINED = dict(rtol=1e-5, atol=0.1 * 3e-4)


def _mask(rng, rows, width, *, left=False):
    n = rng.integers(1, width + 1, (rows, 1))
    pos = np.arange(width)
    return (pos >= width - n if left else pos < n).astype(np.float32)


def _train_batch(cfg, seed):
    """The train_batch inputs of ``RecsysFamily.input_specs`` for ``cfg``:
    ids uniform over the vocabulary, masks with 1..width valid slots (a
    suffix for SASRec), labels 0/1, log_q standard normal."""
    rng = np.random.default_rng(seed)
    b = RECSYS_SHAPES_REDUCED["train_batch"].batch

    def ids(vocab, *dims):
        return rng.integers(0, vocab, dims).astype(np.int32)

    name = type(cfg).__name__
    if name == "TwoTowerConfig":
        return {"user_ids": ids(cfg.user_vocab, b, cfg.user_fields),
                "user_mask": _mask(rng, b, cfg.user_fields),
                "item_ids": ids(cfg.item_vocab, b, cfg.item_fields),
                "item_mask": _mask(rng, b, cfg.item_fields),
                "log_q": rng.standard_normal(b).astype(np.float32)}
    if name == "SASRecConfig":
        return {"seq_ids": ids(cfg.item_vocab, b, cfg.seq_len),
                "seq_mask": _mask(rng, b, cfg.seq_len, left=True),
                "pos_ids": ids(cfg.item_vocab, b, cfg.seq_len),
                "neg_ids": ids(cfg.item_vocab, b, cfg.seq_len)}
    labels = rng.integers(0, 2, b).astype(np.float32)
    if name == "XDeepFMConfig":
        return {"field_ids": ids(cfg.vocab, b, cfg.n_fields), "labels": labels}
    return {"target_ids": ids(cfg.item_vocab, b),
            "hist_ids": ids(cfg.item_vocab, b, cfg.seq_len),
            "hist_mask": _mask(rng, b, cfg.seq_len), "labels": labels}


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    jmod = ARCHS[arch][0]
    cfg = jmod.REDUCED
    return jmod.get_def().family._model(cfg).init(jax.random.PRNGKey(7), cfg)


def _jloss(arch):
    jmod = ARCHS[arch][0]
    model = jmod.get_def().family._model(jmod.REDUCED)
    return lambda p, b: model.loss(p, jmod.REDUCED, b)


def _tparams(arch):
    return params_from_jax(jax.tree.map(np.asarray, _jparams(arch)), ARCHS[arch][1].REDUCED,
                           device="cpu")


def _loss_fn(cfg, executor):
    """``recsys_loss_fn(cfg)`` (the reference executor on the CPU), or for
    "kernel" its loss with the executor set on the CPU model after it is
    built (its bags then run the Function's plain versions;
    ``from_params`` refuses the kernel executor off the card)."""
    if executor == "reference":
        return recsys_loss_fn(cfg)
    cache = {}

    def fn(params, batch):
        if cache.get("params") is not params:
            model = RECSYS_MODELS[type(cfg)].from_params(cfg, params, trainable=True)
            model.executor = executor
            cache.update(params=params, model=model)
        return cache["model"].loss(batch)

    return fn


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,executor", EXECUTORS)
def test_losses_match_jax(arch, executor):
    cfg = ARCHS[arch][1].REDUCED
    batch = _train_batch(cfg, seed=list(ARCHS).index(arch))
    with jax.default_matmul_precision("highest"):
        jl, jm = jax.jit(_jloss(arch))(_jparams(arch), _j(batch))
    model = RECSYS_MODELS[type(cfg)].from_params(cfg, _tparams(arch), trainable=True)
    model.executor = executor  # "kernel" on CPU tensors: the bags' plain versions
    loss, metrics = model.loss(_t(batch))
    assert loss.requires_grad and set(metrics) == set(jm)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-5)
    with torch.no_grad():
        assert float(model.loss(_t(batch))[0]) == float(loss.detach())
    assert not any(LAUNCHES.values())


@pytest.mark.parametrize("arch,executor", EXECUTORS)
def test_step_one_gradients_match_jax(arch, executor):
    """Every parameter's gradient within 1e-5 of the JAX gradient's norm."""
    cfg = ARCHS[arch][1].REDUCED
    batch = _train_batch(cfg, seed=10 + list(ARCHS).index(arch))
    with jax.default_matmul_precision("highest"):
        jgrad = jax.jit(jax.grad(lambda p, b: _jloss(arch)(p, b)[0]))(_jparams(arch), _j(batch))
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg, device="cpu")
    params = TrainState.create(_tparams(arch)).params
    loss, _ = _loss_fn(cfg, executor)(params, _t(batch))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[k].shape, k
        assert float((g - want[k]).norm()) <= 1e-5 * float(want[k].norm()), k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_table_gradients_are_dense_and_only_on_named_rows(arch):
    """The kernel executor's table gradients equal the reference
    executor's within 1e-5 of the norm and are non-zero only on rows whose
    ids the batch names."""
    cfg = ARCHS[arch][1].REDUCED
    batch = _t(_train_batch(cfg, seed=20 + list(ARCHS).index(arch)))
    grads = {}
    for executor in ("reference", "kernel"):
        params = TrainState.create(_tparams(arch)).params
        loss, _ = _loss_fn(cfg, executor)(params, batch)
        grads[executor] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    named = {
        "two_tower": {"user_table": ["user_ids"], "item_table": ["item_ids"]},
        "sasrec": {"item_table": ["seq_ids", "pos_ids", "neg_ids"]},
        "din": {"table": ["target_ids", "hist_ids"]},
        "xdeepfm": {"table": ["field_ids"], "linear": ["field_ids"]},
    }[arch]
    for table, keys in named.items():
        g = grads["kernel"][table]
        assert g.shape == grads["reference"][table].shape  # dense [V, D]
        rows = torch.zeros(g.shape[0], dtype=torch.bool)
        for key in keys:
            rows[batch[key].long().reshape(-1)] = True
        assert not bool(g[~rows].any()), table
        assert bool(g[rows].any(dim=-1).any()), table
    for k, g in grads["kernel"].items():
        want = grads["reference"][k]
        assert float((g - want).norm()) <= 1e-5 * float(want.norm()), k


def _jax_steps(arch, opt, steps):
    jmod = ARCHS[arch][0]
    if opt == "family":
        step = jmod.get_def().family.step_fn(jmod.get_def(), "train_batch", reduced=True)
    else:
        step = jloop.make_train_step(_jloss(arch), jopt.AdamWConfig(**WARM))
    step = jax.jit(step)
    state = jloop.TrainState.create(_jparams(arch))
    metrics = []
    with jax.default_matmul_precision("highest"):
        for i in range(steps):
            state, m = step(state, _j(_train_batch(jmod.REDUCED, seed=100 + i)))
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, state.params), metrics


@pytest.mark.parametrize("opt", ["family", "warm"])
@pytest.mark.parametrize("arch,executor", EXECUTORS)
def test_three_train_steps_match_jax(arch, executor, opt):
    """``RecsysFamily.step_fn`` (AdamW defaults: 100 warmup steps) against
    JAX's; and ``make_train_step`` over ``recsys_loss_fn`` at lr 3e-4 from
    the first step against JAX's ``make_train_step``."""
    tmod = ARCHS[arch][1]
    cfg = tmod.REDUCED
    jfinal, jmetrics = _jax_steps(arch, opt, 3)
    if opt == "family" and executor == "reference":
        step = RecsysFamily.step_fn(tmod.get_def(), "train_batch", reduced=True)
    else:
        warm = WARM if opt == "warm" else {}
        step = make_train_step(_loss_fn(cfg, executor), AdamWConfig(**warm))
    state = TrainState.create(_tparams(arch))
    for i, want in enumerate(jmetrics):
        state, m = step(state, _t(_train_batch(cfg, seed=100 + i)))
        assert set(m) == set(want)
        for k in want:
            np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_jax(jfinal, cfg, device="cpu")
    assert list(state.params) == list(want)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), **TRAINED, err_msg=k)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_losses_match_jax(arch):
    jmod, tmod = ARCHS[arch]
    key = jax.random.PRNGKey(4)
    with jax.default_matmul_precision("highest"):
        want = float(jmod.get_def().family.smoke(jmod.get_def(), "train_batch", key)["loss"])
    jparams = jmod.get_def().family._model(jmod.REDUCED).init(key, jmod.REDUCED)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), tmod.REDUCED, device="cpu")
    got = RecsysFamily.smoke(tmod.get_def(), "train_batch", device="cpu", params=params)["loss"]
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("shape", list(RECSYS_SHAPES_REDUCED))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_jax(arch, shape):
    jmod, tmod = ARCHS[arch]
    jspecs = jmod.get_def().family.input_specs(jmod.get_def(), shape, reduced=True)
    specs = RecsysFamily.input_specs(tmod.get_def(), shape, reduced=True)
    assert list(specs) == list(jspecs)
    for k, (dims, dtype) in specs.items():
        assert dims == jspecs[k].shape, k
        assert str(dtype).split(".")[-1] == str(jspecs[k].dtype), k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ids_outside_the_vocabulary_give_nan_as_in_jax(arch):
    """The reference executor gathers with ``jnp.take``'s fill: an id in
    [-V, 0) wraps, one outside [-V, V) gives NaN, in JAX and the port."""
    cfg = ARCHS[arch][1].REDUCED
    batch = _train_batch(cfg, seed=30)
    key = {"two_tower": "user_ids", "sasrec": "pos_ids", "din": "target_ids",
           "xdeepfm": "field_ids"}[arch]
    vocab = getattr(cfg, {"two_tower": "user_vocab", "sasrec": "item_vocab",
                          "din": "item_vocab", "xdeepfm": "vocab"}[arch])
    model = RECSYS_MODELS[type(cfg)].from_params(cfg, _tparams(arch), trainable=True)
    for bad, is_nan in ((-1, False), (-vocab, False), (vocab, True), (-vocab - 1, True)):
        b = {k: v.copy() for k, v in batch.items()}
        b[key].reshape(-1)[0] = bad
        with jax.default_matmul_precision("highest"):
            jl = float(jax.jit(_jloss(arch))(_jparams(arch), _j(b))[0])
        got = float(model.loss(_t(b))[0].detach())
        assert np.isnan(jl) == np.isnan(got) == is_nan, (bad, jl, got)
        if not is_nan:
            np.testing.assert_allclose(got, jl, rtol=1e-5)


# ---------------------------------------------------------------------------
# the embedding bag's autograd Function on CPU tensors
# ---------------------------------------------------------------------------


def _bag_case(seed, d, idx_dtype, s=9, l=6, v=25):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    idx = rng.integers(-4, v + 4, (s, l))  # ~25% outside [0, V)
    idx[0, :4] = idx[0, 0] if 0 <= idx[0, 0] < v else 3  # duplicates within a bag
    idx[1, :] = 5  # one row named by a whole bag
    w = rng.random((s, l)).astype(np.float32)
    w[rng.random((s, l)) < 0.2] = 0.0
    g = rng.standard_normal((s, d)).astype(np.float32)
    return (torch.from_numpy(table), torch.from_numpy(idx).to(idx_dtype), torch.from_numpy(w),
            torch.from_numpy(g))


@pytest.mark.parametrize("weights_grad", [False, True])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("d", [1, 8, 130])
def test_bag_function_matches_autograd_through_take(d, idx_dtype, weights_grad):
    """The Function's forward and plain backward against autograd through
    ``ref.take`` + sum over the ids in [0, V) (an id outside adds 0 and
    takes a zero weight gradient, as the TPU kernel drops it)."""
    table, idx, w, g = _bag_case(d + weights_grad, d, idx_dtype)
    valid = (idx >= 0) & (idx < table.shape[0])
    t1 = table.clone().requires_grad_(True)
    w1 = w.clone().requires_grad_(weights_grad)
    out = embedding_bag(t1, idx, w1)
    inputs = (t1, w1) if weights_grad else (t1,)
    got = torch.autograd.grad(out, inputs, g)
    t2 = table.clone().requires_grad_(True)
    w2 = w.clone().requires_grad_(weights_grad)
    rows = ref.take(t2, torch.where(valid, idx, 0))
    want_out = torch.sum(rows * (w2 * valid).unsqueeze(-1), dim=1)
    want = torch.autograd.grad(want_out, (t2, w2) if weights_grad else (t2,), g)
    limit_t, limit_w = ref.embedding_bag_backward_error_bound(table, idx, w, g)
    np.testing.assert_allclose(out.detach().numpy(), want_out.detach().numpy(), rtol=1e-6, atol=1e-6)
    assert got[0].shape == table.shape and got[0].dtype == torch.float32
    assert bool(((got[0] - want[0]).abs() <= limit_t).all())
    assert not bool(got[0][~torch.isin(torch.arange(table.shape[0]), idx[valid].long())].any())
    if weights_grad:
        dw = got[1]
        assert bool(((dw - want[1] * valid).abs() <= limit_w).all())
        assert not bool(dw[~valid].any())
        assert bool(dw[valid & (w == 0)].any())  # a zero weight still takes a gradient
    plain = ref.embedding_bag_bags_backward(table, idx, w, g, weights_grad=weights_grad)
    assert torch.equal(plain[0], got[0]) and (plain[1] is None) == (not weights_grad)


def test_bag_function_gradients_through_ops_and_both_flags():
    from repro_torch.kernels import ops

    table, idx, w, g = _bag_case(3, 4, torch.int64)
    t = table.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    out = ops.embedding_bag(t, bag_indices=idx, bag_weights=wr, use_kernel=True)
    (dw,) = torch.autograd.grad(out, (wr,), g, retain_graph=True)  # the weights only
    (dt,) = torch.autograd.grad(out, (t,), g)
    want_t, want_w = ref.embedding_bag_bags_backward(table, idx, w, g, weights_grad=True)
    assert torch.equal(dt, want_t) and torch.equal(dw, want_w)
    assert ref.embedding_bag_bags_backward(table, idx, w, g, table_grad=False) == (None, None)
    with torch.inference_mode():
        assert torch.equal(ops.embedding_bag(table, bag_indices=idx, bag_weights=w, use_kernel=True),
                           ref.embedding_bag_bags(table, idx, w))
    assert not any(LAUNCHES.values())


def test_bag_sort_groups_each_row_in_position_order():
    idx = torch.tensor([[3, -1, 3], [7, 3, 2]], dtype=torch.int32)
    key, pos = ref.bag_sort(idx, 7)
    assert key.tolist() == [2, 3, 3, 3, 7, 7] and pos.tolist() == [5, 0, 2, 4, 1, 3]
