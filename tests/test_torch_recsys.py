"""Port parity of the recsys serving path on the CPU: ``repro_torch.models.
recsys`` against the JAX package's ``RecsysFamily.step_fn`` for the four
recsys models at their ``REDUCED`` configs and the ``serve_p99``,
``serve_bulk`` and ``retrieval_cand`` shapes, with the JAX ``init`` weights
carried across by ``params_from_jax`` and the batches made with numpy from
a seed. float32 matmuls at "highest" in both packages.

Tolerances (rtol = atol): 1e-5 for two-tower outputs and SASRec scores
(L2-normalised embeddings and dot products of a few dozen float32 terms,
summed in another order); 1e-4 for DIN and xDeepFM logits (sums over an
attention MLP and CIN products of hundreds of terms).

On the CPU the models run the reference executor (JAX's code). The kernel
executor's arithmetic, the bag sums through ``ops.embedding_bag(...,
use_kernel=True)``, is held here too: a CPU model whose resolved executor
is set to "kernel" routes those bags to the kernel wrapper, which runs its
plain version on a CPU tensor (the card holds the CUDA kernel to that).
"""

import dataclasses
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
from repro.configs.families import RECSYS_SHAPES_REDUCED as J_SHAPES
from repro.models import recsys as jrecsys
from repro_torch.configs import RECSYS_SHAPES, RECSYS_SHAPES_REDUCED
from repro_torch.configs import din, sasrec, two_tower_retrieval, xdeepfm
from repro_torch.kernels import LAUNCHES
from repro_torch.models import init_params, params_from_jax, serve_step
from repro_torch.models.recsys import RECSYS_MODELS

torch.set_num_threads(1)  # xdist runs one test process per core
torch.set_float32_matmul_precision("highest")

ARCHS = {
    "two_tower": (jtt, two_tower_retrieval, 1e-5),
    "sasrec": (jsasrec, sasrec, 1e-5),
    "din": (jdin, din, 1e-4),
    "xdeepfm": (jxdeepfm, xdeepfm, 1e-4),
}
SHAPES = ("serve_p99", "serve_bulk", "retrieval_cand")
BAG_ARCHS = ("two_tower", "din", "xdeepfm")  # the models with a bag sum


def _mask(rng, rows, width, *, left=False):
    """f32 [rows, width] with 1..width valid slots per row (a suffix when
    ``left``, else a prefix)."""
    n = rng.integers(1, width + 1, (rows, 1))
    pos = np.arange(width)
    valid = pos >= width - n if left else pos < n
    return valid.astype(np.float32)


def _batch(cfg, shape, seed):
    """The batch of ``RecsysFamily.input_specs`` for ``cfg`` at ``shape``,
    ids drawn uniformly from the vocabulary (as hashed ids are)."""
    rng = np.random.default_rng(seed)
    b, nc, retrieval = shape.batch, shape.n_candidates, shape.kind == "retrieval"

    def ids(vocab, *dims):
        return rng.integers(0, vocab, dims).astype(np.int32)

    name = type(cfg).__name__
    if name == "TwoTowerConfig":
        out = {"user_ids": ids(cfg.user_vocab, b, cfg.user_fields),
               "user_mask": _mask(rng, b, cfg.user_fields)}
        if retrieval:
            emb = rng.standard_normal((nc, cfg.tower_mlp[-1])).astype(np.float32)
            out["cand_emb"] = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
        else:
            out["item_ids"] = ids(cfg.item_vocab, b, cfg.item_fields)
            out["item_mask"] = _mask(rng, b, cfg.item_fields)
        return out
    if name == "SASRecConfig":
        out = {"seq_ids": ids(cfg.item_vocab, b, cfg.seq_len),
               "seq_mask": _mask(rng, b, cfg.seq_len, left=True)}
        out["cand_ids" if retrieval else "target_ids"] = ids(cfg.item_vocab, nc if retrieval else b)
        return out
    if name == "XDeepFMConfig":
        return {"field_ids": ids(cfg.vocab, nc if retrieval else b, cfg.n_fields)}
    rows = 1 if retrieval else b
    return {"target_ids": ids(cfg.item_vocab, nc if retrieval else b),
            "hist_ids": ids(cfg.item_vocab, rows, cfg.seq_len),
            "hist_mask": _mask(rng, rows, cfg.seq_len)}


@functools.lru_cache(maxsize=None)
def _params(arch):
    jmod, tmod, _ = ARCHS[arch]
    cfg = jmod.REDUCED
    jparams = jmod.get_def().family._model(cfg).init(jax.random.PRNGKey(3), cfg)
    return jparams, jax.tree.map(np.asarray, jparams)


def _port_model(arch, executor="reference"):
    _, tmod, _ = ARCHS[arch]
    cfg = tmod.REDUCED
    params = params_from_jax(_params(arch)[1], cfg, device="cpu")
    return RECSYS_MODELS[type(cfg)].from_params(cfg, params, executor=executor)


def _run_both(arch, shape, model):
    jmod, _, _ = ARCHS[arch]
    seed = 10 * list(ARCHS).index(arch) + SHAPES.index(shape)
    batch = _batch(jmod.REDUCED, J_SHAPES[shape], seed=seed)
    with jax.default_matmul_precision("highest"):
        step = jax.jit(jmod.get_def().family.step_fn(jmod.get_def(), shape, reduced=True))
        want = np.asarray(step(_params(arch)[0], {k: jnp.asarray(v) for k, v in batch.items()}))
    got = serve_step(model, RECSYS_SHAPES_REDUCED[shape])(
        {k: torch.from_numpy(v) for k, v in batch.items()}
    )
    return got, want


def test_configs_and_shapes_are_the_jax_ones():
    for jmod, tmod, _ in ARCHS.values():
        assert dataclasses.asdict(tmod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
        assert dataclasses.asdict(tmod.REDUCED) == dataclasses.asdict(jmod.REDUCED)
        assert tmod.SOURCE == jmod.get_def().source
    from repro.configs.families import RECSYS_SHAPES as J_FULL

    for mine, theirs in ((RECSYS_SHAPES, J_FULL), (RECSYS_SHAPES_REDUCED, J_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == {
            k: dataclasses.asdict(v) for k, v in theirs.items()
        }


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_step_matches_jax(arch, shape):
    got, want = _run_both(arch, shape, _port_model(arch))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    tol = ARCHS[arch][2]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", BAG_ARCHS)
def test_kernel_executor_bags_match_jax(arch, shape):
    model = _port_model(arch)
    model.executor = "kernel"  # the resolved kernel route, on CPU tensors
    got, want = _run_both(arch, shape, model)
    tol = ARCHS[arch][2]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    assert not any(LAUNCHES.values())  # the CPU runs the plain version


def test_two_tower_embeddings_match_jax():
    jparams = _params("two_tower")[0]
    cfg = jtt.REDUCED
    batch = _batch(cfg, J_SHAPES["serve_p99"], seed=11)
    model = _port_model("two_tower")
    u = model.user_embed(torch.from_numpy(batch["user_ids"]), torch.from_numpy(batch["user_mask"]))
    v = model.item_embed(torch.from_numpy(batch["item_ids"]), torch.from_numpy(batch["item_mask"]))
    ju = jrecsys.TwoTower.user_embed(jparams, cfg, batch["user_ids"], batch["user_mask"])
    jv = jrecsys.TwoTower.item_embed(jparams, cfg, batch["item_ids"], batch["item_mask"])
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(u.numpy(), axis=-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_from_jax_fills_every_parameter(arch):
    model = _port_model(arch)
    tree = _params(arch)[1]
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_has_jax_init_layout_and_scales(arch):
    _, tmod, _ = ARCHS[arch]
    cfg = tmod.REDUCED
    g = torch.Generator().manual_seed(5)
    mine = init_params(cfg, g, device="cpu")
    theirs = params_from_jax(_params(arch)[1], cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {
        k: tuple(v.shape) for k, v in theirs.items()
    }
    for k, v in mine.items():
        ref = theirs[k]
        if ref.numel() == 1 or float(ref.std()) == 0:  # biases, scales: constants
            np.testing.assert_array_equal(v.numpy(), ref.numpy())
        elif ref.numel() >= 256:  # the same normal distribution: stds within 15%
            assert abs(float(v.std()) / float(ref.std()) - 1) < 0.15, k
        else:
            assert float(v.std()) > 0, k


def test_executor_rules_on_the_cpu():
    cfg = two_tower_retrieval.REDUCED
    params = init_params(cfg, device="cpu")
    model_cls = RECSYS_MODELS[type(cfg)]
    with pytest.raises(ValueError, match="executor='kernel'"):
        model_cls.from_params(cfg, params, executor="kernel")
    with pytest.raises(ValueError, match="executor="):
        model_cls.from_params(cfg, params, executor="fast")
    for executor in ("auto", "reference"):
        assert model_cls.from_params(cfg, params, executor=executor).executor == "reference"


def test_serve_step_train_shape_is_not_ported():
    """``serve_step`` still serves only: a train shape is refused with the
    name of the step that trains it, ``RecsysFamily.step_fn``, and that
    step trains DIN's weights."""
    from repro_torch.configs.families import RecsysFamily
    from repro_torch.train import TrainState

    with pytest.raises(ValueError, match="RecsysFamily.step_fn"):
        serve_step(_port_model("din"), RECSYS_SHAPES_REDUCED["train_batch"])
    cfg = din.REDUCED
    params = params_from_jax(_params("din")[1], cfg, device="cpu")
    state = TrainState.create({k: v.clone() for k, v in params.items()})
    rng = np.random.default_rng(8)
    batch = _batch(cfg, RECSYS_SHAPES_REDUCED["train_batch"], seed=8)
    batch["labels"] = rng.integers(0, 2, len(batch["target_ids"])).astype(np.float32)
    step = RecsysFamily.step_fn(din.get_def(), "train_batch", reduced=True)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert np.isfinite(float(metrics["loss"])) and int(state.opt["step"]) == 1
    assert all(not torch.equal(state.params[k], params[k]) for k in params)
