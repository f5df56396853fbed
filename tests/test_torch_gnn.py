"""Port parity of the GNN family on the CPU: ``repro_torch.models.gnn``
(GIN, the segment sum, ``neighbor_sample``), ``configs/gin_tu.py`` and
``GNNFamily`` against the JAX package, at the ``REDUCED`` config and the
four ``GNN_SHAPES_REDUCED`` shapes, JAX's ``GIN.init`` weights carried
across by ``params_from_jax``, batches made with numpy from a seed.

Tolerances: logits and losses 1e-5 relative (float32 sums in another
order); step-1 gradients per tensor within 1e-5 of the JAX gradient's
norm; three ``GNNFamily.step_fn`` steps, params within 1e-5 relative +
0.1 x lr (as ``tests/test_torch_recsys_train.py``). ``neighbor_sample`` is
bit for bit, and JAX's index semantics are held exactly: a negative
``edge_src`` wraps once, then clamps; ``edge_dst`` and ``graph_ids``
outside [0, n) are dropped; a label >= n_classes gives NaN.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as jgin
from repro.configs.families import GNN_SHAPES as J_SHAPES
from repro.configs.families import GNN_SHAPES_REDUCED as J_REDUCED
from repro.configs.families import GNNFamily as JFamily
from repro.models import gnn as jgnn
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import gin_tu
from repro_torch.configs.families import GNN_SHAPES, GNN_SHAPES_REDUCED, GNNFamily, gnn_loss_fn
from repro_torch.models import gnn, init_params, params_from_jax
from repro_torch.train import AdamWConfig, TrainState, make_train_step

torch.set_num_threads(1)  # xdist runs one test process per core
torch.set_float32_matmul_precision("highest")

SHAPES = list(GNN_SHAPES_REDUCED)
WARM = dict(warmup_steps=1, total_steps=6)
TRAINED = dict(rtol=1e-5, atol=0.1 * 3e-4)


def _batch(shape, seed):
    """The reduced shape's inputs (``GNNFamily.input_specs``): features
    standard normal, edges uniform over the nodes, labels in range, the
    padded minibatch's masks as JAX's smoke sets them."""
    s = GNN_SHAPES_REDUCED[shape]
    rng = np.random.default_rng(seed)
    b = {
        "x": rng.standard_normal((s.n_nodes, s.d_feat)).astype(np.float32),
        "edge_src": rng.integers(0, s.n_nodes, s.n_edges).astype(np.int32),
        "edge_dst": rng.integers(0, s.n_nodes, s.n_edges).astype(np.int32),
        "labels": rng.integers(0, s.n_classes, s.n_graphs or s.n_nodes).astype(np.int32),
    }
    if s.batch_nodes:
        b["edge_mask"] = (rng.random(s.n_edges) < 0.8).astype(np.float32)
        b["label_mask"] = (np.arange(s.n_nodes) < s.batch_nodes).astype(np.float32)
    if s.n_graphs:
        b["graph_ids"] = np.repeat(np.arange(s.n_graphs), s.n_nodes // s.n_graphs).astype(np.int32)
    return b


def _cfgs(shape):
    s = GNN_SHAPES_REDUCED[shape]
    jcfg = JFamily._cfg_for(jgin.get_def(), J_REDUCED[shape], True)
    return jcfg, GNNFamily._cfg_for(gin_tu.get_def(), s, True), s.n_graphs


@functools.lru_cache(maxsize=None)
def _jparams(shape):
    jcfg = _cfgs(shape)[0]
    return jgnn.GIN.init(jax.random.PRNGKey(SHAPES.index(shape)), jcfg)


def _tparams(shape):
    return params_from_jax(jax.tree.map(np.asarray, _jparams(shape)), _cfgs(shape)[1], device="cpu")


def _jloss(shape):
    jcfg, _, n_graphs = _cfgs(shape)
    extra = {"n_graphs": n_graphs} if n_graphs else {}
    return lambda p, b: jgnn.GIN.loss(p, jcfg, {**b, **extra})


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_config_shapes_and_registry_entry_are_the_jax_ones():
    for mine, theirs in ((gin_tu.CONFIG, jgin.CONFIG), (gin_tu.REDUCED, jgin.REDUCED)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for mine, theirs in ((GNN_SHAPES, J_SHAPES), (GNN_SHAPES_REDUCED, J_REDUCED)):
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == {
            k: dataclasses.asdict(v) for k, v in theirs.items()
        }
    a, j = gin_tu.get_def(), jgin.get_def()
    assert (a.name, a.shapes, a.source, a.notes, a.family.name) == (
        j.name, j.shapes, j.source, j.notes, j.family.name)
    for shape in a.shapes:
        assert dataclasses.asdict(a.cell(shape)) == dataclasses.asdict(j.cell(shape))
        for reduced in (False, True):
            spec = GNNFamily.input_specs(a, shape, reduced=reduced)
            jspec = JFamily.input_specs(j, shape, reduced=reduced)
            assert list(spec) == list(jspec)
            for k, (dims, dtype) in spec.items():
                assert dims == jspec[k].shape and str(dtype).split(".")[-1] == str(jspec[k].dtype)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_and_loss_match_jax(shape):
    jcfg, cfg, n_graphs = _cfgs(shape)
    b = _batch(shape, seed=SHAPES.index(shape))
    args = ("x", "edge_src", "edge_dst")
    opt = {k: b.get(k) for k in ("edge_mask", "graph_ids")}
    with jax.default_matmul_precision("highest"):
        want = jgnn.GIN.forward(_jparams(shape), jcfg, *(jnp.asarray(b[k]) for k in args),
                                *(None if v is None else jnp.asarray(v) for v in opt.values()),
                                n_graphs)
        jl, jm = jax.jit(_jloss(shape))(_jparams(shape), _j(b))
    model = gnn.GIN.from_params(cfg, _tparams(shape))
    got = model(*(torch.from_numpy(b[k]) for k in args),
                *(None if v is None else torch.from_numpy(v) for v in opt.values()), n_graphs)
    assert tuple(got.shape) == want.shape == ((n_graphs or b["x"].shape[0]), cfg.n_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    loss, metrics = gnn_loss_fn(cfg, n_graphs)(TrainState.create(_tparams(shape)).params, _t(b))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jm["ce"]), rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_step_one_gradients_match_jax(shape):
    cfg = _cfgs(shape)[1]
    b = _batch(shape, seed=10 + SHAPES.index(shape))
    with jax.default_matmul_precision("highest"):
        jgrad = jax.jit(jax.grad(lambda p, bb: _jloss(shape)(p, bb)[0]))(_jparams(shape), _j(b))
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg, device="cpu")
    params = TrainState.create(_tparams(shape)).params
    loss, _ = gnn_loss_fn(cfg, _cfgs(shape)[2])(params, _t(b))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    assert list(grads) == list(want)
    for k, g in grads.items():
        assert g.shape == want[k].shape, k
        assert float((g - want[k]).norm()) <= 1e-5 * float(want[k].norm()), k


@pytest.mark.parametrize("opt", ["family", "warm"])
@pytest.mark.parametrize("shape", SHAPES)
def test_three_train_steps_match_jax(shape, opt):
    """``GNNFamily.step_fn`` (AdamW defaults) against JAX's, and
    ``make_train_step`` at lr 3e-4 from the first step against JAX's."""
    jcfg, cfg, n_graphs = _cfgs(shape)
    if opt == "family":
        jstep = JFamily.step_fn(jgin.get_def(), shape, reduced=True)
        step = GNNFamily.step_fn(gin_tu.get_def(), shape, reduced=True)
    else:
        jstep = jloop.make_train_step(_jloss(shape), jopt.AdamWConfig(**WARM))
        step = make_train_step(gnn_loss_fn(cfg, n_graphs), AdamWConfig(**WARM))
    jstep = jax.jit(jstep)
    jstate = jloop.TrainState.create(_jparams(shape))
    state = TrainState.create(_tparams(shape))
    for i in range(3):
        b = _batch(shape, seed=100 + i)
        with jax.default_matmul_precision("highest"):
            jstate, jm = jstep(jstate, _j(b))
        state, m = step(state, _t(b))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg, device="cpu")
    assert list(state.params) == list(want)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(), **TRAINED, err_msg=k)


@pytest.mark.parametrize("shape", SHAPES)
def test_smoke_losses_match_jax(shape):
    key = jax.random.PRNGKey(9)
    with jax.default_matmul_precision("highest"):
        want = float(JFamily.smoke(jgin.get_def(), shape, key)["loss"])
    jcfg, cfg, _ = _cfgs(shape)
    params = params_from_jax(jax.tree.map(np.asarray, jgnn.GIN.init(key, jcfg)), cfg, device="cpu")
    got = GNNFamily.smoke(gin_tu.get_def(), shape, device="cpu", params=params)["loss"]
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_init_params_has_jax_init_layout_and_scales():
    cfg = _cfgs("full_graph_sm")[1]
    mine = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    theirs = _tparams("full_graph_sm")
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape) for k, v in theirs.items()}
    for k, v in mine.items():
        if k.endswith(("bias", "eps")):
            assert not bool(v.any()), k
        else:  # normal * 1/sqrt(d_in), d_in the weight's second axis
            assert abs(float(v.std()) * v.shape[1] ** 0.5 - 1) < 0.25, k


# ---------------------------------------------------------------------------
# JAX's index semantics
# ---------------------------------------------------------------------------


def test_gather_wraps_once_then_clamps_as_jax_indexes():
    h = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([-1, -4, -5, -6, -100, 0, 3, 4, 5, 100], np.int32)
    want = np.asarray(jnp.asarray(h)[jnp.asarray(idx)])
    got = gnn.gather_rows(torch.from_numpy(h), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[[0, 3, 7]].tolist() == [h[3].tolist(), h[0].tolist(), h[3].tolist()]


def test_segment_sum_drops_ids_outside_the_segments_as_jax_does():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((40, 3)).astype(np.float32)
    data[5] = np.nan  # a dropped row must not leak
    seg = rng.integers(-3, 9, 40).astype(np.int32)
    seg[5] = 7
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(seg), num_segments=6))
    got = gnn.segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 6).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_out_of_range_edges_and_graph_ids_match_jax(shape):
    """Negative and too-large edge_src (wrapped, clamped), edge_dst and
    graph_ids outside [0, n) (dropped): the loss and its gradients."""
    jcfg, cfg, n_graphs = _cfgs(shape)
    b = _batch(shape, seed=40)
    n, e = b["x"].shape[0], b["edge_src"].shape[0]
    b["edge_src"][: e // 8] = np.array([-1, -n, -n - 3, n, n + 7, -2 * n])[np.arange(e // 8) % 6]
    b["edge_dst"][e // 8: e // 4] = np.array([-1, n, n + 5, -n])[np.arange(e // 8) % 4]
    if n_graphs:
        b["graph_ids"][:3] = [-1, n_graphs, n_graphs + 4]
    with jax.default_matmul_precision("highest"):
        jl, jgrad = jax.jit(jax.value_and_grad(lambda p, bb: _jloss(shape)(p, bb)[0]))(
            _jparams(shape), _j(b))
    params = TrainState.create(_tparams(shape)).params
    loss, _ = gnn_loss_fn(cfg, n_graphs)(params, _t(b))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrad), cfg, device="cpu")
    for k, g in zip(params, torch.autograd.grad(loss, list(params.values()))):
        assert float((g - want[k]).norm()) <= 1e-5 * float(want[k].norm()), k


def test_labels_past_the_classes_give_nan_as_in_jax():
    shape = "full_graph_sm"
    b = _batch(shape, seed=41)
    c = GNN_SHAPES_REDUCED[shape].n_classes
    params = TrainState.create(_tparams(shape)).params
    loss_fn = gnn_loss_fn(_cfgs(shape)[1])
    for labels, is_nan in ((-3, False), (c - 1, False), (c, True), (63, True)):
        bb = {k: v.copy() for k, v in b.items()}
        bb["labels"][0] = labels
        jl = float(jax.jit(_jloss(shape))(_jparams(shape), _j(bb))[0])
        got = float(loss_fn(params, _t(bb))[0].detach())
        assert np.isnan(got) == np.isnan(jl) == is_nan, (labels, got, jl)
        if not is_nan:
            np.testing.assert_allclose(got, jl, rtol=1e-5)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------


def _csr(n, avg_deg, seed):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(avg_deg, n)
    deg[rng.random(n) < 0.05] = 0  # some isolated nodes
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    return indptr, rng.integers(0, n, indptr[-1]).astype(np.int64)


@pytest.mark.parametrize("fanouts", [(3,), (4, 3), (2, 2, 2)])
def test_neighbor_sample_bit_for_bit_with_jax(fanouts):
    indptr, indices = _csr(300, 6, 1)
    seeds = np.random.default_rng(2).choice(300, 16, replace=False)
    want = jgnn.neighbor_sample(np.random.default_rng(5), indptr, indices, seeds, fanouts)
    got = gnn.neighbor_sample(np.random.default_rng(5), indptr, indices, seeds, fanouts)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got[0][:16], seeds)


def test_a_sampled_minibatch_trains_as_in_jax():
    """A ``neighbor_sample`` subgraph padded to the reduced minibatch_lg
    shape (its masks: the padded edges and the seeds' labels) through one
    ``GNNFamily.step_fn`` step of each package."""
    shape = "minibatch_lg"
    s = GNN_SHAPES_REDUCED[shape]
    indptr, indices = _csr(2000, 8, 3)
    rng = np.random.default_rng(4)
    seeds = rng.choice(2000, s.batch_nodes, replace=False)
    nodes, src, dst, emask = gnn.neighbor_sample(np.random.default_rng(6), indptr, indices,
                                                 seeds, (3, 3))
    assert len(nodes) <= s.n_nodes and len(src) <= s.n_edges
    b = {
        "x": np.zeros((s.n_nodes, s.d_feat), np.float32),
        "edge_src": np.zeros(s.n_edges, np.int32), "edge_dst": np.zeros(s.n_edges, np.int32),
        "edge_mask": np.zeros(s.n_edges, np.float32),
        "labels": rng.integers(0, s.n_classes, s.n_nodes).astype(np.int32),
        "label_mask": (np.arange(s.n_nodes) < s.batch_nodes).astype(np.float32),
    }
    b["x"][: len(nodes)] = rng.standard_normal((len(nodes), s.d_feat))
    b["edge_src"][: len(src)], b["edge_dst"][: len(dst)] = src, dst
    b["edge_mask"][: len(emask)] = emask
    with jax.default_matmul_precision("highest"):
        _, jm = jax.jit(JFamily.step_fn(jgin.get_def(), shape, reduced=True))(
            jloop.TrainState.create(_jparams(shape)), _j(b))
    _, m = GNNFamily.step_fn(gin_tu.get_def(), shape, reduced=True)(
        TrainState.create(_tparams(shape)), _t(b))
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
