"""Port parity of the whole slice: ``repro_torch`` ``Retriever.plan(...)``
``.retrieve`` / ``retrieve_batch`` against the JAX ``Retriever`` at
``executor="reference"`` on the ``nfcorpus_like`` and ``zipf_like`` tiers
(``benchmarks/common.py::SETUPS``), over layout {dense, ragged} x gather
{materialize, fused} x memory {full, scan_qtokens}. Doc ids identical,
scores within rtol = atol = 1e-4, resolved plan fields equal.

The JAX side runs one batch per tier and layout and one WARP_SELECT per
tier (its own tests hold its gather and memory variants, and single vs
batched retrieval, to identical doc ids); every port variant, single and
batched, is held against it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import get_setup
from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro.core import engine as jax_engine
from repro_torch.core import Retriever, WarpSearchConfig, search, search_batch

torch.set_num_threads(1)  # xdist runs one test process per core

N_Q = 4
SEARCH = dict(nprobe=8, k=10)
VARIANTS = [
    (layout, gather, memory)
    for layout in ("dense", "ragged")
    for gather in ("materialize", "fused")
    for memory in ("full", "scan_qtokens")
]
RESOLVED = (
    "t_prime", "k_impute", "layout", "tile_c", "tile_source", "buffering",
    "worklist_tiles", "worklist_buckets", "executor", "nprobe", "k",
)


def _np(res):
    return np.asarray(res.doc_ids), np.asarray(res.scores)


@pytest.fixture(scope="module", params=["nfcorpus_like", "zipf_like"])
def tier(request):
    _, index, q, qmask, _ = get_setup(request.param)
    q, qmask = np.asarray(q)[:N_Q], np.asarray(qmask)[:N_Q]
    # Vary the active length so masked tokens and rungs differ per query.
    qmask = qmask.copy()
    qmask[1, 3:] = False
    qmask[2, 1:] = False
    q = q * qmask[..., None]
    jr = JaxRetriever.from_index(index)
    want, rungs = {}, {}
    for layout in ("dense", "ragged"):
        plan = jr.plan(JaxConfig(executor="reference", layout=layout, **SEARCH))
        want[layout] = _np(plan.retrieve_batch(q, qmask))
    # The JAX adaptive rung of each query, from one batched WARP_SELECT
    # through the JAX plan's own picker (per-query slices).
    cfg = jr.plan(JaxConfig(executor="reference", layout="ragged", **SEARCH)).config
    sel = jax_engine.select_probes(index, q, qmask, cfg, True)
    for memory in ("full", "scan_qtokens"):
        pick = jr._local_sel_picker(dataclasses.replace(cfg, memory=memory))
        rungs[memory] = [
            pick(jax.tree_util.tree_map(lambda a, i=i: a[i], sel), qmask[i])
            for i in range(N_Q)
        ]
    return dict(
        name=request.param, index=index, q=q, qmask=qmask, jr=jr,
        port=Retriever.from_index(index, device="cpu"), want=want, rungs=rungs,
    )


def _assert_same(got, want):
    ids, scores = got
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout,gather,memory", VARIANTS)
def test_slice_matches_jax(tier, layout, gather, memory):
    kw = dict(layout=layout, gather=gather, memory=memory, **SEARCH)
    jplan = tier["jr"].plan(JaxConfig(executor="reference", **kw))
    plan = tier["port"].plan(WarpSearchConfig(**kw))
    for f in RESOLVED:
        assert getattr(plan.config, f) == getattr(jplan.config, f), f
    jd, td = jplan.describe(), plan.describe()
    for d in (jd, td):
        d.pop("fingerprint")
    assert td == jd

    ids, scores = tier["want"][layout]
    got = plan.retrieve_batch(tier["q"], tier["qmask"])
    for i in range(N_Q):
        _assert_same((got.doc_ids[i].numpy(), got.scores[i].numpy()), (ids[i], scores[i]))
    for i in range(2):
        _assert_same(_np(plan.retrieve(tier["q"][i], tier["qmask"][i])), (ids[i], scores[i]))
    rungs = [plan.adaptive_bucket(tier["q"][i], tier["qmask"][i]) for i in range(N_Q)]
    assert rungs == (tier["rungs"][memory] if layout == "ragged" else [None] * N_Q)


def test_forced_rungs_give_the_same_doc_ids(tier):
    plan = tier["port"].plan(WarpSearchConfig(layout="ragged", gather="fused", **SEARCH))
    need = max(plan.adaptive_bucket(tier["q"][i], tier["qmask"][i]) for i in range(N_Q))
    base = plan.retrieve_batch(tier["q"], tier["qmask"])
    for rung in plan.config.worklist_buckets:
        if rung < need:
            continue
        got = plan.retrieve_batch_at(tier["q"], tier["qmask"], bucket=rung)
        assert torch.equal(got.doc_ids, base.doc_ids)
        torch.testing.assert_close(got.scores, base.scores, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="not a rung"):
        plan.retrieve_batch_at(tier["q"], tier["qmask"], bucket=3)


def test_layout_auto_resolves_like_jax(tier):
    kw = dict(layout="auto", **SEARCH)
    jcfg = tier["jr"].plan(JaxConfig(executor="reference", **kw)).config
    cfg = tier["port"].plan(WarpSearchConfig(**kw)).config
    assert cfg.layout in ("dense", "ragged")
    for f in RESOLVED:
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_engine_search_wrappers_match_jax(tier):
    """``search`` / ``search_batch`` run at the static worklist bound (no
    adaptive rung) and give the JAX reference's doc ids."""
    q, qmask = tier["q"], tier["qmask"]
    ids, scores = tier["want"]["ragged"]
    cfg = WarpSearchConfig(layout="ragged", gather="fused", **SEARCH)
    port_idx = tier["port"].index
    _assert_same(_np(search(port_idx, q[0], qmask[0], cfg)), (ids[0], scores[0]))
    got = search_batch(port_idx, q, qmask, cfg)
    _assert_same((got.doc_ids.numpy(), got.scores.numpy()), (ids, scores))


@pytest.mark.parametrize("sum_impl", ["gather", "lut"])
def test_sum_impl_lut_gives_the_same_doc_ids(tier, sum_impl):
    for layout in ("dense", "ragged"):
        plan = tier["port"].plan(WarpSearchConfig(layout=layout, sum_impl=sum_impl, **SEARCH))
        got = plan.retrieve_batch(tier["q"], tier["qmask"])
        np.testing.assert_array_equal(got.doc_ids.numpy(), tier["want"][layout][0])


def test_plan_errors_match_jax(tier):
    port, jr = tier["port"], tier["jr"]
    n_c = tier["index"].n_centroids
    for bad in (dict(nprobe=n_c + 1), dict(k=10**7), dict(t_prime=0), dict(k=0)):
        with pytest.raises(ValueError, match="unsatisfiable"):
            jr.plan(JaxConfig(executor="reference", **bad))
        with pytest.raises(ValueError, match="unsatisfiable"):
            port.plan(WarpSearchConfig(**bad))
    for bad in (dict(tile_c=12), dict(layout="sideways"), dict(executor="tpu")):
        with pytest.raises(ValueError):
            WarpSearchConfig(**bad)


def test_empty_index_is_refused_at_plan_time(tier):
    idx = tier["port"].index
    empty = dataclasses.replace(idx, n_tokens=0)
    with pytest.raises(ValueError, match="n_tokens == 0"):
        Retriever(empty).plan(WarpSearchConfig())


def test_plans_are_cached_per_config(tier):
    port = Retriever(tier["port"].index)
    cfg = WarpSearchConfig(layout="ragged", **SEARCH)
    plan = port.plan(cfg)
    assert port.plan(cfg) is plan
    assert port.plan(plan.config) is plan
    assert plan.fingerprint() == plan.describe()["fingerprint"]
