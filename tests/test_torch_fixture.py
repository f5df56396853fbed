"""The committed cross-package fixture (``tests/data/torch_fixture``,
written by ``scripts/make_torch_fixture.py``): the JAX package still
reproduces ``expected.json``, and the port matches it on the CPU.
``chip_smoke.py`` matches the same file on the GPU."""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import Retriever as JaxRetriever
from repro.core import WarpSearchConfig as JaxConfig
from repro_torch.core import Retriever, WarpSearchConfig

torch.set_num_threads(1)  # xdist runs one test process per core

FDIR = os.path.join(os.path.dirname(__file__), "data", "torch_fixture")
with open(os.path.join(FDIR, "expected.json")) as _f:
    EXPECTED = json.load(_f)
CASES = [c["name"] for c in EXPECTED["cases"]]


@pytest.fixture(scope="module")
def queries():
    z = np.load(os.path.join(FDIR, "queries.npz"))
    return z["q"], z["qmask"]


def _case(name):
    return next(c for c in EXPECTED["cases"] if c["name"] == name)


def _check(ids, scores, case):
    np.testing.assert_array_equal(ids, np.asarray(case["doc_ids"]))
    np.testing.assert_allclose(scores, np.asarray(case["scores"]), rtol=1e-4, atol=1e-4)


def test_fixture_is_small_and_complete():
    total = sum(
        os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FDIR) for n in ns
    )
    assert total < 1 << 20
    assert CASES == ["materialize_dense", "fused_dense", "fused_ragged"]


@pytest.mark.parametrize("name", CASES)
def test_jax_reproduces_expected(queries, name):
    case = _case(name)
    r = JaxRetriever.from_store(os.path.join(FDIR, "store"))
    res = r.plan(JaxConfig(**case["config"], executor="reference")).retrieve_batch(*queries)
    _check(np.asarray(res.doc_ids), np.asarray(res.scores), case)


@pytest.mark.parametrize("name", CASES)
def test_port_matches_expected_on_cpu(queries, name):
    case = _case(name)
    r = Retriever.from_store(os.path.join(FDIR, "store"), device="cpu")
    plan = r.plan(WarpSearchConfig(**case["config"]))
    res = plan.retrieve_batch(*queries)
    _check(res.doc_ids.numpy(), res.scores.numpy(), case)
    for i in range(len(queries[0])):
        one = plan.retrieve(queries[0][i], queries[1][i])
        _check(one.doc_ids.numpy()[None], one.scores.numpy()[None], {
            "doc_ids": case["doc_ids"][i:i + 1], "scores": case["scores"][i:i + 1],
        })
