"""The port's ``RetrievalServer``: every reply equals ``plan.retrieve`` of
the same query, on bucket-aware (adaptive ragged) and single-queue plans,
plus the request lifecycle. CPU, ``device="cpu"``."""

import numpy as np
import pytest
import torch

from benchmarks.common import get_setup, make_query_stream
from repro_torch.core import Retriever, WarpSearchConfig
from repro_torch.serving import (
    PENDING,
    BatchPolicy,
    BucketScheduler,
    ResultAlreadyTaken,
    RetrievalServer,
)

torch.set_num_threads(1)  # xdist runs one test process per core

SEARCH = dict(nprobe=8, k=10)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def setup():
    _, index, *_ = get_setup("nfcorpus_like")
    q, qmask, _ = make_query_stream("nfcorpus_like", 14, seed=3)
    return Retriever.from_index(index, device="cpu"), np.asarray(q), np.asarray(qmask)


@pytest.mark.parametrize(
    "layout,gather,bucket_aware",
    [("ragged", "fused", True), ("ragged", "materialize", True),
     ("ragged", "fused", False), ("dense", "fused", True)],
)
def test_replies_equal_plan_retrieve(setup, layout, gather, bucket_aware):
    retriever, q, qmask = setup
    clock = FakeClock()
    server = RetrievalServer(
        retriever, WarpSearchConfig(layout=layout, gather=gather, **SEARCH),
        BatchPolicy(max_batch=4, max_wait_s=0.01, promote_after_s=0.03), clock,
        bucket_aware=bucket_aware,
    )
    rids = []
    for i in range(len(q)):
        rids.append(server.submit(q[i], qmask[i]))
        clock.t += 0.004
        server.step()
    server.drain()
    for i, rid in enumerate(rids):
        scores, ids = server.poll(rid)
        want = server.plan.retrieve(q[i], qmask[i])
        np.testing.assert_array_equal(ids, want.doc_ids.numpy())
        np.testing.assert_allclose(scores, want.scores.numpy(), rtol=1e-5, atol=1e-5)
    s = server.summary()
    assert s["served"] == len(q) and s["queue_depth"] == 0
    if layout == "ragged" and bucket_aware:
        assert server.scheduler.rungs == server.config.worklist_buckets
        # Repeats of a query are answered from the result cache at submit.
        assert sum(r["requests"] for r in s["rungs"].values()) + s["cache_hits"] == len(q)
    else:
        assert list(s["rungs"]) == ["none"]


def test_request_lifecycle(setup):
    retriever, q, qmask = setup
    clock = FakeClock()
    server = RetrievalServer(
        retriever, WarpSearchConfig(layout="ragged", gather="fused", **SEARCH),
        BatchPolicy(max_batch=8, max_wait_s=1.0), clock,
    )
    rid = server.submit(q[0], qmask[0])
    assert server.poll(rid) is PENDING
    assert server.step() == 0  # under-full and before its deadline
    scores, ids = server.result(rid)
    assert ids.shape == (SEARCH["k"],)
    with pytest.raises(ResultAlreadyTaken):
        server.poll(rid)
    with pytest.raises(KeyError):
        server.poll(999)


def test_scheduler_backfills_and_promotes():
    clock = FakeClock()
    sched = BucketScheduler(
        BatchPolicy(max_batch=3, max_wait_s=0.01, promote_after_s=0.05), clock,
        rungs=(8, 16, 32),
    )

    class Item:
        def __init__(self, t):
            self.arrival = t

    for rung in (8, 8, 32):
        sched.push(Item(clock.t), rung)
    assert sched.next_batch() is None
    clock.t = 0.02
    rung, items = sched.next_batch()
    assert rung == 8 and len(items) == 2  # oldest head first
    rung, items = sched.next_batch()
    assert rung == 32 and len(items) == 1
    sched.push(Item(clock.t), 8)
    clock.t = 0.08  # past promote_after_s: one rung up per pass
    sched._promote(clock.t)
    assert sched.stats["promoted"] == 1 and len(sched._queues[(None, 16)]) == 1
    with pytest.raises(ValueError, match="not in ladder"):
        sched.push(Item(0.0), 12)
