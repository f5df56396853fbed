"""World bodies of ``tests/test_torch_distributed.py``'s ranked tests.

They run in the ranks that ``repro_torch.launch.ranks.run_world`` spawns,
so this module imports torch, numpy and the port only (a rank never
imports JAX). Rank 0 drives, ranks 1..S-1 follow
(``repro_torch.serving.follow``), and rank 0 writes what it saw to
``.npz`` / ``.json`` files that the test process compares with JAX's.
"""

import json
import os

import numpy as np

from repro_torch import fault
from repro_torch.core import DocFilter, Retriever, WarpSearchConfig
from repro_torch.core.distributed import RankFailure, ShardedSearch
from repro_torch.core.retriever import SearchPlan
from repro_torch.serving import BatchPolicy, RetrievalServer, follow


_TO_DEVICE = ShardedSearch.to_device


class FaultSwitch:
    """A numbered object made on every rank before the follower loop
    starts, so rank 0 can arm a fault on one rank only: a collective call
    ``arm(rank, site)`` installs a plan that fires at every hit of
    ``site`` on that rank, ``break_copy(rank)`` makes that rank's query
    copy to its shard's device raise, ``disarm()`` undoes both
    everywhere."""

    def __init__(self, group):
        self.group = group
        self.oid = group.register(self)

    def _call(self, method, *args):
        self.group.lead("call", self.oid, method, args, {})

    def arm(self, rank: int, site: str) -> None:
        if self.group.rank == 0:
            self._call("arm", rank, site)
        if self.group.rank == rank:
            fault.install(fault.FaultPlan([fault.FaultRule(site, times=10**9)]))

    def break_copy(self, rank: int) -> None:
        if self.group.rank == 0:
            self._call("break_copy", rank)
        if self.group.rank == rank:
            def broken(search, q, qmask):
                raise RuntimeError(f"rank {rank} could not copy the queries")

            ShardedSearch.to_device = broken

    def disarm(self) -> None:
        if self.group.rank == 0:
            self._call("disarm")
        fault.uninstall()
        ShardedSearch.to_device = _TO_DEVICE


def _follower(group, out: str) -> None:
    got = follow(group)
    with open(os.path.join(out, f"follower{group.rank}.json"), "w") as f:
        json.dump(got, f)


def jax_parity(group, store, jax_npz, out, plans, search, serve_search):
    """Every plan single and batched, the adaptive rungs and rung-forced
    batches, ``describe()``, the JAX script's served run (a 50% allowlist
    and a delete), a reload, a kernel fault and then a failed query copy
    on rank 1 only, and each rank's ``rank_info``."""
    switch = FaultSwitch(group)
    if group.rank:
        _follower(group, out)
        return
    try:
        _lead_parity(group, switch, store, jax_npz, out, plans, search, serve_search)
    finally:
        group.stop()


def _lead_parity(group, switch, store, jax_npz, out, plans, search, serve_search):
    z = np.load(jax_npz)
    q, qmask = z["q"], z["qmask"]
    r = Retriever.from_store(store, group=group)
    allow = DocFilter.allow(np.arange(0, r.n_docs, 2), r.n_docs)
    res, desc = {}, {}
    for name, strat in plans.items():
        plan = r.plan(WarpSearchConfig(**search, **strat),
                      dfilter=allow if name.endswith("_allow") else None)
        one = [plan.retrieve(q[i], qmask[i]) for i in range(len(q))]
        res[name + "/ids"] = np.stack([x.doc_ids.numpy() for x in one])
        res[name + "/scores"] = np.stack([x.scores.numpy() for x in one])
        b = plan.retrieve_batch(q[:4], qmask[:4])
        res[name + "/batch_ids"], res[name + "/batch_scores"] = b.doc_ids.numpy(), b.scores.numpy()
        if plan.adaptive:
            rungs = [plan.adaptive_bucket(q[i], qmask[i]) for i in range(len(q))]
            res[name + "/rungs"] = np.array(rungs)
            for rung in plan.config.worklist_buckets:
                if rung >= max(rungs):
                    at = plan.retrieve_batch_at(q[:4], qmask[:4], bucket=rung)
                    res[f"{name}/at{rung}_ids"] = at.doc_ids.numpy()
        desc[name] = plan.describe()

    srv = RetrievalServer(r, WarpSearchConfig(**serve_search), BatchPolicy(max_batch=4), lambda: 0.0)
    rids = [srv.submit(q[i], qmask[i]) for i in range(8)]
    rids += [srv.submit(q[i], qmask[i], dfilter=allow) for i in range(8)]
    srv.drain()
    srv.delete_documents([int(i) for i in z["fused_ragged/ids"][:, 0]])
    rids += [srv.submit(q[i], qmask[i]) for i in range(8)]
    srv.drain()
    got = [srv.poll(rid) for rid in rids]
    res["serve/scores"] = np.stack([s for s, _ in got])
    res["serve/ids"] = np.stack([d for _, d in got])
    srv.reload(store)
    st = srv._state(None)
    info = {"reload": [st.retriever.is_ranked, st.retriever.n_shards, srv.index_epoch]}
    res["reload/ids"] = srv.result(srv.submit(q[0], qmask[0]))[1]

    # A fault on rank 1 only, in its kernel call and then in its query
    # copy: the batch raises on every rank, the next one is served.
    for tag, i, nxt, arm in (
        ("fault", 1, 4, lambda: switch.arm(1, "engine.kernel_call")),
        ("copy_fault", 2, 5, lambda: switch.break_copy(1)),
    ):
        bad = [srv.submit(q[i], qmask[i]) for _ in range(3)]  # one rung: one batch
        arm()
        try:
            srv.step(force=True)
            info[tag] = None
        except RankFailure as e:
            info[tag] = str(e)
        finally:
            switch.disarm()
        info[tag + "_polls"] = []
        for rid in bad:
            try:
                srv.poll(rid)
                info[tag + "_polls"].append(None)
            except RankFailure as e:
                info[tag + "_polls"].append(str(e))
        info[tag + "_health"] = srv.health()["status"]
        res[f"after_{tag}/ids"] = srv.result(srv.submit(q[nxt], qmask[nxt]))[1]
        info[tag + "_health_after"] = srv.health()["status"]
    info["ranks"] = st.retriever.rank_info()
    try:
        r.rank_info()  # closed by the reload, on every rank
        info["closed"] = None
    except ValueError as e:
        info["closed"] = str(e)
    np.savez(os.path.join(out, "ranked.npz"), **res)
    with open(os.path.join(out, "ranked.json"), "w") as f:
        json.dump({"describe": desc, **info}, f, default=str)


def load_only(group, store):
    """Rank 0 loads ``store`` over the group (a store of another shard
    count raises on every rank)."""
    if group.rank:
        follow(group)
        return
    try:
        Retriever.from_store(store, group=group)
    finally:
        group.stop()


def unsettled_failure(group, store, search):
    """Rank 1's ``SearchPlan._inputs`` raises outside any collective, so
    the other ranks would wait for it in the first gather: its follower
    loop ends with the error and the world ends with it."""
    if group.rank == 1:
        def broken(plan, q, qmask, lead):
            raise RuntimeError("rank 1 could not take the queries")

        SearchPlan._inputs = broken
    if group.rank:
        follow(group)
        return
    try:
        r = Retriever.from_store(store, group=group)
        plan = r.plan(WarpSearchConfig(**search))
        plan.retrieve(np.zeros((4, r.index.dim), np.float32))
    finally:
        group.stop()
