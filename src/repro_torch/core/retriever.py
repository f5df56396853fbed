"""``Retriever`` facade: plan once, retrieve many. Counterpart of
``repro/core/retriever.py``.

  build                     index a corpus on ``device`` (None -> "cuda"),
                            document-sharded with ``n_shards``
  from_index / from_store   adopt an index (a ``WarpIndex``, a
                            ``ShardedWarpIndex``, a ``SegmentedWarpIndex``,
                            a JAX ``WarpIndex`` or ``ShardedWarpIndex``, or
                            a dict of its arrays) or a saved store (single,
                            sharded, or with delta segments), onto ``device``
  plan(config, dfilter=)    validate against the index geometry, resolve
                            every data-dependent default and the doc
                            filter -> ``SearchPlan`` (cached per
                            (config, filter digest))
  plan_for_k(k, config)     plan with the k-ladder's defaults for a
                            requested result depth (``K_LADDER``)
  retrieve / retrieve_batch one query [Q, D] / a batch [B, Q, D]

Ragged plans are query-adaptive as in the JAX package: WARP_SELECT runs
once, its probe sizes (or, on a segmented index, its probe ids) come to
the host (the one sync of the adaptive pick), and stages 2+3 run at the
smallest ladder rung that fits the query's — or the batch's — real tile
demand. On a segmented index a probed cluster costs the sum of its
per-segment tile counts; a filtered plan counts only runs over clusters
with a surviving token. A sharded plan (``core/distributed.py``) runs
stage 1 on every shard and picks one rung for all of them: the largest
demand over the shards (and the batch), plus JAX's one tile of pre-pass
slack, so its rungs are JAX's. There is no executor fallback: a kernel
failure raises (the JAX plan's ``_activate_fallback`` is not ported).

Ranked: ``from_store(path, group=)`` loads only this rank's shard of a
sharded store (``RankedShard``) and every collective operation runs on
every rank of the ``RankGroup``: ``plan`` (rank 0's config and filter;
the plans' fingerprints must agree), ``retrieve``, ``retrieve_batch``,
``retrieve_batch_at``, ``adaptive_bucket``, ``warmup`` and ``close``. Rank
0 calls them as on any retriever and broadcasts each to the other ranks,
which run them in ``repro_torch.serving.follow``; the per-rank body is
``distributed.make_sharded_search_fn``. Results, rungs and ``describe()``
equal the one-process stack's.

Observability (``repro_torch.obs``): disabled, a retrieve pays two
attribute checks; with metrics on, ``warp_retrieves_total`` and
``warp_retrieve_seconds`` per kind (after one ``torch.cuda.synchronize``
on the card); with a tracer, single-index plans run stage by stage under
``retrieve`` -> ``warp_select`` -> ``bucket_pick`` -> ``gather_score`` ->
``reduce`` spans (JAX's names and attributes), fenced by
``torch.cuda.synchronize(device)`` on the card, and the stage histograms
``warp_stage_seconds`` record; with ``obs.set_kernel_probes(True)`` the
``gather_score`` span also carries the scoring kernel's staging/scoring
split (``engine.kernel_dma_compute_split``). Segmented and sharded plans
trace as one ``engine`` span. The traced result is bit-identical to the untraced one:
the stages are the very calls ``engine.finish_from_probes`` makes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import docfilter as df
from repro_torch.core import engine
from repro_torch.core import worklist as wl
from repro_torch.core.index import build_index
from repro_torch.core.reduction import TopKResult
from repro_torch.core.types import (
    IndexBuildConfig,
    WarpIndex,
    WarpSearchConfig,
    resolve_device,
)
from repro_torch.kernels import ops
from repro_torch.obs import STATE as _OBS

__all__ = ["Retriever", "SearchPlan", "K_LADDER", "ladder_rung", "laddered_config"]


# Per-k retrieval hyperparameter ladder (JAX ``repro/core/retriever.py``):
# small k needs few probes; deep result lists need a wider probe set, a
# deeper imputation scan and a larger t'. Each rung is (k upper bound
# inclusive — None = unbounded, rung name, overrides).
K_LADDER = (
    (10, "small", dict(nprobe=16, k_impute=32, t_prime_scale=0.5)),
    (100, "medium", dict(nprobe=32, k_impute=64, t_prime_scale=1.0)),
    (None, "large", dict(nprobe=64, k_impute=128, t_prime_scale=2.0)),
)


def ladder_rung(k: int) -> tuple[str, dict]:
    """(rung name, parameter overrides) for a requested result depth."""
    for bound, name, params in K_LADDER:
        if bound is None or k <= bound:
            return name, params
    raise AssertionError("unreachable: ladder has an unbounded rung")


def laddered_config(
    k: int,
    config: WarpSearchConfig | None = None,
    *,
    n_tokens: int | None = None,
    n_centroids: int | None = None,
) -> WarpSearchConfig:
    """Per-request hyperparameters from the requested ``k`` (``K_LADDER``).

    A field of ``config`` that differs from the ``WarpSearchConfig``
    default is pinned by the caller and never overridden; fields left at
    their defaults take the ladder value for ``k``'s rung. With the index
    geometry the ladder also concretizes ``t_prime`` (``t_prime_scale *
    sqrt(n_tokens)``, clamped) and clamps ``nprobe`` to the centroid
    count."""
    base = config if config is not None else WarpSearchConfig()
    default = WarpSearchConfig()
    _, params = ladder_rung(int(k))
    kw: dict = {"k": int(k)}
    if base.nprobe == default.nprobe:
        nprobe = int(params["nprobe"])
        if n_centroids is not None:
            nprobe = max(1, min(nprobe, int(n_centroids)))
        kw["nprobe"] = nprobe
    if base.k_impute == default.k_impute:
        kw["k_impute"] = int(params["k_impute"])
    if base.t_prime is None and n_tokens:
        tp = int(params["t_prime_scale"] * (int(n_tokens) ** 0.5))
        kw["t_prime"] = max(1, min(tp, base.t_prime_max, int(n_tokens)))
    return dataclasses.replace(base, **kw)


def _is_adaptive(cfg: WarpSearchConfig) -> bool:
    return (
        cfg.layout == "ragged"
        and cfg.worklist_buckets is not None
        and len(cfg.worklist_buckets) > 1
    )


def _segments_module():
    from repro_torch.store import segments  # the store depends on core

    return segments


def _is_segmented(index) -> bool:
    return isinstance(index, _segments_module().SegmentedWarpIndex)


def _to_host(x):
    """A command's argument as rank 0 broadcasts it: tensors as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


class SearchPlan:
    """A validated pipeline bound to one index, one resolved config
    (``t_prime``/``k_impute`` concrete, ``executor`` "kernel" or
    "reference", layout/tile/worklist fields resolved) and, optionally,
    one resolved doc filter (``fctx``: a ``FilterView``, stacked per shard
    on a sharded index, this rank's on a ``RankedShard``, or
    ``resolve_segmented``'s triple on a segmented index)."""

    def __init__(
        self, index, config: WarpSearchConfig, geometry: dict, *, fctx=None,
        filter_info: dict | None = None,
    ):
        self.config = config
        self.index = index
        self.ranked = isinstance(index, dist.RankedShard)
        self.sharded = self.ranked or isinstance(index, dist.ShardedWarpIndex)
        self.n_shards = index.n_shards if self.sharded else 1
        self.backend = index.device.type
        self.index_geometry = geometry
        self.adaptive = _is_adaptive(config)
        self.fctx = fctx
        self.filter_info = filter_info
        self.segmented = _is_segmented(index)
        self._tile = ops.resolve_tile_c(index.cap, config.tile_c, layout="ragged")
        self._live = None
        if self.segmented:
            self._combined = index.combined_cluster_sizes()
            if self.adaptive:
                # Combined per-cluster tile demand over the segments.
                tiles = (index.per_segment_cluster_sizes() + self._tile - 1) // self._tile
                if fctx is not None:
                    tiles = tiles * fctx[2]
                self._cluster_tiles = tiles.sum(axis=0)
        elif self.sharded:
            self._search = dist.make_sharded_search_fn(
                index, config, fv=fctx, adaptive=self.adaptive
            )
        elif fctx is not None and self.adaptive:
            self._live = fctx.cluster_live.cpu().numpy()
        self._oid = None  # a ranked plan's number, given by Retriever.plan on every rank

    def _lead(self, method: str, *args, **kwargs) -> None:
        """A ranked plan's collective operation: rank 0 broadcasts it to the
        followers, which then make the same call."""
        if self.ranked:
            self.index.group.lead(
                "call", self._oid, method, tuple(_to_host(a) for a in args),
                {k: _to_host(v) for k, v in kwargs.items()},
            )

    # ---- inputs ----
    def _tensor(self, x, dtype, device) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return x.to(device=device, dtype=dtype)

    def _inputs(self, q, qmask, lead: int):
        """Queries and mask as tensors on the index's device. A ranked plan
        keeps them on the host and checks their shapes, before rank 0
        broadcasts them: the per-shard body moves them to the card inside
        its first settled step, so a rank whose copy fails raises on every
        rank."""
        device = torch.device("cpu") if self.ranked else self.index.device
        q = self._tensor(q, torch.float32, device)
        if qmask is None:
            qmask = torch.ones(q.shape[:lead], dtype=torch.bool, device=q.device)
        qmask = self._tensor(qmask, torch.bool, device)
        if self.ranked and (
            q.ndim != lead + 1 or q.shape[-1] != self.index.dim
            or tuple(qmask.shape) != tuple(q.shape[:-1])
        ):
            raise ValueError(
                f"queries {tuple(q.shape)} with mask {tuple(qmask.shape)}: expected "
                f"{'[B, ' if lead == 2 else '['}Q, {self.index.dim}] and the mask "
                "over all but the last axis"
            )
        return q, qmask

    # ---- dispatch ----
    def retrieve(self, q, qmask=None) -> TopKResult:
        """One query q f32[Q, D] -> (scores f32[k], doc_ids i32[k])."""
        q, qmask = self._inputs(q, qmask, 1)
        self._lead("retrieve", q, qmask)
        res = self._dispatch(q[None], qmask[None], "single")
        return TopKResult(res.scores[0], res.doc_ids[0])

    def retrieve_batch(self, q, qmask=None) -> TopKResult:
        """Query batch q f32[B, Q, D] -> TopKResult with leading batch dim;
        an adaptive plan runs the whole batch at one rung (the max)."""
        q, qmask = self._inputs(q, qmask, 2)
        self._lead("retrieve_batch", q, qmask)
        return self._dispatch(q, qmask, "batch")

    def warmup(self) -> bool:
        """Run the plan once per ladder rung (once on a non-adaptive plan)
        on a dummy batch, so a kernel failure surfaces here rather than on
        the first request, and on the card every kernel of the plan is
        built. There is no fallback: a failure raises. Returns False (the
        JAX plan returns whether it demoted itself to its reference
        executor; the port never does)."""
        self._lead("warmup")
        geo = self.index_geometry
        q = torch.zeros((1, 2, geo["dim"]), dtype=torch.float32, device=self.index.device)
        qmask = torch.ones((1, 2), dtype=torch.bool, device=self.index.device)
        for rung in self.config.worklist_buckets if self.adaptive else (None,):
            self._run(q, qmask, bucket=rung)
        self._fence()
        return False

    def _fence(self) -> None:
        """Wait for the card's queued work (nothing to wait for on the CPU)."""
        if self.index.device.type == "cuda":
            torch.cuda.synchronize(self.index.device)

    def _dispatch(self, q, qmask, kind: str, bucket: int | None = None) -> TopKResult:
        """Observability-aware dispatch: disabled, two attribute checks
        then ``_run``; metrics only, ``_run`` timed into
        ``warp_retrieve_seconds`` after a fence; tracing, the stage-split
        ``_run_traced``."""
        if _OBS.tracer is not None:
            return self._run_traced(q, qmask, kind, bucket)
        if _OBS.metrics is not None:
            t0 = time.perf_counter()
            out = self._run(q, qmask, bucket)
            self._fence()
            self._obs_retrieve(_OBS.metrics, kind, time.perf_counter() - t0)
            return out
        return self._run(q, qmask, bucket)

    @staticmethod
    def _obs_retrieve(reg, kind: str, dt: float) -> None:
        reg.counter(
            "warp_retrieves_total",
            "Retrieve dispatches through SearchPlan", kind=kind,
        ).inc()
        reg.histogram(
            "warp_retrieve_seconds",
            "End-to-end retrieve latency at the plan boundary", kind=kind,
        ).observe(dt)

    @staticmethod
    def _obs_stage(reg, stage: str, sp) -> None:
        # Stage histograms record only under tracing (the fences make a
        # stage's duration meaningful), on the tracer's clock.
        if reg is not None and sp.dur is not None:
            reg.histogram(
                "warp_stage_seconds",
                "Per-stage engine latency (traced retrieves only)",
                stage=stage,
            ).observe(sp.dur)

    def _run_traced(self, q, qmask, kind: str, bucket: int | None) -> TopKResult:
        """Per-stage spans: warp_select -> bucket_pick -> gather_score ->
        reduce, fenced after each stage so a span's duration is its
        stage's. The stages are ``_run``'s own calls (``score_from_probes``
        then ``reduce_from_scored`` is ``finish_from_probes``), so the
        result is bit-identical. Segmented and sharded plans run ``_run``
        under one ``engine`` span."""
        tr, reg = _OBS.tracer, _OBS.metrics
        cfg = self.config
        staged = not (self.segmented or self.sharded)
        t0 = time.perf_counter()
        with tr.span(
            "retrieve", kind=kind, layout=cfg.layout, n_shards=self.n_shards,
            staged=staged,
        ) as root:
            if not staged:
                with tr.span("engine"):
                    out = self._run(q, qmask, bucket)
                    self._fence()
            else:
                with tr.span(
                    "warp_select", nprobe=cfg.nprobe, t_prime=cfg.t_prime,
                    k_impute=cfg.k_impute,
                ) as sp:
                    sel = self._select(q, qmask)
                    self._fence()
                self._obs_stage(reg, "warp_select", sp)
                if bucket is None and self.adaptive:
                    with tr.span("bucket_pick") as sp:
                        bucket = self._pick(sel, qmask)
                        sp.set(bucket=bucket)
                    root.set(bucket=bucket)
                run_cfg = self._cfg_at(bucket)
                with tr.span(
                    "gather_score", gather=run_cfg.gather,
                    executor=run_cfg.executor, tile_c=run_cfg.tile_c,
                    buffering=run_cfg.buffering,
                    worklist_tiles=run_cfg.worklist_tiles,
                ) as sp:
                    scored = engine.score_from_probes(
                        self.index, q, qmask, sel, run_cfg, dfilter=self.fctx
                    )
                    self._fence()
                    if _OBS.kernel_probes:
                        sp.set(**engine.kernel_dma_compute_split(
                            self.index, q, qmask, sel, run_cfg
                        ))
                self._obs_stage(reg, "gather_score", sp)
                with tr.span(
                    "reduce", sort_n=int(scored[0].shape[-1]), k=run_cfg.k,
                    impl=run_cfg.reduce_impl,
                ) as sp:
                    out = engine.reduce_from_scored(
                        self.index, scored, sel.mse, run_cfg, dfilter=self.fctx
                    )
                    self._fence()
                self._obs_stage(reg, "reduce", sp)
        if reg is not None:
            self._obs_retrieve(reg, kind, time.perf_counter() - t0)
        return out

    def retrieve_batch_at(self, q, qmask=None, *, bucket: int) -> TopKResult:
        """Query batch at a forced ladder rung (adaptive plans only). Any
        rung that fits every element's demand gives the same doc ids."""
        if not self.adaptive:
            raise ValueError(
                "retrieve_batch_at needs an adaptive ragged plan "
                "(layout='ragged' with a multi-rung bucket ladder)"
            )
        if bucket not in self.config.worklist_buckets:
            raise ValueError(
                f"bucket {bucket} is not a rung of this plan's ladder "
                f"{self.config.worklist_buckets}"
            )
        q, qmask = self._inputs(q, qmask, 2)
        self._lead("retrieve_batch_at", q, qmask, bucket=bucket)
        return self._dispatch(q, qmask, "batch_at", bucket)

    def adaptive_bucket(self, q, qmask=None) -> int | None:
        """The rung the adaptive dispatcher would run this single query
        (q f32[Q, D]) at; None on non-adaptive plans."""
        if not self.adaptive:
            return None
        q, qmask = self._inputs(q, qmask, 1)
        self._lead("adaptive_bucket", q, qmask)
        if self.sharded:
            return self._search.bucket(q[None], qmask[None])
        return self._pick(self._select(q[None], qmask[None]), qmask[None])

    def _select(self, q, qmask):
        """Stage 1 on a single or segmented index: a ``WarpSelectOut``."""
        if self.segmented:
            return _segments_module().select_probes(
                self.index, q, qmask, self.config, self._combined
            )
        return engine.select_probes(self.index, q, qmask, self.config)

    def _pick(self, sel, qmask) -> int:
        """Smallest rung fitting the masked probe tile demand: masked
        tokens and (filtered plans) dead clusters build no tiles. Needs
        the probe metadata on the host — the adaptive path's one sync."""
        m = qmask.cpu().numpy()
        if self.segmented:
            # One worklist over all Q tokens: demand amortizes.
            tiles = self._cluster_tiles[sel.probe_cids.cpu().numpy()] * m[..., None]
            needed = wl.needed_worklist_tiles(tiles, amortized=True)
        else:
            sizes = sel.probe_sizes.cpu().numpy()
            if self._live is not None:
                sizes = wl.filtered_probe_sizes(sizes, sel.probe_cids.cpu().numpy(), self._live)
            tiles = wl.probe_tile_counts(sizes, self._tile) * m[..., None]
            needed = wl.needed_worklist_tiles(tiles, amortized=self.config.memory == "full")
        return wl.pick_bucket(self.config.worklist_buckets, needed)

    def _cfg_at(self, bucket: int | None) -> WarpSearchConfig:
        """The run config at a ladder rung (the plan's on non-adaptive
        plans)."""
        if not self.adaptive:
            return self.config
        return dataclasses.replace(
            self.config, worklist_tiles=bucket, worklist_buckets=None
        )

    def _run(self, q, qmask, bucket: int | None = None) -> TopKResult:
        if self.sharded:
            return self._search(q, qmask, bucket)
        sel = self._select(q, qmask)
        if self.adaptive and bucket is None:
            bucket = self._pick(sel, qmask)
        cfg = self._cfg_at(bucket)
        if self.segmented:
            return _segments_module().finish_from_probes(
                self.index, q, qmask, sel, cfg, self.fctx
            )
        return engine.finish_from_probes(self.index, q, qmask, sel, cfg, dfilter=self.fctx)

    # ---- snapshot ----
    def describe(self) -> dict:
        """Every resolved pipeline choice (JSON-serializable), with the
        same keys as the JAX plan's snapshot; ``k_ladder`` names the
        ``K_LADDER`` rung of the plan's k."""
        d = self._describe_core()
        d["fingerprint"] = self.fingerprint()
        return d

    def fingerprint(self) -> str:
        blob = json.dumps(self._describe_core(), sort_keys=True, default=str).encode()
        return hashlib.sha1(blob).hexdigest()[:16]

    def _describe_core(self) -> dict:
        cfg = self.config
        geo = self.index_geometry
        cap = geo["cap"]
        tile = ops.resolve_tile_c(cap, cfg.tile_c, layout=cfg.layout)
        dense_slots = cfg.nprobe * cap
        if cfg.layout == "ragged" and cfg.worklist_tiles is not None:
            slots = cfg.worklist_tiles * tile
        else:
            slots = dense_slots
        mean_cluster = geo["n_tokens"] / max(1, self.n_shards * geo["n_centroids"])
        expected_real = min(dense_slots, cfg.nprobe * mean_cluster)
        return {
            "gather": cfg.gather,
            "executor": cfg.executor,
            "memory": cfg.memory,
            "layout": cfg.layout,
            "tile_c": tile,
            "tile_source": cfg.tile_source or "heuristic",
            "buffering": cfg.buffering,
            "worklist_tiles": cfg.worklist_tiles,
            "worklist_buckets": (
                list(cfg.worklist_buckets) if cfg.worklist_buckets else None
            ),
            "slots_per_qtoken": slots,
            "dense_slots_per_qtoken": dense_slots,
            "expected_slot_occupancy": round(expected_real / max(1, slots), 4),
            "reduce_impl": cfg.reduce_impl,
            "sum_impl": cfg.sum_impl,
            "nprobe": cfg.nprobe,
            "t_prime": cfg.t_prime,
            "k": cfg.k,
            "k_ladder": ladder_rung(cfg.k)[0],
            "k_impute": cfg.k_impute,
            "n_shards": self.n_shards,
            "backend": self.backend,
            "filter": self.filter_info,
            **geo,
        }


class Retriever:
    """Facade over the port's WARP engine: adopt an index, plan, retrieve.

    >>> r = Retriever.from_store(path)              # on the card
    >>> plan = r.plan(WarpSearchConfig(gather="fused", layout="ragged"))
    >>> res = plan.retrieve(q, qmask)

    It wraps a ``WarpIndex``, a ``ShardedWarpIndex`` (document shards
    stacked on one device, ``core/distributed.py``: stage 1 and stages 2+3
    per shard with one global m_i, then the top-k merge), a
    ``RankedShard`` (this process's shard of a ``RankGroup``, one shard
    per rank: ``from_store(path, group=)``) or a ``SegmentedWarpIndex`` (a
    frozen base plus delta segments, ``repro_torch.store.segments``: stage
    1 once over the combined cluster sizes, then every segment scored,
    ``segments.finish_from_probes``). A ``Retriever`` of a ``RankedShard``
    is made on every rank of its group in the same order (``from_store``
    does so), since collective operations name it by its number.
    """

    def __init__(self, index):
        index_types = (WarpIndex, dist.ShardedWarpIndex, dist.RankedShard)
        if not isinstance(index, index_types) and not _is_segmented(index):
            raise TypeError(
                f"Retriever wraps a repro_torch WarpIndex, ShardedWarpIndex, RankedShard or "
                f"SegmentedWarpIndex, got {type(index).__name__}; use Retriever.from_index"
            )
        self.index = index
        # Keyed by (config, filter digest | None).
        self._plans: dict = {}
        self.load_seconds: float | None = None  # set by a ranked from_store
        if self.is_ranked:
            self._oid = index.group.register(self)

    @classmethod
    def build(
        cls,
        embeddings,
        token_doc_ids,
        n_docs: int,
        index_cfg: IndexBuildConfig = IndexBuildConfig(),
        *,
        n_shards: int | None = None,
        device=None,
    ) -> "Retriever":
        """Index a corpus (``core.index.build_index``) on ``device`` (None ->
        "cuda", raising when CUDA is absent); with ``n_shards``, the
        document-sharded build (``distributed.build_sharded_index``), every
        shard on that device."""
        if n_shards is not None:
            return cls(dist.build_sharded_index(
                embeddings, token_doc_ids, n_docs, n_shards, index_cfg, device=device
            ))
        return cls(build_index(embeddings, token_doc_ids, n_docs, index_cfg, device=device))

    @classmethod
    def from_index(cls, index, *, device=None) -> "Retriever":
        """Adopt ``index`` on ``device`` (None -> "cuda", raising when CUDA
        is absent; pass ``device="cpu"`` for the CPU). ``index`` is an
        index of this package, or anything ``WarpIndex.from_arrays`` /
        ``ShardedWarpIndex.from_arrays`` takes (e.g. a JAX index)."""
        if isinstance(index, dist.RankedShard):
            raise TypeError(
                "a RankedShard stays on its rank's device: wrap it with Retriever(shard) "
                "on every rank, or load it with Retriever.from_store(path, group=)"
            )
        device = resolve_device(device)
        if isinstance(index, (WarpIndex, dist.ShardedWarpIndex)) or _is_segmented(index):
            return cls(index.to(device))
        if dist.is_sharded_like(index):
            return cls(dist.ShardedWarpIndex.from_arrays(index, device=device))
        return cls(WarpIndex.from_arrays(index, device=device))

    @classmethod
    def from_store(cls, path: str, *, device=None, group=None) -> "Retriever":
        """Adopt a saved store (``repro_torch.store``): single, sharded, or
        with its delta segments. With ``group`` (a ``RankGroup``), a
        collective operation: each rank loads only its own shard of a
        sharded store on its own device (``store.load_shard``); ``device``,
        if given, must be that device. A store whose shard count is not
        the group's size raises on every rank."""
        from repro_torch.store import load_index, load_shard

        if group is None:
            return cls(load_index(path, device=device))
        if device is not None and torch.device(device) != group.device:
            raise ValueError(f"rank {group.rank} runs on {group.device}, not {device}")
        group.lead("load", path)
        shard = err = None
        t0 = time.perf_counter()
        try:
            shard = load_shard(path, group)
        except Exception as e:  # every rank raises in settle
            err = e
        group.settle("load", err)
        out = cls(shard)
        out.load_seconds = time.perf_counter() - t0
        return out

    def rank_info(self) -> list[dict]:
        """A ranked retriever's ranks, in rank order (a collective
        operation): each rank's device, the bytes of its shard, the bytes
        allocated on its device, its load seconds and its scoring kernels'
        launch counts (``kernels.LAUNCHES``)."""
        from repro_torch.kernels import LAUNCHES

        if not self.is_ranked:
            raise ValueError("rank_info needs a ranked retriever (from_store(path, group=))")
        self._lead("rank_info")
        dev = self.device
        info = err = None
        try:
            info = {
                "rank": self.index.rank,
                "device": str(dev),
                "index_bytes": self.index.nbytes(),
                "allocated_bytes": (
                    torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
                ),
                "load_s": self.load_seconds,
                "launches": dict(LAUNCHES),
            }
        except Exception as e:  # every rank raises in settle
            err = e
        return self.index.group.settle("rank_info", err, info)

    def close(self) -> None:
        """Drop the cached plans; on a ranked retriever, a collective
        operation that also drops it and its plans on every rank."""
        if self.is_ranked:
            self._lead("close")
            self.index.group.release(
                [self._oid] + [p._oid for p in set(self._plans.values())]
            )
        self._plans.clear()

    def _lead(self, method: str, *args, **kwargs) -> None:
        if self.is_ranked:
            self.index.group.lead("call", self._oid, method, args, kwargs)

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def n_docs(self) -> int:
        return self.index.n_docs

    @property
    def is_segmented(self) -> bool:
        return _is_segmented(self.index)

    @property
    def is_sharded(self) -> bool:
        return isinstance(self.index, (dist.ShardedWarpIndex, dist.RankedShard))

    @property
    def is_ranked(self) -> bool:
        """Whether this process holds one shard of a ``RankGroup``."""
        return isinstance(self.index, dist.RankedShard)

    @property
    def n_shards(self) -> int:
        return self.index.n_shards if self.is_sharded else 1

    def plan(
        self, config: WarpSearchConfig = WarpSearchConfig(), *, dfilter=None
    ) -> SearchPlan:
        """Validate and resolve ``config``; cached per (config, filter
        digest). ``dfilter`` (a ``DocFilter``) restricts retrieval to its
        surviving doc ids: resolved once here, pushed down and masked per
        retrieve. Raises ValueError on an unsatisfiable config."""
        if dfilter is not None and not isinstance(dfilter, df.DocFilter):
            raise TypeError(f"dfilter must be a DocFilter, got {type(dfilter).__name__}")
        digest = dfilter.digest if dfilter is not None else None
        cached = self._plans.get((config, digest))
        if cached is not None:
            return cached
        if self.is_ranked:
            plan = self._plan_ranked(config, dfilter)
        else:
            plan = self._make_plan(config, dfilter)
        self._plans[(config, digest)] = plan
        self._plans[(plan.config, digest)] = plan
        return plan

    def _make_plan(self, config: WarpSearchConfig, dfilter) -> SearchPlan:
        fctx = self._resolve_filter(dfilter)
        resolved = self._resolve(config)
        self._validate(resolved)
        return SearchPlan(
            self.index, resolved, self._geometry(), fctx=fctx,
            filter_info=dfilter.describe() if dfilter is not None else None,
        )

    def _plan_ranked(self, config: WarpSearchConfig, dfilter) -> SearchPlan:
        """Every rank plans rank 0's config and filter; every rank raises
        if any failed, or if the plans' fingerprints differ."""
        group = self.index.group
        self._lead("plan", config, dfilter=dfilter)
        plan = err = None
        try:
            plan = self._make_plan(config, dfilter)
        except Exception as e:  # every rank raises in settle
            err = e
        fps = group.settle("plan", err, None if plan is None else plan.fingerprint())
        if len(set(fps)) != 1:
            group.fail(dist.RankFailure(f"the ranks planned different plans: fingerprints {fps}"))
        plan._oid = group.register(plan)
        return plan

    def plan_for_k(
        self, k: int, config: WarpSearchConfig | None = None, *, dfilter=None
    ) -> SearchPlan:
        """Plan with the k-ladder's defaults for result depth ``k``
        (``laddered_config``: explicit ``config`` settings still win); the
        rung shows as ``k_ladder`` in ``describe()``."""
        n_tokens = self.index.resolved_n_tokens() if self.is_sharded else self.index.n_tokens
        cfg = laddered_config(k, config, n_tokens=n_tokens, n_centroids=self.index.n_centroids)
        return self.plan(cfg, dfilter=dfilter)

    def _resolve_filter(self, dfilter):
        """A ``FilterView`` (single index; stacked per shard on a sharded
        one) or ``resolve_segmented``'s triple (segmented); None passes
        through."""
        if dfilter is None:
            return None
        if dfilter.n_docs != self.n_docs:
            raise ValueError(
                f"DocFilter covers {dfilter.n_docs} docs but the index holds "
                f"{self.n_docs}; rebuild the filter against this corpus snapshot"
            )
        if self.is_ranked:
            return df.resolve_rank(dfilter, self.index)
        if self.is_sharded:
            return df.resolve_sharded(dfilter, self.index)
        if self.is_segmented:
            return df.resolve_segmented(dfilter, self.index)
        return df.resolve_local(dfilter, self.index)

    def _resolve(self, config: WarpSearchConfig) -> WarpSearchConfig:
        if self.is_sharded:
            return dist.resolve_sharded_config(self.index, config)
        if self.is_segmented:
            return self._resolve_segmented(config)
        return engine.resolve_config(self.index, config)

    def _resolve_segmented(self, config: WarpSearchConfig) -> WarpSearchConfig:
        """``engine.resolve_config`` for base + deltas: t' from the total
        token count, the ragged bound from the per-segment geometries
        (``worklist_bound_segmented``: one worklist spans the segments),
        and "auto" against the dense segmented cost ``nprobe * sum_s
        cap_s`` slots per query token."""
        idx = self.index
        if idx.n_tokens == 0:
            raise ValueError(
                "segmented index has n_tokens == 0 — nothing to retrieve. "
                "Build or load a non-empty index before planning a search."
            )
        on_cuda = idx.device.type == "cuda"
        executor = config.resolved_executor(on_cuda)
        if executor == "kernel" and not on_cuda:
            raise ValueError(
                f"executor='kernel' runs the CUDA kernels, but the index is on "
                f"{idx.device}; load it with device='cuda', or plan "
                "executor='reference' (or 'auto') on the CPU"
            )
        config = dataclasses.replace(
            config,
            t_prime=config.resolved_t_prime(idx.n_tokens),
            k_impute=config.resolved_k_impute(idx.n_centroids),
            executor=executor,
        )
        geo = engine.index_geometry(idx)
        if config.layout == "dense":
            config = engine.resolve_tile_fields(config, cap=idx.cap, layout="dense", **geo)
            return dataclasses.replace(config, worklist_tiles=None, worklist_buckets=None)
        ragged = engine.resolve_tile_fields(config, cap=idx.cap, layout="ragged", **geo)
        tile = ragged.tile_c
        bound = wl.worklist_bound_segmented(idx.per_segment_cluster_sizes(), config.nprobe, tile)
        dense_slots = config.nprobe * sum(s.cap for s in idx.segments)
        layout = config.layout
        if layout == "auto":
            layout = "ragged" if bound * tile < dense_slots else "dense"
        if layout == "dense":
            config = engine.resolve_tile_fields(config, cap=idx.cap, layout="dense", **geo)
            return dataclasses.replace(
                config, layout="dense", worklist_tiles=None, worklist_buckets=None
            )
        return dataclasses.replace(
            ragged, layout="ragged", worklist_tiles=bound,
            worklist_buckets=wl.bucket_ladder(bound),
        )

    def _validate(self, cfg: WarpSearchConfig) -> None:
        idx = self.index
        problems = []
        if cfg.nprobe < 1:
            problems.append(f"nprobe={cfg.nprobe} must be >= 1")
        if cfg.nprobe > idx.n_centroids:
            problems.append(
                f"nprobe={cfg.nprobe} exceeds the index's {idx.n_centroids} centroids"
            )
        if cfg.k < 1:
            problems.append(f"k={cfg.k} must be >= 1")
        if cfg.t_prime < 1:
            problems.append(f"t_prime={cfg.t_prime} must be >= 1")
        max_cands = cfg.nprobe * idx.cap
        if idx.cap and cfg.k > max_cands:
            problems.append(
                f"k={cfg.k} exceeds the candidate pool nprobe*cap="
                f"{max_cands}; raise nprobe or lower k"
            )
        if problems:
            raise ValueError("unsatisfiable search plan: " + "; ".join(problems))

    def _geometry(self) -> dict:
        idx = self.index
        geo = {
            "n_docs": idx.n_docs,
            "n_centroids": idx.n_centroids,
            "cap": idx.cap,
            "nbits": idx.nbits,
            "dim": idx.dim,
            "n_tokens": idx.resolved_n_tokens() if self.is_sharded else idx.n_tokens,
        }
        if self.is_segmented:
            geo["n_segments"] = idx.n_segments
        return geo
