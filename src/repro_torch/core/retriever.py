"""``Retriever`` facade: plan once, retrieve many. Counterpart of
``repro/core/retriever.py`` for single-index (local) retrieval.

  from_index / from_store   adopt an index (a ``WarpIndex``, a JAX
                            ``WarpIndex``, or a dict of its arrays) or a
                            saved store, onto ``device`` (None -> "cuda")
  plan(config)              validate against the index geometry, resolve
                            every data-dependent default -> ``SearchPlan``
  retrieve / retrieve_batch one query [Q, D] / a batch [B, Q, D]

Ragged plans are query-adaptive as in the JAX package: WARP_SELECT runs
once, the probe sizes come to the host (the one sync of the adaptive
pick), and stages 2+3 run at the smallest ladder rung that fits the
query's — or the batch's — real tile demand. There is no executor
fallback: a kernel failure raises.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core import worklist as wl
from repro_torch.core.reduction import TopKResult
from repro_torch.core.types import WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.kernels import ops

__all__ = ["Retriever", "SearchPlan"]


def _is_adaptive(cfg: WarpSearchConfig) -> bool:
    return (
        cfg.layout == "ragged"
        and cfg.worklist_buckets is not None
        and len(cfg.worklist_buckets) > 1
    )


class SearchPlan:
    """A validated pipeline bound to one index and one resolved config
    (``t_prime``/``k_impute`` concrete, ``executor`` "kernel" or
    "reference", layout/tile/worklist fields resolved)."""

    def __init__(self, index: WarpIndex, config: WarpSearchConfig, geometry: dict):
        self.config = config
        self.index = index
        self.n_shards = 1
        self.backend = index.device.type
        self.index_geometry = geometry
        self.adaptive = _is_adaptive(config)
        self._tile = ops.resolve_tile_c(index.cap, config.tile_c, layout="ragged")

    # ---- inputs ----
    def _tensor(self, x, dtype) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        return x.to(device=self.index.device, dtype=dtype)

    def _inputs(self, q, qmask, lead: int):
        q = self._tensor(q, torch.float32)
        if qmask is None:
            qmask = torch.ones(q.shape[:lead], dtype=torch.bool, device=q.device)
        return q, self._tensor(qmask, torch.bool)

    # ---- dispatch ----
    def retrieve(self, q, qmask=None) -> TopKResult:
        """One query q f32[Q, D] -> (scores f32[k], doc_ids i32[k])."""
        q, qmask = self._inputs(q, qmask, 1)
        res = self._run(q[None], qmask[None])
        return TopKResult(res.scores[0], res.doc_ids[0])

    def retrieve_batch(self, q, qmask=None) -> TopKResult:
        """Query batch q f32[B, Q, D] -> TopKResult with leading batch dim;
        an adaptive plan runs the whole batch at one rung (the max)."""
        q, qmask = self._inputs(q, qmask, 2)
        return self._run(q, qmask)

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
        return self._run(q, qmask, bucket=bucket)

    def adaptive_bucket(self, q, qmask=None) -> int | None:
        """The rung the adaptive dispatcher would run this single query
        (q f32[Q, D]) at; None on non-adaptive plans."""
        if not self.adaptive:
            return None
        q, qmask = self._inputs(q, qmask, 1)
        sel = engine.select_probes(self.index, q[None], qmask[None], self.config)
        return self._pick(sel, qmask[None])

    def _pick(self, sel, qmask) -> int:
        """Smallest rung fitting the masked probe tile demand: masked
        tokens build no tiles (``engine.score_candidates``). Needs the
        probe sizes on the host — the adaptive path's one sync."""
        sizes = sel.probe_sizes.cpu().numpy()
        m = qmask.cpu().numpy()
        tiles = wl.probe_tile_counts(sizes, self._tile) * m[..., None]
        needed = wl.needed_worklist_tiles(tiles, amortized=self.config.memory == "full")
        return wl.pick_bucket(self.config.worklist_buckets, needed)

    def _run(self, q, qmask, bucket: int | None = None) -> TopKResult:
        cfg = self.config
        sel = engine.select_probes(self.index, q, qmask, cfg)
        if self.adaptive:
            if bucket is None:
                bucket = self._pick(sel, qmask)
            cfg = dataclasses.replace(cfg, worklist_tiles=bucket, worklist_buckets=None)
        return engine.finish_from_probes(self.index, q, qmask, sel, cfg)

    # ---- snapshot ----
    def describe(self) -> dict:
        """Every resolved pipeline choice (JSON-serializable), with the
        same keys as the JAX plan's snapshot apart from its ``k_ladder``
        (the k-ladder is not ported)."""
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
        mean_cluster = geo["n_tokens"] / max(1, geo["n_centroids"])
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
            "k_impute": cfg.k_impute,
            "n_shards": self.n_shards,
            "backend": self.backend,
            "filter": None,  # document filters are not ported
            **geo,
        }


class Retriever:
    """Facade over the port's WARP engine: adopt an index, plan, retrieve.

    >>> r = Retriever.from_store(path)              # on the card
    >>> plan = r.plan(WarpSearchConfig(gather="fused", layout="ragged"))
    >>> res = plan.retrieve(q, qmask)
    """

    def __init__(self, index: WarpIndex):
        if not isinstance(index, WarpIndex):
            raise TypeError(
                f"Retriever wraps a repro_torch WarpIndex, got "
                f"{type(index).__name__}; use Retriever.from_index"
            )
        self.index = index
        self._plans: dict = {}

    @classmethod
    def from_index(cls, index, *, device=None) -> "Retriever":
        """Adopt ``index`` on ``device`` (None -> "cuda", raising when CUDA
        is absent; pass ``device="cpu"`` for the CPU). ``index`` is a
        ``WarpIndex`` of this package, or anything
        ``WarpIndex.from_arrays`` takes (e.g. a JAX ``WarpIndex``)."""
        device = resolve_device(device)
        if isinstance(index, WarpIndex):
            return cls(index.to(device))
        return cls(WarpIndex.from_arrays(index, device=device))

    @classmethod
    def from_store(cls, path: str, *, device=None) -> "Retriever":
        """Adopt a saved single-index store (``repro_torch.store``)."""
        from repro_torch.store import load_index

        return cls(load_index(path, device=device))

    @property
    def device(self) -> torch.device:
        return self.index.device

    @property
    def n_docs(self) -> int:
        return self.index.n_docs

    def plan(self, config: WarpSearchConfig = WarpSearchConfig()) -> SearchPlan:
        """Validate and resolve ``config``; cached per config. Raises
        ValueError on an unsatisfiable config."""
        cached = self._plans.get(config)
        if cached is not None:
            return cached
        resolved = engine.resolve_config(self.index, config)
        self._validate(resolved)
        plan = SearchPlan(self.index, resolved, self._geometry())
        self._plans[config] = plan
        self._plans[resolved] = plan
        return plan

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
        return {
            "n_docs": idx.n_docs,
            "n_centroids": idx.n_centroids,
            "cap": idx.cap,
            "nbits": idx.nbits,
            "dim": idx.dim,
            "n_tokens": idx.n_tokens,
        }
