"""WARP engine configurations: the port's copies of ``WarpArchConfig``,
``WarpShape``, ``WARP_SHAPES`` and ``WARP_SHAPES_REDUCED`` from
``repro/configs/warp_family.py`` (the LoTTE geometries of the paper's own
workload), and ``WarpFamily``, the family's entry in the arch registry
with the cell interface of the other families: ``shape_cell``,
``abstract_state`` (JAX's ``_index_specs``: the document-sharded index's
arrays as (shape, dtype) pairs), ``input_specs``, ``search_config``,
``step_fn`` (one search through a plan: of one index, of the one-process
stack ``ShardedWarpIndex``, or of a rank group, ``make_sharded_search_fn``
in ``core/distributed.py``) and ``smoke`` (JAX's reduced build and one
search). JAX's mesh-shaped ``state_pspec`` and ``input_pspec`` place
arrays on a TPU mesh and are not ported, as for the other families.
``synth_index`` makes an index of a cell's geometry on the device from a
seed (heavy-tailed cluster sizes, random codes), the state the cell's
step searches.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchDef, ShapeCell
from repro_torch.core.types import WarpSearchConfig

__all__ = [
    "WARP_SHAPES", "WARP_SHAPES_REDUCED", "WarpArchConfig", "WarpFamily", "WarpShape",
    "synth_cluster_sizes", "synth_index",
]


@dataclasses.dataclass(frozen=True)
class WarpArchConfig:
    dim: int = 128
    nbits: int = 4
    query_maxlen: int = 32
    nprobe: int = 32
    k: int = 100
    k_impute: int = 64


@dataclasses.dataclass(frozen=True)
class WarpShape:
    kind: str
    n_tokens: int
    n_docs: int
    n_centroids: int
    cap: int
    batch: int  # concurrent queries


WARP_SHAPES = {
    # LoTTE Lifestyle test: 23.71M tokens (paper Table 4).
    "search_lifestyle": WarpShape("serve", 23_710_000, 119_461, 1 << 17, 1024, 1),
    # LoTTE Pooled test: 660.04M tokens, 2.8M passages.
    "search_pooled": WarpShape("serve", 660_040_000, 2_819_103, 1 << 19, 2048, 1),
    # Pooled with a batch of 8 concurrent queries (throughput cell).
    "qps_pooled_b8": WarpShape("serve", 660_040_000, 2_819_103, 1 << 19, 2048, 8),
}

WARP_SHAPES_REDUCED = {
    "search_lifestyle": WarpShape("serve", 6000, 300, 64, 128, 1),
    "search_pooled": WarpShape("serve", 8000, 400, 64, 128, 1),
    "qps_pooled_b8": WarpShape("serve", 8000, 400, 64, 128, 4),
}


def _cell(arch: ArchDef, shape: str, reduced: bool) -> tuple[WarpArchConfig, WarpShape]:
    return (arch.reduced if reduced else arch.config,
            (WARP_SHAPES_REDUCED if reduced else WARP_SHAPES)[shape])


def synth_cluster_sizes(g: torch.Generator, n_clusters: int, n_tokens: int, cap: int, dev):
    """Heavy-tailed (log-normal) sizes in [1, cap] with max exactly cap and
    sum exactly n_tokens, drawn from ``g``."""
    w = torch.exp(torch.randn(n_clusters, generator=g, device=dev, dtype=torch.float64))

    def sizes_at(alpha):
        return torch.clamp(torch.round(w * alpha), 1, cap).long()

    if n_clusters * cap < n_tokens:
        raise ValueError(f"{n_clusters} clusters of at most {cap} cannot hold {n_tokens} tokens")
    lo, hi = 0.0, 4.0 * cap / float(w.mean())
    while int(sizes_at(hi).sum()) < n_tokens:
        hi *= 2.0
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if int(sizes_at(mid).sum()) < n_tokens:
            lo = mid
        else:
            hi = mid
    sizes = sizes_at(hi)
    excess = int(sizes.sum()) - n_tokens  # >= 0, small
    while excess > 0:
        room = torch.nonzero((sizes > 1) & (sizes < cap)).squeeze(1)
        if room.numel() == 0:  # every cluster at 1 or cap: keep one at cap
            full = torch.nonzero(sizes == cap).squeeze(1)
            room = full[1:]
        pick = room[torch.randperm(room.numel(), generator=g, device=dev)[:excess]]
        sizes[pick] -= 1
        excess = int(sizes.sum()) - n_tokens
    if int(sizes.max()) != cap or int(sizes.sum()) != n_tokens:
        raise RuntimeError("synthetic cluster sizes missed their max/sum targets")
    return sizes


def synth_index(cfg: WarpArchConfig, s: WarpShape, seed: int, device):
    """A ``WarpIndex`` of geometry ``s`` at ``cfg``'s dim and nbits on
    ``device``, drawn from ``seed`` there: ``synth_cluster_sizes``, unit
    random centroids, uniform random codes and doc ids, and the codec of
    N(0, 0.05^2) residuals (bucket weights at the quantiles' midpoints)."""
    from repro_torch.core.types import WarpIndex

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, nbits = cfg.dim, cfg.nbits
    n, c, cap = s.n_tokens, s.n_centroids, s.cap
    sizes = synth_cluster_sizes(g, c, n, cap, dev)
    offsets = torch.zeros(c + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    cent = torch.randn(c, d, generator=g, device=dev)
    cent = cent / cent.norm(dim=1, keepdim=True)
    codes = torch.randint(0, 256, (n, d * nbits // 8), generator=g, device=dev, dtype=torch.uint8)
    doc_ids = torch.randint(0, s.n_docs, (n,), generator=g, device=dev, dtype=torch.int32)
    nb = 1 << nbits
    quant = torch.special.ndtri((torch.arange(nb, device=dev, dtype=torch.float64) + 0.5) / nb)
    cuts = torch.special.ndtri(torch.arange(1, nb, device=dev, dtype=torch.float64) / nb)
    return WarpIndex(
        centroids=cent,
        packed_codes=codes,
        token_doc_ids=doc_ids,
        cluster_offsets=offsets.int(),
        cluster_sizes=sizes.int(),
        bucket_weights=(0.05 * quant).float(),
        bucket_cutoffs=(0.05 * cuts).float(),
        dim=d, nbits=nbits, cap=cap, n_docs=s.n_docs, n_tokens=n,
    )


class WarpFamily:
    name = "warp"

    @staticmethod
    def shape_cell(arch: ArchDef, shape: str) -> ShapeCell:
        s = WARP_SHAPES[shape]
        return ShapeCell(shape, s.kind, dataclasses.asdict(s))

    @staticmethod
    def abstract_state(arch: ArchDef, shape: str, *, reduced: bool = False,
                       n_shards: int = 1) -> dict:
        """The document-sharded index of the cell as JAX's ``_index_specs``
        shapes it, array name -> (shape, dtype): ``[n_shards, ...]``
        stacks of each shard's arrays, padded to ceil(N / S) tokens and
        C // S centroids. Nothing is allocated."""
        cfg, s = _cell(arch, shape, reduced)
        c_local = max(1, s.n_centroids // n_shards)
        n_local = -(-s.n_tokens // n_shards)
        pb = cfg.dim * cfg.nbits // 8
        f32, i32 = torch.float32, torch.int32
        return {
            "centroids": ((n_shards, c_local, cfg.dim), f32),
            "packed_codes": ((n_shards, n_local, pb), torch.uint8),
            "token_doc_ids": ((n_shards, n_local), i32),
            "cluster_offsets": ((n_shards, c_local + 1), i32),
            "cluster_sizes": ((n_shards, c_local), i32),
            "bucket_weights": ((n_shards, 1 << cfg.nbits), f32),
            "doc_start": ((n_shards,), i32),
        }

    @staticmethod
    def input_specs(arch: ArchDef, shape: str, *, reduced: bool = False) -> dict:
        """name -> (shape, dtype): one query [Q, D] and its mask, or a
        batch [B, Q, D] when the cell's batch is above 1."""
        cfg, s = _cell(arch, shape, reduced)
        qm = cfg.query_maxlen
        if s.batch > 1:
            return {"q": ((s.batch, qm, cfg.dim), torch.float32),
                    "qmask": ((s.batch, qm), torch.bool)}
        return {"q": ((qm, cfg.dim), torch.float32), "qmask": ((qm,), torch.bool)}

    @staticmethod
    def search_config(arch: ArchDef, shape: str, *, reduced: bool = False) -> WarpSearchConfig:
        """The cell's search config with ``t_prime`` and ``k_impute``
        resolved for its geometry, as JAX's family resolves them; the
        executor stays "auto": the plan picks it from the index's device
        (the kernels on the card), where JAX resolves it here."""
        cfg, s = _cell(arch, shape, reduced)
        base = WarpSearchConfig(
            nprobe=min(cfg.nprobe, max(4, s.n_centroids // 2)),
            k=min(cfg.k, s.n_docs),
            k_impute=min(cfg.k_impute, max(4, s.n_centroids // 2)),
        )
        return dataclasses.replace(
            base,
            t_prime=base.resolved_t_prime(s.n_tokens),
            k_impute=base.resolved_k_impute(max(4, s.n_centroids)),
        )

    @staticmethod
    def step_fn(arch: ArchDef, shape: str, *, reduced: bool = False):
        """``step(plan, batch) -> TopKResult``: one search of the batch's
        query (or query batch, when the cell's batch is above 1) through
        ``plan``, a ``SearchPlan`` of the cell's ``search_config`` over one
        index, the one-process stack or a rank group (called on rank 0)."""
        _, s = _cell(arch, shape, reduced)
        if s.batch > 1:
            def step(plan, batch):
                return plan.retrieve_batch(batch["q"], batch["qmask"])
        else:
            def step(plan, batch):
                return plan.retrieve(batch["q"], batch["qmask"])
        return step

    @staticmethod
    def state_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """Each array of ``abstract_state``'s stack split over the data axes
        (its leading shard axis)."""
        from repro_torch.launch.mesh import data_axes
        from repro_torch.launch.sharding import P

        axes = data_axes(mesh)
        return {name: P(axes) for name in WarpFamily.abstract_state(arch, shape)}

    @staticmethod
    def input_pspec(arch: ArchDef, shape: str, mesh) -> dict:
        """The queries replicated on every rank."""
        from repro_torch.launch.sharding import P

        if WARP_SHAPES[shape].batch > 1:
            return {"q": P(None, None, None), "qmask": P(None, None)}
        return {"q": P(None, None), "qmask": P(None)}

    @staticmethod
    def smoke(arch: ArchDef, shape: str, seed: int = 0, *, device=None, index=None) -> dict:
        """JAX's smoke on ``device`` (None: the card): the reduced cell's
        corpus (``make_corpus`` seed 0), a document-sharded build of it at
        ``IndexBuildConfig(n_centroids=C, nbits=4, kmeans_iters=2,
        seed=seed)`` with one shard per device of the run (the cards, or 1
        on the CPU), and one ``sharded_search`` of query 0 at the reduced
        ``search_config`` -> {"scores"}. ``index`` replaces the build (a
        ``ShardedWarpIndex`` of the same corpus)."""
        from repro_torch.core import IndexBuildConfig, build_sharded_index, sharded_search
        from repro_torch.core.types import resolve_device
        from repro_torch.data import make_corpus, make_queries

        dev = resolve_device(device)
        s = WARP_SHAPES_REDUCED[shape]
        corpus = make_corpus(n_docs=s.n_docs, mean_doc_len=max(4, s.n_tokens // s.n_docs), seed=0)
        if index is None:
            n_shards = torch.cuda.device_count() if dev.type == "cuda" else 1
            index = build_sharded_index(
                corpus.emb, corpus.token_doc_ids, corpus.n_docs, n_shards,
                IndexBuildConfig(n_centroids=s.n_centroids, nbits=4, kmeans_iters=2, seed=seed),
                device=dev,
            )
        q, qmask, _ = make_queries(corpus, n_queries=max(2, s.batch), seed=1)
        scfg = WarpFamily.search_config(arch, shape, reduced=True)
        res = sharded_search(index, q[0], qmask[0], scfg)
        return {"scores": res.scores}
