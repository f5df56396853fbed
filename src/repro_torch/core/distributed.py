"""Document-sharded WARP: a stack of per-shard indexes searched as one.
Counterpart of ``repro/core/distributed.py``.

The corpus is cut into contiguous, token-balanced document ranges; every
document's tokens live in one shard, so the token-level max and the
document-level sum stay inside a shard and only the final top-k merges
across shards. Imputation is aligned globally: each shard's top-kk
(centroid score, cluster size) pairs are concatenated shard-major and one
``impute_mse`` over them gives the m_i every shard scores with.

Placement: the JAX package maps the shard axis onto the devices of a
mesh (``shard_map``). The port has two placements. ``ShardedWarpIndex``
keeps the stacked ``[S, ...]`` tensors on one device and runs the
per-shard body shard by shard in one process, the single-controller
reading of ``shard_map``. ``RankedShard`` puts each shard in its own
process (a rank of a ``torch.distributed`` group, ``RankGroup``) on its
own device. Both run one body, ``ShardedSearch`` (made by
``make_sharded_search_fn``), over the shards the process holds, and differ
only in its gather: the stack lists its shards' tensors in shard order
(``gather_here``), a rank makes JAX's two ``all_gather``s collectives of
the group (``RankGroup.gather``): the top-kk (score, size) pairs before
``impute_mse`` and the ``[S * k]`` merge. So both give the same results
bit for bit on one device type. A rank reports the bytes of each
collective it runs to the step counter (``launch/cost.py``). Each shard runs
the engine's exported stages, so its scoring dispatch (and the
``engine.kernel_call`` fault site inside it) fires once per shard per
retrieve.

The reduction keys on int64 (``core/reduction.py``), so it needs no
overflow guard; a shard's local view still carries ``n_docs = local_docs
+ 1``, the id bound JAX's guard reads, which keeps stored shard views
byte-identical to JAX's.
"""

from __future__ import annotations

import dataclasses
import functools
import pickle
from typing import Any

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.core import engine
from repro_torch.core import worklist as wl
from repro_torch.core.docfilter import FilterView
from repro_torch.core.index import build_index
from repro_torch.core.reduction import TopKResult
from repro_torch.core.types import IndexBuildConfig, WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import WarpSelectOut, impute_mse, topk_lower_index_first
from repro_torch.launch import cost

__all__ = [
    "PREPASS_SLACK",
    "RankFailure",
    "RankGroup",
    "RankedShard",
    "ShardedSearch",
    "ShardedWarpIndex",
    "build_sharded_index",
    "gather_here",
    "local_index",
    "make_sharded_search_fn",
    "rank_shard",
    "resolve_sharded_config",
    "select_sharded",
    "shard_demand",
    "shard_doc_bounds",
    "shard_index",
    "sharded_probe_sizes",
    "sharded_search",
    "stack_shards",
]

SHARDED_ARRAYS = (
    "centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
    "cluster_sizes", "bucket_weights", "doc_start",
)
SHARDED_STATIC = (
    "dim", "nbits", "cap", "n_docs", "n_tokens_padded", "n_tokens_total", "local_docs",
)
_DTYPES = {
    "centroids": torch.float32,
    "packed_codes": torch.uint8,
    "token_doc_ids": torch.int32,
    "cluster_offsets": torch.int32,
    "cluster_sizes": torch.int32,
    "bucket_weights": torch.float32,
    "doc_start": torch.int32,
}

# Tiles of headroom on a sharded plan's rung (JAX's PREPASS_SLACK: its
# pre-pass re-runs stage 1 in another program). The port's pick reads the
# body's own probes, so the slack only keeps its rungs equal to JAX's.
PREPASS_SLACK = 1


@dataclasses.dataclass(frozen=True)
class ShardedWarpIndex:
    """Per-shard index arrays stacked on a leading shard axis, on one device.

    Shards are padded to one geometry: padding clusters have size 0 (their
    offset is the shard's token count), padding tokens carry doc id
    ``local_docs`` (never surfaced). ``n_tokens_padded`` is the per-shard
    CSR length, ``n_tokens_total`` the true corpus token count (what t'
    resolves from), ``local_docs`` the largest shard-local doc count.
    """

    centroids: torch.Tensor  # f32[S, C, D]
    packed_codes: torch.Tensor  # u8[S, N, PB]
    token_doc_ids: torch.Tensor  # i32[S, N] shard-local ids
    cluster_offsets: torch.Tensor  # i32[S, C + 1]
    cluster_sizes: torch.Tensor  # i32[S, C]
    bucket_weights: torch.Tensor  # f32[S, 2^b]
    doc_start: torch.Tensor  # i32[S] global id of each shard's first doc

    dim: int = 128
    nbits: int = 4
    cap: int = 0
    n_docs: int = 0
    n_tokens_padded: int = 0
    n_tokens_total: int = 0
    local_docs: int = 0

    @property
    def n_shards(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.packed_codes.device

    def resolved_n_tokens(self) -> int:
        """The true corpus token count (the padded estimate for stacks
        without one)."""
        return self.n_tokens_total or self.n_tokens_padded * self.n_shards

    @functools.cached_property
    def shards(self) -> tuple[WarpIndex, ...]:
        """Each shard as a plain ``WarpIndex`` of views into the stack
        (``local_index``), made once."""
        cutoffs = torch.zeros((1 << self.nbits) - 1, dtype=torch.float32, device=self.device)
        return tuple(
            WarpIndex(
                centroids=self.centroids[s],
                packed_codes=self.packed_codes[s],
                token_doc_ids=self.token_doc_ids[s],
                cluster_offsets=self.cluster_offsets[s],
                cluster_sizes=self.cluster_sizes[s],
                bucket_weights=self.bucket_weights[s],
                bucket_cutoffs=cutoffs,
                dim=self.dim,
                nbits=self.nbits,
                cap=self.cap,
                n_docs=self.local_docs + 1,
                n_tokens=self.n_tokens_padded,
            )
            for s in range(self.n_shards)
        )

    def nbytes(self) -> int:
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size() for f in SHARDED_ARRAYS
        )

    def to(self, device) -> "ShardedWarpIndex":
        device = torch.device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in SHARDED_ARRAYS}
        )

    @classmethod
    def from_arrays(cls, src: Any, *, device) -> "ShardedWarpIndex":
        """From any object or dict with the stacked array fields
        (numpy-convertible: memmaps, a JAX ``ShardedWarpIndex``'s arrays)
        and the static fields; values are kept exactly."""
        get = src.get if isinstance(src, dict) else lambda k: getattr(src, k)
        device = torch.device(device)
        arrays = {}
        for f in SHARDED_ARRAYS:
            a = np.asarray(get(f))
            if not a.flags.writeable:
                a = a.copy()
            arrays[f] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=_DTYPES[f]
            )
        return cls(**arrays, **{k: int(get(k)) for k in SHARDED_STATIC})


def is_sharded_like(src) -> bool:
    """Whether ``src`` (an index object or a dict of arrays) is a sharded
    stack: it carries ``doc_start``."""
    if isinstance(src, dict):
        return "doc_start" in src
    return hasattr(src, "doc_start")


def local_index(sidx: ShardedWarpIndex, s: int) -> WarpIndex:
    """Shard ``s`` as a plain ``WarpIndex`` of views into the stack, so the
    engine's stages apply: shard-local doc ids bounded by ``local_docs +
    1`` (the padding id included), the padded token count, zero cutoffs
    (the stack keeps no encoder tables)."""
    return sidx.shards[s]


# ---------------------------------------------------------------------------
# one shard per rank
# ---------------------------------------------------------------------------


class RankFailure(RuntimeError):
    """A step of a collective operation failed on some ranks of a
    ``RankGroup``; every rank raises it, with the same message."""


def _outcome(err: BaseException | None) -> str | None:
    return None if err is None else f"{type(err).__name__}: {err}"


class RankGroup:
    """This process's rank in the default ``torch.distributed`` group of
    document-shard ranks: rank r holds shard r on ``device``, rank 0 leads.

    Collectives move host tensors under gloo and the card's under NCCL
    (``comm_device``). Every collective operation is entered by every rank
    in the same order: rank 0 broadcasts each one (``lead``) and the other
    ranks run it from ``repro_torch.serving.follow``. Objects made by a
    collective operation (ranked retrievers, their plans) are numbered in
    creation order, the same on every rank, so a command names them by
    number. A local step that raises does not leave the other ranks waiting:
    the rank still enters the collective with a failure flag, and after it
    every rank raises (``settle``, ``gather``). ``settled`` is the last
    exception raised that way, the same failure on every rank; a follower
    goes on after it, and ends on any other."""

    def __init__(self, rank: int, size: int, backend: str, device):
        self.rank, self.size, self.backend = int(rank), int(size), backend
        self.device = torch.device(device)
        self.comm_device = self.device if backend == "nccl" else torch.device("cpu")
        self.following = False
        self.settled: BaseException | None = None
        self._objects: dict[int, Any] = {}
        self._next_id = 0

    def __repr__(self) -> str:
        return f"RankGroup(rank={self.rank}, size={self.size}, {self.backend}, {self.device})"

    def mesh(self, shape: tuple[int, ...], axes: tuple[str, ...] = ("data", "model")):
        """A ``RankMesh`` of ``shape`` over this world's ranks, for SPMD
        steps in which every rank runs (``launch/ranks.py::run_mesh``).
        Collective: every rank makes it, meshes in one order."""
        from repro_torch.launch.mesh import make_mesh

        return make_mesh(shape, axes, self)

    # ---- numbered objects ----
    def register(self, obj) -> int:
        oid, self._next_id = self._next_id, self._next_id + 1
        self._objects[oid] = obj
        return oid

    def lookup(self, oid: int):
        return self._objects[oid]

    def release(self, oids) -> None:
        for oid in oids:
            self._objects.pop(oid, None)

    # ---- commands ----
    def _count(self, op: str, nbytes) -> None:
        """Report one collective to the step counter (``launch/cost.py``):
        ``nbytes()`` is its operand's bytes (the gathered output's for an
        all-gather). A group of one moves nothing."""
        if self.size > 1 and cost.active() is not None:
            cost.collective(op, nbytes(), self.size)

    def _broadcast(self, obj):
        box = [obj]
        tdist.broadcast_object_list(box, src=0, device=self.comm_device)
        self._count("broadcast", lambda: len(pickle.dumps(box[0])))
        return box[0]

    def lead(self, *cmd) -> None:
        """Rank 0: broadcast one collective operation to the followers.
        Elsewhere it may only run inside the follower loop, which received
        the command already."""
        if self.rank == 0:
            if cmd[0] == "call" and cmd[1] not in self._objects:
                raise ValueError(
                    f"object {cmd[1]} of {self} was closed (a ranked retriever after "
                    "close() or a reload, or one of its plans)"
                )
            self._broadcast(cmd)
        elif not self.following:
            raise RuntimeError(
                f"rank {self.rank} follows rank 0: collective operations start on rank 0, "
                "and the other ranks run them in repro_torch.serving.follow(group)"
            )

    def receive(self):
        """A follower: the next command rank 0 broadcasts."""
        return self._broadcast(None)

    def stop(self) -> None:
        """Rank 0: end the followers' loops."""
        self.lead("stop")

    # ---- outcomes ----
    def settle(self, stage: str, err: BaseException | None, value=None) -> list:
        """Exchange every rank's outcome of a local step (and a picklable
        ``value``) and raise on every rank if any failed: each rank's own
        exception where all failed alike (an invalid plan), else
        ``RankFailure`` naming the ranks. Returns the values in rank
        order."""
        got = self.all_gather_object((_outcome(err), value))
        self._raise(stage, err, [o for o, _ in got])
        return [v for _, v in got]

    def fail(self, exc: BaseException):
        """Raise ``exc``, which every rank raises alike after a collective
        (a check of settled values), as a settled failure."""
        self.settled = exc
        raise exc

    def _raise(self, stage: str, err, outcomes) -> None:
        failed = [(r, o) for r, o in enumerate(outcomes) if o is not None]
        if not failed:
            return
        if err is not None and len(failed) == self.size and len({o for _, o in failed}) == 1:
            self.fail(err)
        exc = RankFailure(
            f"{stage} failed on rank " + "; ".join(f"{r} ({o})" for r, o in failed)
        )
        exc.__cause__ = err
        self.fail(exc)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        tdist.all_gather_object(out, obj)
        self._count("all-gather", lambda: sum(len(pickle.dumps(o)) for o in out))
        return out

    def gather(self, stage: str, err, parts, heads):
        """``ShardedSearch``'s gather on a rank: one all-gather of this
        rank's tensors (``parts``, one tuple for its one shard, the same
        shapes and dtypes on every rank) and integer (``heads``, one), in
        rank order, behind a failure flag. The tensors travel as their
        bytes, packed in one buffer. A rank whose local step raised
        (``err``) sends zeros of the same shapes. Returns ``([S tensors on
        this rank's device] per tensor, [head per rank])``; raises on every
        rank as ``settle`` does when any rank failed."""
        (tensors,), (head,) = parts, heads
        dev = self.comm_device
        header = torch.tensor([int(err is not None), int(head)], dtype=torch.int64)
        flat = [header.view(torch.uint8).to(dev)]
        for t in tensors:
            flat.append(t.to(dev).reshape(-1).view(torch.uint8))
        buf = torch.cat(flat)
        rows = [torch.empty_like(buf) for _ in range(self.size)]
        tdist.all_gather(rows, buf)
        self._count("all-gather", lambda: self.size * buf.numel())
        got = torch.stack(rows)
        flags = got[:, :16].cpu().contiguous().view(torch.int64).tolist()
        if any(f for f, _ in flags):
            self._raise(stage, err, self.all_gather_object(_outcome(err)))
        out, off = [], 16
        for t in tensors:
            n = t.numel() * t.element_size()
            block = got[:, off: off + n].to(self.device).contiguous().view(t.dtype)
            off += n
            out.append(list(block.reshape(self.size, *t.shape).unbind(0)))
        return out, [h for _, h in flags]


@dataclasses.dataclass(frozen=True, eq=False)
class RankedShard:
    """One rank's shard of a document-sharded index, on the rank's device.

    ``local`` is shard ``rank`` at the stack's padded geometry, exactly
    ``ShardedWarpIndex.shards[rank]``: shard-local doc ids with padding id
    ``local_docs``, ``n_docs = local_docs + 1``, padding clusters of size 0,
    ``n_tokens_padded`` rows, the global ``cap``. Beside it the stack's
    statics, this shard's ``doc_start``, and every shard's cluster sizes
    ``[S, C]`` on the host (the ragged bound is the worst shard's). The
    other shards' codes are never read."""

    local: WarpIndex
    group: RankGroup
    doc_start: int
    shard_cluster_sizes: np.ndarray  # i32[S, C]
    n_docs: int
    n_tokens_padded: int
    n_tokens_total: int
    local_docs: int

    @property
    def n_shards(self) -> int:
        return self.shard_cluster_sizes.shape[0]

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def n_centroids(self) -> int:
        return self.local.n_centroids

    @property
    def cap(self) -> int:
        return self.local.cap

    @property
    def nbits(self) -> int:
        return self.local.nbits

    @property
    def dim(self) -> int:
        return self.local.dim

    @property
    def device(self) -> torch.device:
        return self.local.device

    def resolved_n_tokens(self) -> int:
        return self.n_tokens_total or self.n_tokens_padded * self.n_shards

    def nbytes(self) -> int:
        """Bytes this rank holds on its device."""
        return self.local.nbytes()


# ---------------------------------------------------------------------------
# building and stacking
# ---------------------------------------------------------------------------


def shard_doc_bounds(token_doc_ids, n_docs: int, n_shards: int) -> np.ndarray:
    """i64[S + 1] contiguous doc ranges holding about equal token counts:
    the cuts are ``searchsorted`` of the token cumsum at ``linspace`` targets,
    then made strictly increasing and clamped to ``n_docs`` (JAX's rule)."""
    tdi = np.asarray(token_doc_ids).reshape(-1)
    n_tokens = tdi.shape[0]
    csum = np.concatenate([[0], np.cumsum(np.bincount(tdi, minlength=n_docs))])
    targets = np.linspace(0, n_tokens, n_shards + 1)
    cuts = np.searchsorted(csum, targets[1:-1], side="left")
    bounds = np.concatenate([[0], cuts, [n_docs]]).astype(np.int64)
    for s in range(1, n_shards + 1):
        bounds[s] = max(bounds[s], bounds[s - 1] + 1)
    bounds = np.minimum(bounds, n_docs)
    bounds[-1] = n_docs
    return bounds


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_sharded_index(
    embeddings,
    token_doc_ids,
    n_docs: int,
    n_shards: int,
    config: IndexBuildConfig = IndexBuildConfig(),
    *,
    device=None,
) -> ShardedWarpIndex:
    """Cut the corpus into ``shard_doc_bounds`` ranges, build each shard
    with ``build_index`` (seed ``config.seed + s``, its own centroids and
    codec) on ``device`` (None -> the card), pad and stack."""
    device = resolve_device(device)
    emb = np.asarray(_host(embeddings), np.float32)
    tdi = np.asarray(_host(token_doc_ids), np.int32)
    bounds = shard_doc_bounds(tdi, n_docs, n_shards)
    shards = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        sel = (tdi >= lo) & (tdi < hi)
        sub_cfg = dataclasses.replace(config, seed=config.seed + s)
        shards.append(build_index(emb[sel], tdi[sel] - lo, max(1, hi - lo), sub_cfg, device=device))
    return stack_shards(shards, bounds[:-1], n_docs, emb.shape[0])


def _pad_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    pad = rows - t.shape[0]
    if pad == 0:
        return t
    return torch.cat([t, t.new_full((pad, *t.shape[1:]), fill)])


def stack_shards(shards, doc_start, n_docs: int, n_tokens_total: int) -> ShardedWarpIndex:
    """Pad per-shard ``WarpIndex``es (one device) to a common geometry and
    stack them; ``doc_start[s]`` is shard ``s``'s first global doc id."""
    c_max = max(s.n_centroids for s in shards)
    n_max = max(s.n_tokens for s in shards)
    local_docs = max(s.n_docs for s in shards)
    dev = shards[0].device
    return ShardedWarpIndex(
        centroids=torch.stack([_pad_rows(s.centroids, c_max, 0.0) for s in shards]),
        packed_codes=torch.stack([_pad_rows(s.packed_codes, n_max, 0) for s in shards]),
        token_doc_ids=torch.stack([_pad_rows(s.token_doc_ids, n_max, local_docs) for s in shards]),
        cluster_offsets=torch.stack(
            [_pad_rows(s.cluster_offsets, c_max + 1, s.n_tokens) for s in shards]
        ),
        cluster_sizes=torch.stack([_pad_rows(s.cluster_sizes, c_max, 0) for s in shards]),
        bucket_weights=torch.stack([s.bucket_weights for s in shards]),
        doc_start=torch.as_tensor(
            np.asarray(_host(doc_start))[: len(shards)], dtype=torch.int32
        ).to(dev),
        dim=shards[0].dim,
        nbits=shards[0].nbits,
        cap=max(s.cap for s in shards),
        n_docs=int(n_docs),
        n_tokens_padded=int(n_max),
        n_tokens_total=int(n_tokens_total),
        local_docs=int(local_docs),
    )


def shard_index(index: WarpIndex, n_shards: int) -> ShardedWarpIndex:
    """Cut a built index into ``shard_doc_bounds`` document ranges that
    keep its centroids and codec (shared by every shard): each shard's CSR
    holds its documents' rows in the index's order. With shared centroids
    the sharded search returns what the single index's does (same probes,
    the same merged m_i, a document's tokens in one shard)."""
    tdi = index.token_doc_ids
    dev = index.device
    bounds = shard_doc_bounds(tdi.cpu().numpy(), index.n_docs, n_shards)
    owner = torch.bucketize(tdi.long(), torch.from_numpy(bounds[1:-1]).to(dev), right=True)
    cluster_of = torch.repeat_interleave(
        torch.arange(index.n_centroids, device=dev), index.cluster_sizes.long()
    )
    shards = []
    for s in range(n_shards):
        rows = torch.nonzero(owner == s).squeeze(1)
        sizes = torch.bincount(cluster_of[rows], minlength=index.n_centroids)
        offsets = torch.zeros(index.n_centroids + 1, dtype=torch.long, device=dev)
        offsets[1:] = torch.cumsum(sizes, 0)
        shards.append(dataclasses.replace(
            index,
            packed_codes=index.packed_codes[rows],
            token_doc_ids=(tdi[rows] - int(bounds[s])).to(torch.int32),
            cluster_offsets=offsets.to(torch.int32),
            cluster_sizes=sizes.to(torch.int32),
            cap=int(sizes.max()) if sizes.numel() else 0,
            n_docs=max(1, int(bounds[s + 1] - bounds[s])),
            n_tokens=int(rows.numel()),
        ))
    return stack_shards(shards, bounds[:-1], index.n_docs, index.n_tokens)


def rank_shard(index: WarpIndex, group: RankGroup) -> RankedShard:
    """Rank ``group.rank``'s shard of ``index``, cut as ``shard_index``
    cuts it into ``group.size`` shards (shared centroids and codec) but
    made on this rank alone: ``local`` equals ``shard_index(index,
    group.size).shards[group.rank]``, and no other shard's rows are
    gathered (every shard's cluster sizes are counted). With one rank the
    shard keeps the index's own arrays."""
    n_shards, r = group.size, group.rank
    tdi, dev, c = index.token_doc_ids, index.device, index.n_centroids
    bounds = shard_doc_bounds(tdi.cpu().numpy(), index.n_docs, n_shards)
    owner = torch.bucketize(tdi.long(), torch.from_numpy(bounds[1:-1]).to(dev), right=True)
    cluster_of = torch.repeat_interleave(torch.arange(c, device=dev), index.cluster_sizes.long())
    sizes = torch.stack([torch.bincount(cluster_of[owner == s], minlength=c)
                         for s in range(n_shards)])
    n_max = int(sizes.sum(1).max())
    local_docs = int(max(max(1, int(bounds[s + 1] - bounds[s])) for s in range(n_shards)))
    if n_shards == 1:
        codes, docs = index.packed_codes, tdi
    else:
        rows = torch.nonzero(owner == r).squeeze(1)
        codes = _pad_rows(index.packed_codes[rows], n_max, 0)
        docs = _pad_rows((tdi[rows] - int(bounds[r])).to(torch.int32), n_max, local_docs)
    offsets = torch.zeros(c + 1, dtype=torch.long, device=dev)
    offsets[1:] = torch.cumsum(sizes[r], 0)
    local = WarpIndex(
        centroids=index.centroids,
        packed_codes=codes,
        token_doc_ids=docs,
        cluster_offsets=offsets.to(torch.int32),
        cluster_sizes=sizes[r].to(torch.int32),
        bucket_weights=index.bucket_weights,
        bucket_cutoffs=torch.zeros((1 << index.nbits) - 1, dtype=torch.float32, device=dev),
        dim=index.dim,
        nbits=index.nbits,
        cap=int(sizes.max()),
        n_docs=local_docs + 1,
        n_tokens=n_max,
    )
    return RankedShard(
        local=local, group=group, doc_start=int(bounds[r]),
        shard_cluster_sizes=sizes.cpu().numpy().astype(np.int32), n_docs=index.n_docs,
        n_tokens_padded=n_max, n_tokens_total=index.n_tokens, local_docs=local_docs,
    )


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def resolve_sharded_config(sidx, config: WarpSearchConfig) -> WarpSearchConfig:
    """``engine.resolve_config`` for a stack or one rank's shard: t' from
    the true token count, k_impute from the per-shard (padded) centroid
    count, the executor against the device, and the ragged bound from the
    worst shard (every shard runs at one bound, as JAX's one program does;
    a rank reads every shard's sizes from ``shard_cluster_sizes``)."""
    n_tokens = sidx.resolved_n_tokens()
    if n_tokens == 0:
        raise ValueError(
            "sharded index has n_tokens == 0 — nothing to retrieve. Build "
            "or load a non-empty index before planning a search."
        )
    on_cuda = sidx.device.type == "cuda"
    executor = config.resolved_executor(on_cuda)
    if executor == "kernel" and not on_cuda:
        raise ValueError(
            f"executor='kernel' runs the CUDA kernels, but the index is on "
            f"{sidx.device}; load it with device='cuda', or plan "
            "executor='reference' (or 'auto') on the CPU"
        )
    config = dataclasses.replace(
        config,
        t_prime=config.resolved_t_prime(n_tokens),
        k_impute=config.resolved_k_impute(sidx.n_centroids),
        executor=executor,
    )
    sizes = (
        sidx.shard_cluster_sizes if isinstance(sidx, RankedShard)
        else sidx.cluster_sizes.cpu().numpy()
    )
    return engine.resolve_layout_fields(
        config, sizes, sidx.cap,
        n_tokens=n_tokens, nbits=sidx.nbits, dim=sidx.dim, device=sidx.device,
    )


def select_sharded(sidx: ShardedWarpIndex, q, qmask, config) -> list[WarpSelectOut]:
    """Stage 1 on every shard: WARP_SELECT of [B, Q, D] queries against
    each shard's centroids and cluster sizes."""
    return [engine.select_probes(shard, q, qmask, config) for shard in sidx.shards]


def sharded_probe_sizes(sidx: ShardedWarpIndex, q, qmask, config):
    """(probe_sizes, probe_cids), each i64[S, B, Q, nprobe]: the per-shard
    WARP_SELECT probes the adaptive dispatcher reads its one bucket from."""
    sels = select_sharded(sidx, q, qmask, config)
    return (
        torch.stack([s.probe_sizes for s in sels]),
        torch.stack([s.probe_cids for s in sels]),
    )


def gather_here(stage: str, err, parts, heads):
    """``ShardedSearch``'s gather when every shard runs in this process
    (the stack): a failure raises at once, and ``parts`` (one tuple of
    tensors per shard) are already in shard order."""
    if err is not None:
        raise err
    return [list(t) for t in zip(*parts)], list(heads)


@dataclasses.dataclass(frozen=True)
class ShardedSearch:
    """The per-shard body of a document-sharded search over the shards
    this process runs: every shard of a stack (``gather=gather_here``) or
    this rank's one (``gather=RankGroup.gather``, the collective). Called
    with queries ``[B, Q, D]`` and their mask, the same on every rank.

    1. WARP_SELECT on each local shard; the gather of their top-kk (score,
       size) pairs, concatenated shard-major (JAX's all_gather order),
       gives the one global m_i.
    2. On an adaptive plan (``need``: a shard's worklist demand from its
       probes) the same gather carries each shard's demand: the largest,
       plus ``PREPASS_SLACK``, picks the rung every shard runs, as
       ``needed_worklist_tiles`` takes the max over JAX's stacked shards.
    3. ``score_and_reduce`` per shard with the global m_i and its filter
       view; local ids ``+ doc_start`` (-1 stays); the gather of the
       ``[B, k]`` results and the top-k of their shard-major
       concatenation, ties toward the earlier shard as ``lax.top_k``
       breaks them.

    The queries may lie on the host: they move to the shards' device
    inside the first local step (``to_device``). A rank whose local step
    raises still enters the gather, and then every rank raises."""

    shards: tuple[WarpIndex, ...]
    starts: tuple[int, ...]
    config: WarpSearchConfig
    gather: Any
    fvs: tuple[FilterView, ...] | None = None
    need: Any = None

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    def to_device(self, q, qmask):
        return q.to(self.device), qmask.to(self.device)

    def bucket(self, q, qmask) -> int:
        """The rung an adaptive plan runs ``q`` at: WARP_SELECT on each
        local shard and the gather of the shards' demands."""
        err, needed = None, [0] * len(self.shards)
        try:
            q, qmask = self.to_device(q, qmask)
            needed = [
                self.need(i, engine.select_probes(sh, q, qmask, self.config), qmask)
                for i, sh in enumerate(self.shards)
            ]
        except Exception as e:  # every rank raises after the gather
            err = e
        _, demand = self.gather("warp_select", err, [()] * len(self.shards), needed)
        return wl.pick_bucket(self.config.worklist_buckets, max(demand) + PREPASS_SLACK)

    def __call__(self, q, qmask, bucket: int | None = None) -> TopKResult:
        config, n = self.config, len(self.shards)
        b, qm = q.shape[:2]
        kk = max(config.nprobe, config.k_impute)
        dev = self.device
        err, sels, needed = None, [], [0] * n
        try:
            q, qmask = self.to_device(q, qmask)
            sels = [engine.select_probes(sh, q, qmask, config) for sh in self.shards]
            if self.need is not None and bucket is None:
                needed = [self.need(i, sel, qmask) for i, sel in enumerate(sels)]
            # Sizes travel as int32 (a cluster's size fits).
            parts = [(s.top_scores, s.top_sizes.to(torch.int32)) for s in sels]
        except Exception as e:  # every rank raises after the gather
            err = e
            parts = [(torch.zeros((b, qm, kk), device=dev),
                      torch.zeros((b, qm, kk), dtype=torch.int32, device=dev))] * n
        (g_scores, g_sizes), demand = self.gather("warp_select", err, parts, needed)
        err = None
        try:
            mse = impute_mse(
                torch.cat(g_scores, dim=-1), torch.cat(g_sizes, dim=-1).long(),
                config.t_prime, qmask,
            )
            cfg = config
            if self.need is not None:
                if bucket is None:
                    bucket = wl.pick_bucket(config.worklist_buckets, max(demand) + PREPASS_SLACK)
                cfg = dataclasses.replace(config, worklist_tiles=bucket, worklist_buckets=None)
            parts = []
            for i, (sh, sel) in enumerate(zip(self.shards, sels)):
                top = engine.score_and_reduce(
                    sh, q, qmask, sel.probe_scores, sel.probe_cids, mse, cfg,
                    probe_sizes=sel.probe_sizes,
                    dfilter=None if self.fvs is None else self.fvs[i],
                )
                ids = torch.where(top.doc_ids >= 0, top.doc_ids + self.starts[i], -1)
                parts.append((top.scores, ids.to(torch.int32)))
        except Exception as e:  # every rank raises after the gather
            err = e
            parts = [(torch.zeros((b, config.k), device=dev),
                      torch.zeros((b, config.k), dtype=torch.int32, device=dev))] * n
        (scores, docs), _ = self.gather("score_and_reduce", err, parts, [0] * n)
        top_scores, idx = topk_lower_index_first(torch.cat(scores, dim=-1), config.k)
        return TopKResult(top_scores, torch.gather(torch.cat(docs, dim=-1), -1, idx))


def shard_demand(config: WarpSearchConfig, cap: int, lives=None):
    """``ShardedSearch.need`` for an adaptive plan: local shard i's worklist
    tiles from its probes; masked tokens and, with ``lives`` (bool[C] per
    local shard), filtered-out clusters build none."""
    from repro_torch.kernels import ops

    tile = ops.resolve_tile_c(cap, config.tile_c, layout="ragged")

    def need(i: int, sel, qmask) -> int:
        sizes = sel.probe_sizes.cpu().numpy()
        if lives is not None:
            sizes = wl.filtered_probe_sizes(sizes, sel.probe_cids.cpu().numpy(), lives[i])
        tiles = wl.probe_tile_counts(sizes, tile) * qmask.cpu().numpy()[..., None]
        return wl.needed_worklist_tiles(tiles, amortized=config.memory == "full")

    return need


def make_sharded_search_fn(
    index, config: WarpSearchConfig, *, fv: FilterView | None = None, adaptive: bool = False
) -> ShardedSearch:
    """The per-shard body for ``index``, the counterpart of JAX's
    ``make_sharded_search_fn``: on a ``ShardedWarpIndex`` every shard runs
    here, on a ``RankedShard`` its ``RankGroup`` takes the place of the
    mesh and every rank calls the body on the same queries. ``fv`` is the
    plan's resolved filter (``docfilter.resolve_sharded``'s stacked view,
    or ``resolve_rank``'s); ``adaptive`` plans pick their rung from the
    shards' demand."""
    if isinstance(index, RankedShard):
        shards, starts, gather = (index.local,), (index.doc_start,), index.group.gather
        fvs = None if fv is None else (fv,)
    else:
        shards, starts, gather = index.shards, tuple(index.doc_start.tolist()), gather_here
        fvs = None if fv is None else tuple(
            FilterView(fv.doc_mask[s], fv.cluster_live[s]) for s in range(index.n_shards)
        )
    need = None
    if adaptive:
        lives = None if fvs is None else [f.cluster_live.cpu().numpy() for f in fvs]
        need = shard_demand(config, index.cap, lives)
    return ShardedSearch(shards, starts, config, gather, fvs, need)


def sharded_search(
    sidx: ShardedWarpIndex, q, qmask=None, config: WarpSearchConfig = WarpSearchConfig(),
    *, dfilter=None,
) -> TopKResult:
    """One-shot sharded search of one query q f32[Q, D] at the static
    worklist bound; ``dfilter`` is a ``DocFilter`` over global ids or a
    stacked ``FilterView``. Equivalent to ``Retriever.from_index(sidx)``
    with a non-adaptive plan."""
    from repro_torch.core.docfilter import DocFilter, resolve_sharded

    config = resolve_sharded_config(sidx, config)
    q = torch.as_tensor(q, dtype=torch.float32, device=sidx.device)
    if qmask is None:
        qmask = torch.ones(q.shape[:1], dtype=torch.bool, device=sidx.device)
    qmask = torch.as_tensor(qmask, dtype=torch.bool, device=sidx.device)
    fv = dfilter
    if isinstance(dfilter, DocFilter):
        if dfilter.n_docs != sidx.n_docs:
            raise ValueError(
                f"DocFilter covers {dfilter.n_docs} docs but the sharded index holds {sidx.n_docs}"
            )
        fv = resolve_sharded(dfilter, sidx)
    res = make_sharded_search_fn(sidx, config, fv=fv)(q[None], qmask[None])
    return TopKResult(res.scores[0], res.doc_ids[0])
