"""Delta segments: append-only index updates against a frozen base, their
deletes, their search and their compaction. Counterpart of
``repro/store/segments.py`` (see its docstring for why search over base +
deltas is exact).

``add_documents`` quantizes new documents with the base's frozen
centroids and codec on the device into a small CSR-by-cluster segment
over the same centroid space, written as ``segments/seg_NNNNN/``. Search
runs one WARP_SELECT over the base centroids with the COMBINED cluster
sizes (one t' crossing, one m_i), then stages 2+3 in the plan's layout:

- ``layout="dense"``: ``engine.score_and_reduce`` per segment (each
  padded to its own cap, the existing kernels once per segment), and a
  top-k over the per-segment top-k lists with doc-id offsets;
- ``layout="ragged"``: ONE worklist over every segment (each probed
  cluster expands into its per-segment runs, each tile tagged with its
  segment), scored by ONE launch of the segmented ragged kernel
  (gather="fused"), or gathered into one flat copy and scored by the
  single-array ragged kernel (gather="materialize"); doc ids become
  global per slot and one ``two_stage_reduce`` replaces the merge.

Deletes are tombstones (``tombstones.json``) until ``compact`` folds the
deltas into a fresh base without the deleted rows; the directory swap
and its lock are JAX's, step for step. The JAX package's fault hooks and
metrics (``repro.fault``, ``repro.obs``) are not ported. The segmented
paths are single-device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings

import numpy as np
import torch

from repro_torch.core import engine, kmeans, quantization
from repro_torch.core.docfilter import cluster_survivor_counts
from repro_torch.core.reduction import TopKResult, two_stage_reduce
from repro_torch.core.types import WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import WarpSelectOut, topk_lower_index_first, warp_select
from repro_torch.core.worklist import build_tile_worklist, per_slot
from repro_torch.kernels import ops, ref
from repro_torch.store import format as store_format
from repro_torch.store.integrity import StoreCorruption

__all__ = [
    "SegmentedWarpIndex",
    "TOMBSTONES_FILE",
    "add_documents",
    "compact",
    "delete_documents",
    "delta_stats",
    "finish_from_probes",
    "load_segmented",
    "quantize_segment",
    "read_tombstones",
    "segmented_probe_cids",
    "select_probes",
]

TOMBSTONES_FILE = "tombstones.json"


@dataclasses.dataclass(frozen=True)
class SegmentedWarpIndex:
    """A base ``WarpIndex`` plus ordered delta segments, all on one device.

    Each delta is a ``WarpIndex`` over the SAME centroid space (its
    centroid and codec tensors are the base's) with segment-local doc ids;
    ``doc_starts[i]`` is the global id of segment ``i``'s first document
    (segment 0 is the base). ``quarantined`` names deltas a quarantining
    load skipped as corrupt: the view is then exact over base + healthy
    deltas and blind to those.
    """

    base: WarpIndex
    deltas: tuple[WarpIndex, ...]
    doc_starts: tuple[int, ...]
    quarantined: tuple[str, ...] = ()

    def __post_init__(self):
        if len(self.doc_starts) != 1 + len(self.deltas):
            raise ValueError("doc_starts must cover base + every delta")

    @property
    def segments(self) -> tuple[WarpIndex, ...]:
        return (self.base, *self.deltas)

    @property
    def n_segments(self) -> int:
        return 1 + len(self.deltas)

    @property
    def n_docs(self) -> int:
        # The global id bound, not a sum: a quarantined segment leaves a gap.
        return max(start + s.n_docs for start, s in zip(self.doc_starts, self.segments))

    @property
    def n_tokens(self) -> int:
        return sum(s.n_tokens for s in self.segments)

    @property
    def n_centroids(self) -> int:
        return self.base.n_centroids

    @property
    def cap(self) -> int:
        return max(s.cap for s in self.segments)

    @property
    def dim(self) -> int:
        return self.base.dim

    @property
    def nbits(self) -> int:
        return self.base.nbits

    @property
    def device(self) -> torch.device:
        return self.base.device

    def combined_cluster_sizes(self) -> torch.Tensor:
        """i32[C] on the device: the element-wise sum of every segment's
        cluster sizes (stage 1's sizes)."""
        sizes = self.base.cluster_sizes.clone()
        for d in self.deltas:
            sizes += d.cluster_sizes
        return sizes

    def per_segment_cluster_sizes(self) -> np.ndarray:
        """Host i64[n_segments, C] cluster sizes, base first (the ragged
        worklist bound's geometry)."""
        return np.stack([s.cluster_sizes.cpu().numpy().astype(np.int64) for s in self.segments])

    def to(self, device) -> "SegmentedWarpIndex":
        """The same view on ``device``; the deltas keep sharing the base's
        centroid and codec tensors."""
        base = self.base.to(device)
        shared = {f: getattr(base, f) for f in ("centroids", "bucket_weights", "bucket_cutoffs")}
        deltas = tuple(
            dataclasses.replace(
                d, **shared,
                **{f: getattr(d, f).to(base.device) for f in store_format.SEGMENT_ARRAYS},
            )
            for d in self.deltas
        )
        return dataclasses.replace(self, base=base, deltas=deltas)

    def nbytes(self) -> int:
        """Resident bytes; the shared centroid and codec tables once."""
        total = self.base.nbytes()
        for d in self.deltas:
            for name in store_format.SEGMENT_ARRAYS:
                arr = getattr(d, name)
                total += arr.numel() * arr.element_size()
        return total


# ---------------------------------------------------------------------------
# add, load
# ---------------------------------------------------------------------------


def quantize_segment(base, embeddings, token_doc_ids, n_docs: int) -> WarpIndex:
    """Quantize new documents against the frozen base on its device:
    normalize, assign to the existing centroids, encode residuals with the
    existing codec, lay out CSR-by-cluster over the same centroid space
    (a stable sort of the assignments). Doc ids are segment-local.
    ``base`` needs centroids, bucket tables, dim and nbits."""
    dev = base.centroids.device
    if isinstance(embeddings, torch.Tensor):
        emb = embeddings.to(device=dev, dtype=torch.float32)
    else:
        emb = torch.from_numpy(np.array(embeddings, dtype=np.float32)).to(dev)
    emb = kmeans.l2_normalize(emb)
    n_tokens = emb.shape[0]
    if isinstance(token_doc_ids, torch.Tensor):
        token_doc_ids = token_doc_ids.cpu().numpy()
    tdi = np.asarray(token_doc_ids, np.int32)
    if tdi.shape != (n_tokens,):
        raise ValueError("token_doc_ids must align with embeddings")
    if n_tokens and (tdi.min() < 0 or tdi.max() >= n_docs):
        raise ValueError("segment doc ids must be local, in [0, n_docs)")
    if emb.shape[1] != base.dim:
        raise ValueError(f"dim {emb.shape[1]} != base dim {base.dim}")

    c = base.centroids.shape[0]
    assign = kmeans.assign_clusters(emb, base.centroids)
    codes = quantization.encode_residuals(emb - base.centroids[assign], base.bucket_cutoffs)
    packed = quantization.pack_codes(codes, base.nbits)
    order = torch.sort(assign, stable=True).indices
    sizes = torch.bincount(assign, minlength=c).to(torch.int32)
    offsets = torch.zeros(c + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    return WarpIndex(
        centroids=base.centroids,
        packed_codes=packed[order],
        token_doc_ids=torch.from_numpy(tdi).to(dev)[order],
        cluster_offsets=offsets,
        cluster_sizes=sizes,
        bucket_weights=base.bucket_weights,
        bucket_cutoffs=base.bucket_cutoffs,
        dim=base.dim,
        nbits=base.nbits,
        cap=int(sizes.max()) if n_tokens else 0,
        n_docs=int(n_docs),
        n_tokens=int(n_tokens),
    )


@dataclasses.dataclass(frozen=True)
class _Codec:
    """The frozen centroids and codec of a store: what a new segment is
    quantized against (the base's codes and doc ids are not read)."""

    centroids: torch.Tensor
    bucket_weights: torch.Tensor
    bucket_cutoffs: torch.Tensor
    dim: int
    nbits: int


def _load_codec(path: str, manifest: dict, device) -> _Codec:
    arrays = manifest["arrays"]
    t = {
        name: torch.from_numpy(
            np.array(store_format._load_entry(path, arrays[name]), np.float32)
        ).to(device)
        for name in ("centroids", "bucket_weights", "bucket_cutoffs")
    }
    static = manifest["static"]
    return _Codec(**t, dim=int(static["dim"]), nbits=int(static["nbits"]))


def add_documents(path: str, embeddings, token_doc_ids, n_docs: int, *, device=None) -> str:
    """Append a delta segment to the store at ``path``, quantized on
    ``device`` (None -> the card); returns the new segment directory.
    ``token_doc_ids`` are local to the new batch (``0 .. n_docs``); global
    ids are assigned by position at load time. The files are those
    ``repro.store.add_documents`` writes for the same codes."""
    device = resolve_device(device)
    manifest = store_format.read_manifest(path)
    if manifest["kind"] != store_format.KIND_SINGLE:
        raise NotImplementedError(
            f"delta segments require a single-device base index, "
            f"got kind={manifest['kind']!r} (compact + reshard instead)"
        )
    if "shard" in manifest:
        # A shard view's codec cutoffs are zero-filled: every code would collapse.
        raise NotImplementedError(
            f"{path} is a per-shard view of a sharded index; delta "
            "segments must target the owning store"
        )
    seg = quantize_segment(_load_codec(path, manifest, device), embeddings, token_doc_ids, n_docs)

    seg_root = os.path.join(path, "segments")
    os.makedirs(seg_root, exist_ok=True)
    seg_id = len(store_format.list_segment_dirs(path))
    seg_dir = os.path.join(seg_root, f"seg_{seg_id:05d}")
    os.makedirs(os.path.join(seg_dir, store_format.ARRAY_DIR), exist_ok=True)
    arrays = {}
    for name in store_format.SEGMENT_ARRAYS:
        rel = f"{store_format.ARRAY_DIR}/{name}.bin"
        meta = store_format._write_array(
            os.path.join(seg_dir, rel), getattr(seg, name).cpu().numpy()
        )
        arrays[name] = store_format._entry(rel, meta)
    store_format._write_manifest(seg_dir, {
        "format": store_format.FORMAT_NAME,
        "version": store_format.FORMAT_VERSION,
        "kind": store_format.KIND_SEGMENT,
        "static": {
            "dim": seg.dim, "nbits": seg.nbits, "cap": seg.cap,
            "n_docs": seg.n_docs, "n_tokens": seg.n_tokens,
        },
        "arrays": arrays,
    })
    return seg_dir


def _to_device(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def load_segmented(base: WarpIndex, seg_dirs: list[str], *, quarantine: bool = False):
    """Stitch a base index and delta-segment directories into one view on
    the base's device; the deltas share the base's centroid and codec
    tensors. With ``quarantine`` a segment that fails its integrity
    checks is skipped with a warning (named in ``.quarantined``), leaving
    a doc-id gap where its manifest still gives its size."""
    deltas, doc_starts, quarantined = [], [0], []
    total = base.n_docs
    dev = base.device
    for seg_dir in seg_dirs:
        try:
            manifest, arrays = store_format.load_segment_arrays(seg_dir)
        except StoreCorruption as e:
            if not quarantine:
                raise
            quarantined.append(os.path.basename(seg_dir))
            warnings.warn(f"quarantined corrupt delta segment {seg_dir}: {e}", stacklevel=2)
            try:  # keep later segments' global doc ids stable if we can
                total += int(store_format.read_manifest(seg_dir)["static"]["n_docs"])
            except Exception:
                pass  # unknowable size: ids after this point shift
            continue
        static = manifest["static"]
        deltas.append(WarpIndex(
            centroids=base.centroids,
            packed_codes=_to_device(arrays["packed_codes"], torch.uint8, dev),
            token_doc_ids=_to_device(arrays["token_doc_ids"], torch.int32, dev),
            cluster_offsets=_to_device(arrays["cluster_offsets"], torch.int32, dev),
            cluster_sizes=_to_device(arrays["cluster_sizes"], torch.int32, dev),
            bucket_weights=base.bucket_weights,
            bucket_cutoffs=base.bucket_cutoffs,
            **{k: int(static[k]) for k in ("dim", "nbits", "cap", "n_docs", "n_tokens")},
        ))
        doc_starts.append(total)
        total += deltas[-1].n_docs
    return SegmentedWarpIndex(
        base=base, deltas=tuple(deltas), doc_starts=tuple(doc_starts),
        quarantined=tuple(quarantined),
    )


def delta_stats(path: str) -> dict:
    """Delta accumulation of the store at ``path`` from its manifests
    alone: ``n_delta_segments``, base/delta tokens and docs, and
    ``delta_token_frac`` = delta tokens / all tokens (0.0 when empty)."""
    static = store_format.read_manifest(path).get("static", {})
    base_tokens = int(static.get("n_tokens", static.get("n_tokens_total", 0)))
    base_docs = int(static.get("n_docs", 0))
    delta_tokens = delta_docs = 0
    seg_dirs = store_format.list_segment_dirs(path)
    for seg_dir in seg_dirs:
        seg_static = store_format.read_manifest(seg_dir)["static"]
        delta_tokens += int(seg_static["n_tokens"])
        delta_docs += int(seg_static["n_docs"])
    total = base_tokens + delta_tokens
    return {
        "n_delta_segments": len(seg_dirs),
        "base_tokens": base_tokens,
        "delta_tokens": delta_tokens,
        "base_docs": base_docs,
        "delta_docs": delta_docs,
        "delta_token_frac": (delta_tokens / total) if total else 0.0,
    }


# ---------------------------------------------------------------------------
# deletes: tombstones until the next compact
# ---------------------------------------------------------------------------


def read_tombstones(path: str) -> tuple[int, ...]:
    """Sorted global doc ids tombstoned at the store ``path`` (empty when
    none). Loading ignores them: a caller excludes them per request with
    ``DocFilter.tombstones(read_tombstones(path), n_docs)``."""
    p = os.path.join(path, TOMBSTONES_FILE)
    if not os.path.exists(p):
        return ()
    with open(p) as f:
        data = json.load(f)
    return tuple(sorted({int(i) for i in data.get("deleted", ())}))


def delete_documents(path: str, doc_ids) -> tuple[int, ...]:
    """Tombstone global doc ids at the store ``path`` (atomic tmp +
    rename); returns the merged, sorted tombstone set. ``compact`` drops
    the rows; their ids are never reused."""
    store_format.read_manifest(path)  # raises on a non-store path
    merged = set(read_tombstones(path)) | {int(i) for i in doc_ids}
    out = tuple(sorted(merged))
    tmp = os.path.join(path, TOMBSTONES_FILE + ".tmp")
    with open(tmp, "w") as f:
        json.dump({"deleted": list(out)}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, TOMBSTONES_FILE))
    return out


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def segmented_probe_cids(centroids, combined_sizes, q, qmask, config: WarpSearchConfig):
    """Stage 1's probe centroid ids alone (i64[..., Q, nprobe]): the
    clusters the search expands into per-segment worklist runs."""
    return warp_select(
        q, centroids, combined_sizes, nprobe=config.nprobe, t_prime=config.t_prime,
        k_impute=config.k_impute, qmask=qmask,
    ).probe_cids


def select_probes(seg: SegmentedWarpIndex, q, qmask, config, combined_sizes=None) -> WarpSelectOut:
    """Stage 1 over [B, Q, D] queries: the base centroids with the
    COMBINED cluster sizes (``combined_sizes``, computed when not given)."""
    if combined_sizes is None:
        combined_sizes = seg.combined_cluster_sizes()
    return warp_select(
        q, seg.base.centroids, combined_sizes, nprobe=config.nprobe,
        t_prime=config.t_prime, k_impute=config.k_impute, qmask=qmask,
    )


def _segmented_slot_doc_ids(segments, doc_starts, row0, seg_ids, *, tile_c: int):
    """Global doc id of every worklist slot, [..., W * tile_c]: the owning
    segment's ``token_doc_ids`` row plus its global doc-id offset (an
    arbitrary id on invalid slots)."""
    lane = torch.arange(tile_c, dtype=torch.long, device=row0.device)
    pos = row0.long().unsqueeze(-1) + lane  # [..., W, tile_c] segment-local
    out = torch.zeros(pos.shape, dtype=torch.long, device=row0.device)
    for s, (sub, start) in enumerate(zip(segments, doc_starts)):
        n_s = sub.token_doc_ids.shape[0]
        if n_s == 0:
            continue
        ids = sub.token_doc_ids[pos.clamp(0, n_s - 1)].long() + int(start)
        out = torch.where((seg_ids == s).unsqueeze(-1), ids, out)
    return out.reshape(*row0.shape[:-1], -1)


def _finish_dense(seg, q, qmask, sel, cfg, seg_views):
    scores_l, docs_l = [], []
    qm = q.shape[1]
    for i, (sub, start) in enumerate(zip(seg.segments, seg.doc_starts)):
        if sub.cap == 0 or sub.n_tokens == 0:
            continue  # a token-less segment has no candidates
        k_sub = max(1, min(cfg.k, qm * cfg.nprobe * sub.cap))  # a delta may hold < k slots
        r = engine.score_and_reduce(
            sub, q, qmask, sel.probe_scores, sel.probe_cids, sel.mse,
            dataclasses.replace(cfg, k=k_sub),
            dfilter=seg_views[i] if seg_views is not None else None,
        )
        scores_l.append(r.scores)
        docs_l.append(torch.where(r.doc_ids >= 0, r.doc_ids + int(start), -1))
    all_scores = torch.cat(scores_l, dim=-1)
    all_docs = torch.cat(docs_l, dim=-1)
    if all_scores.shape[-1] < cfg.k:  # a tiny corpus
        pad = cfg.k - all_scores.shape[-1]
        all_scores = torch.nn.functional.pad(all_scores, (0, pad), value=float("-inf"))
        all_docs = torch.nn.functional.pad(all_docs, (0, pad), value=-1)
    top_scores, top_idx = topk_lower_index_first(all_scores, cfg.k)
    top_docs = torch.where(torch.isfinite(top_scores), torch.gather(all_docs, -1, top_idx), -1)
    return TopKResult(scores=top_scores, doc_ids=top_docs.to(torch.int32))


def _finish_ragged(seg, q, qmask, sel, cfg, fctx):
    if cfg.worklist_tiles is None:
        raise ValueError(
            "segmented layout='ragged' needs a resolved worklist bound "
            "(worklist_tiles); plan through Retriever.plan"
        )
    # Token-less segments hold no runs: only the others enter the worklist.
    active = [i for i, s in enumerate(seg.segments) if s.n_tokens > 0]
    segments = [seg.segments[i] for i in active]
    starts_g = [seg.doc_starts[i] for i in active]
    base = seg.base
    tile = ops.resolve_tile_c(seg.cap, cfg.tile_c, layout="ragged")
    cids = sel.probe_cids
    b, qm, p = cids.shape
    n_seg = len(segments)
    # [B, Q, P] probes -> [B, Q, P * S] per-segment runs (segment-local rows).
    starts = torch.stack([s.cluster_offsets.long()[cids] for s in segments], dim=-1)
    run_sizes = torch.stack([s.cluster_sizes.long()[cids] for s in segments], dim=-1)
    # Masked query tokens emit no runs.
    run_sizes = torch.where(qmask[:, :, None, None], run_sizes, 0)
    doc_mask = None
    if fctx is not None:
        global_view, _, per_segment_live = fctx
        # A (segment, cluster) run with no surviving token emits no tiles.
        live = torch.from_numpy(per_segment_live[active]).to(cids.device)  # [S, C]
        run_sizes = torch.where(live[:, cids].movedim(0, -1), run_sizes, 0)
        doc_mask = global_view.doc_mask
    seg_ids = torch.arange(n_seg, device=cids.device).expand(b, qm, p, n_seg)
    pscores = sel.probe_scores.unsqueeze(-1).expand(b, qm, p, n_seg)
    wl = build_tile_worklist(
        starts.reshape(b, qm, -1), run_sizes.reshape(b, qm, -1),
        pscores.reshape(b, qm, -1), seg=seg_ids.reshape(b, qm, -1),
        tile_c=tile, tiles_per_qtoken=cfg.worklist_tiles,
    )  # each [B, W]
    w = wl.row0.shape[-1]
    qtok_slot = per_slot(wl.qtok.long(), tile)  # [B, W * tile]
    v = (q.unsqueeze(-1) * base.bucket_weights).reshape(b * qm, base.dim, base.n_buckets)
    # The batch's worklists run as one: element i's tokens are v rows i*Q ...
    qtok_all = (wl.qtok + (torch.arange(b, device=q.device) * qm).unsqueeze(-1).int()).reshape(-1)
    row0, nvalid, seg_w, pscore = (a.reshape(-1) for a in (wl.row0, wl.nvalid, wl.seg, wl.pscore))
    packed_list = tuple(s.packed_codes for s in segments)
    kw = dict(nbits=base.nbits, dim=base.dim, tile_c=tile)
    if cfg.gather == "fused":
        scores = ops.segmented_ragged_fused_gather_selective_sum(
            packed_list, row0, nvalid, seg_w, qtok_all, pscore, v,
            use_kernel=cfg.wants_kernel, **kw,
        )
        lane = torch.arange(tile, device=q.device)
        slot_valid = (lane < nvalid.unsqueeze(-1)).reshape(-1)
    else:
        codes, slot_valid = ref.segmented_ragged_gather_codes(
            packed_list, row0, nvalid, seg_w, tile_c=tile
        )
        if cfg.wants_kernel:
            # The gathered copy through the single-array kernel (tile w's
            # rows start at w * tile).
            copy_row0 = torch.arange(b * w, device=q.device, dtype=torch.int32) * tile
            scores = ops.ragged_fused_gather_selective_sum(
                codes, copy_row0, nvalid, qtok_all, pscore, v, use_kernel=True, **kw
            )
        else:
            res = ops.ragged_selective_sum(
                codes, per_slot(qtok_all.long(), tile), v,
                nbits=base.nbits, dim=base.dim, impl=cfg.sum_impl,
            )
            scores = torch.where(slot_valid, res + per_slot(pscore, tile), 0.0)
    doc = _segmented_slot_doc_ids(segments, starts_g, wl.row0, wl.seg, tile_c=tile)
    valid = slot_valid.reshape(b, -1) & torch.gather(qmask, 1, qtok_slot)
    return two_stage_reduce(
        doc, qtok_slot, scores.reshape(b, -1), valid, sel.mse, doc_mask,
        q_max=qm, k=cfg.k, impl=cfg.reduce_impl, pad_to_k=True,
    )


def finish_from_probes(seg: SegmentedWarpIndex, q, qmask, sel, config, fctx=None) -> TopKResult:
    """Stages 2+3 over base + deltas from a ``select_probes`` output
    (q [B, Q, D], qmask [B, Q]); ``config`` resolved (``worklist_tiles``
    when ragged). ``fctx`` is ``docfilter.resolve_segmented``'s triple:
    the dense path takes each segment's local view, the ragged path the
    per-segment liveness and the global doc mask."""
    if config.layout == "ragged":
        return _finish_ragged(seg, q, qmask, sel, config, fctx)
    return _finish_dense(seg, q, qmask, sel, config, fctx[1] if fctx is not None else None)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------


def compact(path: str) -> str:
    """Fold every delta segment back into a fresh single-segment base on
    the host, dropping tombstoned rows; centroids and codec stay frozen,
    tokens keep segment order within a cluster, doc ids become global
    (deleted ids stay gaps). The new base is written beside the store
    and swapped in; a pid lock file (``.compact-lock``) rejects a
    concurrent ``compact``, and a crash inside the swap is repaired by the
    next ``compact`` or ``load_index``
    (``format.recover_interrupted_compact``)."""
    lock = store_format.compact_lock_path(path)
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        if store_format._lock_holder_alive(lock):
            raise RuntimeError(
                f"another compact() is already running on {path} (lockfile {lock})"
            ) from None
        os.remove(lock)  # stale: a crashed writer's; take over
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    with os.fdopen(fd, "w") as f:
        f.write(str(os.getpid()))
    try:
        return _compact_locked(path)
    finally:
        if os.path.exists(lock):
            os.remove(lock)


def _compact_locked(path: str) -> str:
    from repro_torch.store.builder import _finalize_store  # builder imports format only

    store_format.recover_interrupted_compact(path)
    manifest = store_format.read_manifest(path)
    # On the CPU the arrays stay views of the store's files.
    seg = store_format.load_index(path, device="cpu")
    tomb_ids = read_tombstones(path)
    if isinstance(seg, WarpIndex):
        if not tomb_ids:
            return path  # no deltas, no tombstones: already compact
        # Tombstones alone still force a rewrite (that is what clears them).
        seg = SegmentedWarpIndex(base=seg, deltas=(), doc_starts=(0,))

    base = seg.base
    c = base.n_centroids
    n_docs_bound = seg.n_docs
    tomb = np.zeros((n_docs_bound,), dtype=bool)
    for t in tomb_ids:
        if 0 <= t < n_docs_bound:
            tomb[t] = True
    host = [
        {name: getattr(sub, name).numpy() for name in store_format.SEGMENT_ARRAYS}
        for sub in seg.segments
    ]
    if tomb.any():
        sizes = np.zeros((c,), np.int64)
        for sub, start, arr in zip(seg.segments, seg.doc_starts, host):
            keep_local = ~tomb[start : start + sub.n_docs]
            sizes += cluster_survivor_counts(
                keep_local, arr["token_doc_ids"], arr["cluster_offsets"]
            )
    else:
        sizes = seg.combined_cluster_sizes().numpy().astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n_tokens = int(sizes.sum())
    pb = quantization.packed_bytes(base.dim, base.nbits)

    # The merged arrays are memmap-written into the tmp store, each
    # segment copied chunk by chunk: host memory stays O(chunk + C).
    tmp = path.rstrip("/\\") + store_format.COMPACT_TMP_SUFFIX
    old = path.rstrip("/\\") + store_format.COMPACT_OLD_SUFFIX
    store_format._prepare_dir(tmp, overwrite=True)
    arr_dir = os.path.join(tmp, store_format.ARRAY_DIR)
    packed = np.memmap(
        os.path.join(arr_dir, "packed_codes.bin"), dtype=np.uint8, mode="w+", shape=(n_tokens, pb)
    )
    doc_ids = np.memmap(
        os.path.join(arr_dir, "token_doc_ids.bin"), dtype=np.int32, mode="w+", shape=(n_tokens,)
    )
    fill = np.zeros((c,), np.int64)
    step = 1 << 18
    drop_rows = tomb.any()
    for sub, start, arr in zip(seg.segments, seg.doc_starts, host):
        sub_sizes = arr["cluster_sizes"].astype(np.int64)
        sub_offsets = arr["cluster_offsets"].astype(np.int64)
        for lo in range(0, sub.n_tokens, step):
            hi = min(sub.n_tokens, lo + step)
            pos = np.arange(lo, hi, dtype=np.int64)
            # Owning cluster of CSR position p: the last offset <= p.
            cluster_of = np.searchsorted(sub_offsets, pos, side="right") - 1
            gids = arr["token_doc_ids"][lo:hi].astype(np.int64) + int(start)
            if drop_rows:
                # A kept row lands at its cluster's offset + rows written
                # before (``fill``) + its rank among this chunk's kept rows.
                keep = ~tomb[np.clip(gids, 0, n_docs_bound - 1)]
                ck = np.cumsum(keep)
                _, first_idx, inv = np.unique(cluster_of, return_index=True, return_inverse=True)
                prior = ck[first_idx] - keep[first_idx]
                rank = ck - 1 - prior[inv]
                d = offsets[cluster_of].astype(np.int64) + fill[cluster_of] + rank
                packed[d[keep]] = arr["packed_codes"][lo:hi][keep]
                doc_ids[d[keep]] = gids[keep].astype(np.int32)
                fill += np.bincount(cluster_of[keep], minlength=c)
            else:
                within = pos - sub_offsets[cluster_of]
                d = offsets[cluster_of].astype(np.int64) + fill[cluster_of] + within
                packed[d] = arr["packed_codes"][lo:hi]
                doc_ids[d] = gids.astype(np.int32)
        if not drop_rows:
            fill += sub_sizes
    packed.flush()
    doc_ids.flush()
    del packed, doc_ids, host, seg

    small = dict(
        centroids=base.centroids.numpy(), cluster_offsets=offsets,
        cluster_sizes=sizes.astype(np.int32), bucket_weights=base.bucket_weights.numpy(),
        bucket_cutoffs=base.bucket_cutoffs.numpy(),
    )
    static = dict(
        dim=base.dim, nbits=base.nbits, cap=int(sizes.max()), n_docs=n_docs_bound,
        n_tokens=n_tokens,
    )
    _finalize_store(tmp, small, static, manifest.get("build_config"))
    del base, small
    # A stale .compact-old can only be left by a crash after a completed
    # swap (path intact): clear it so the rename below works.
    shutil.rmtree(old, ignore_errors=True)
    os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old)
    return path
