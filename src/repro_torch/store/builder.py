"""Out-of-core index construction on the device: stream embedding chunks,
never hold the corpus in memory. Counterpart of ``repro/store/builder.py``.

The build is five passes, each a plain function so that a test can hand
any of them the JAX build's intermediate values:

  sample    ``sample_indices`` draws the sqrt(N)-proportional k-means
            sample; ``gather_sample`` collects and normalizes its rows in
            one stream of the chunks
  k-means   ``kmeans.spherical_kmeans`` on the sample
  assign    ``assign_pass``: assign every token (assignments buffered in
            i32[N] host memory, or a scratch file for store builds, so the
            O(N·C·D) product runs once), count tokens per cluster, keep the
            residuals of the first min(N·D, 2^22) flat values for the codec
  buckets   ``quantization.compute_buckets`` on that residual sample
  scatter   ``scatter_pass``: encode, pack and scatter codes and doc ids
            into their CSR-by-cluster slots (a stable sort of each chunk's
            assignments plus running per-cluster cursors == the stable
            argsort over the whole corpus)

``encode_corpus`` runs the last three from given centroids.

Chunks stream from host or ``np.memmap`` arrays; every per-token step
(normalize, assign, residual, encode, pack, the chunk's stable sort) runs
on ``device``. Each is row-independent and the assignment products have
one shape per block (``kmeans.assign_clusters``), so the index does not
depend on ``chunk_size``. With ``store_path`` the two O(N) outputs (packed
codes, doc ids) go through ``np.memmap`` straight into the store
directory.

Randomness comes from a CPU ``torch.Generator`` seeded from
``IndexBuildConfig.seed``: the same draws on every device. JAX's PRNG
stream cannot be reproduced without JAX, so the port samples other rows
than the JAX build from the same seed.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Iterable, Iterator, Tuple

import numpy as np
import torch

from repro_torch.core import kmeans, quantization
from repro_torch.core.types import IndexBuildConfig, WarpIndex, resolve_device
from repro_torch.store import format as store_format
from repro_torch.store import integrity

__all__ = [
    "array_chunks",
    "assign_pass",
    "build_index_chunked",
    "build_index_to_store",
    "encode_corpus",
    "gather_sample",
    "normalized_chunks",
    "sample_indices",
    "scatter_pass",
]

Chunk = Tuple[object, object]
ChunkSource = Callable[[], Iterable[Chunk]]
# Zero-arg callable yielding (unit rows f32[n, D] on the device, doc ids i32[n] on the host).
NormalizedSource = Callable[[], Iterable[Tuple[torch.Tensor, np.ndarray]]]
STATS_VALUES = 1 << 22  # residual values the codec's quantiles are taken over


def array_chunks(embeddings, token_doc_ids, chunk_size: int | None = None) -> ChunkSource:
    """Adapt in-memory arrays (numpy, ``np.load(mmap_mode="r")``, torch) to
    a re-iterable chunk source; ``chunk_size=None`` yields one chunk."""
    n = embeddings.shape[0]
    step = int(chunk_size) if chunk_size else max(1, n)

    def chunks() -> Iterator[Chunk]:
        for lo in range(0, n, step):
            yield embeddings[lo : lo + step], token_doc_ids[lo : lo + step]
        if n == 0:
            yield embeddings[:0], token_doc_ids[:0]

    return chunks


def _to_device(x, device) -> torch.Tensor:
    """float32 copy of a host or device array on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


def _host_i32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy().astype(np.int32, copy=False)
    return np.asarray(x, np.int32)


def normalized_chunks(chunks: ChunkSource, device) -> NormalizedSource:
    """The chunk source with each embedding chunk moved to ``device`` and
    L2-normalized."""

    def normed():
        for emb_c, tdi_c in chunks():
            yield kmeans.l2_normalize(_to_device(emb_c, device)), _host_i32(tdi_c)

    return normed


def sample_indices(
    n_tokens: int, n_centroids: int, config: IndexBuildConfig, generator: torch.Generator
) -> np.ndarray:
    """The k-means sample: sample_factor * 4 * sqrt(N) token indices, at
    least 4 per centroid, at most N, without replacement, in draw order."""
    sample_n = int(
        min(n_tokens, max(4 * n_centroids, config.sample_factor * 4 * math.sqrt(n_tokens)))
    )
    return torch.randperm(n_tokens, generator=generator)[:sample_n].numpy()


def gather_sample(chunks: ChunkSource, sample_idx: np.ndarray, n_tokens: int, dim: int, device):
    """The sampled rows, normalized, f32[len(sample_idx), D] on ``device``
    (row i is token ``sample_idx[i]``). Only the sampled rows are copied to
    the device; validates the chunk source against ``n_tokens``."""
    sample = torch.empty((len(sample_idx), dim), dtype=torch.float32, device=device)
    lo = 0
    for emb_c, tdi_c in chunks():
        if np.shape(tdi_c)[0] != emb_c.shape[0]:
            raise ValueError("token_doc_ids must align with embeddings")
        hi = lo + emb_c.shape[0]
        m = (sample_idx >= lo) & (sample_idx < hi)
        if m.any():
            local = sample_idx[m] - lo
            if isinstance(emb_c, torch.Tensor):
                local = torch.from_numpy(local).to(emb_c.device)
            rows = _to_device(emb_c[local], device)
            sample[torch.from_numpy(m).to(device)] = kmeans.l2_normalize(rows)
        lo = hi
    if lo != n_tokens:
        # An overstated count would leave sample rows uninitialized.
        raise ValueError(f"chunk source yielded {lo} tokens but n_tokens={n_tokens}")
    return sample


def assign_pass(
    normed: NormalizedSource, centroids: torch.Tensor, assign_out: np.ndarray, n_tokens: int
):
    """Assign every token into ``assign_out`` (i32[N], host or memmap) ->
    (counts i64[C] host, the residual sample: the first min(N·D, 2^22)
    flat values of normalized token minus its centroid, f32 on the
    device)."""
    c, dim = centroids.shape
    counts = torch.zeros(c, dtype=torch.long, device=centroids.device)
    stats_n = min(n_tokens * dim, STATS_VALUES)
    rows_needed = -(-stats_n // dim)
    stat_rows, got, lo = [], 0, 0
    for norm, _ in normed():
        a = kmeans.assign_clusters(norm, centroids)
        m = norm.shape[0]
        assign_out[lo : lo + m] = a.cpu().numpy()
        lo += m
        counts += torch.bincount(a, minlength=c)
        if got < rows_needed:
            take = min(rows_needed - got, m)
            stat_rows.append(norm[:take] - centroids[a[:take]])
            got += take
    flat = torch.cat([r.reshape(-1) for r in stat_rows])[:stats_n]
    return counts.cpu().numpy(), flat


def scatter_pass(
    normed: NormalizedSource,
    centroids: torch.Tensor,
    assign_all: np.ndarray,
    offsets: np.ndarray,
    cutoffs: torch.Tensor,
    nbits: int,
    packed_out: np.ndarray,
    docs_out: np.ndarray,
) -> np.ndarray:
    """Encode, pack and scatter every token into its CSR slot of
    ``packed_out`` u8[N, PB] / ``docs_out`` i32[N] -> per-cluster fill
    counts (i64[C], equal to the assign pass's counts when the chunk
    source did not change between passes)."""
    c = centroids.shape[0]
    dev = centroids.device
    offs = torch.from_numpy(np.asarray(offsets, np.int64)[:c]).to(dev)
    fill = torch.zeros(c, dtype=torch.long, device=dev)
    lo = 0
    for norm, tdi in normed():
        m = norm.shape[0]
        a = torch.from_numpy(np.asarray(assign_all[lo : lo + m], np.int64)).to(dev)
        lo += m
        codes = quantization.encode_residuals(norm - centroids[a], cutoffs)
        packed = quantization.pack_codes(codes, nbits)
        sa, order = torch.sort(a, stable=True)
        chunk_counts = torch.bincount(a, minlength=c)
        run_start = torch.cumsum(chunk_counts, 0) - chunk_counts
        within = torch.arange(m, device=dev) - run_start[sa]
        dest = (offs[sa] + fill[sa] + within).cpu().numpy()
        packed_out[dest] = packed[order].cpu().numpy()
        docs_out[dest] = tdi[order.cpu().numpy()]
        fill += chunk_counts
    return fill.cpu().numpy()


def encode_corpus(
    normed: NormalizedSource,
    centroids: torch.Tensor,
    nbits: int,
    n_tokens: int,
    *,
    assign_out: np.ndarray,
    packed_out: np.ndarray,
    docs_out: np.ndarray,
) -> dict:
    """Everything after k-means: the assign pass, the codec's buckets and
    the scatter pass, from given centroids. Fills the three outputs and
    returns the small arrays (host numpy): centroids, cluster_offsets,
    cluster_sizes, bucket_weights, bucket_cutoffs."""
    counts, flat = assign_pass(normed, centroids, assign_out, n_tokens)
    cutoffs, weights = quantization.compute_buckets(flat, nbits)
    del flat
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    fill = scatter_pass(normed, centroids, assign_out, offsets, cutoffs, nbits, packed_out, docs_out)
    if not np.array_equal(fill, counts):
        raise RuntimeError("chunk source changed between passes (assign/count vs scatter)")
    return dict(
        centroids=centroids.cpu().numpy(), cluster_offsets=offsets,
        cluster_sizes=counts.astype(np.int32), bucket_weights=weights.cpu().numpy(),
        bucket_cutoffs=cutoffs.cpu().numpy(),
    )


def build_index_chunked(
    chunks: ChunkSource,
    n_docs: int,
    config: IndexBuildConfig = IndexBuildConfig(),
    *,
    n_tokens: int | None = None,
    dim: int | None = None,
    store_path: str | None = None,
    overwrite: bool = False,
    device=None,
) -> WarpIndex:
    """Build a ``WarpIndex`` on ``device`` (None -> the card) from a
    re-iterable stream of ``(emb_chunk f32[n, D], token_doc_ids i32[n])``.

    ``chunks`` is a zero-arg callable returning a fresh iterator (the build
    makes up to four passes). Pass ``n_tokens``/``dim`` when known to skip
    the counting pass. With ``store_path`` the packed codes and doc ids
    are memmap-written into that store directory, the manifest is written
    last, and the index is loaded back from the store."""
    device = resolve_device(device)
    if n_tokens is None or dim is None:
        n_tokens = 0
        for emb_c, tdi_c in chunks():
            if emb_c.shape[0] != np.shape(tdi_c)[0]:
                raise ValueError("token_doc_ids must align with embeddings")
            n_tokens += emb_c.shape[0]
            if dim is None and emb_c.ndim == 2:
                dim = int(emb_c.shape[1])
    if not n_tokens or not dim:
        raise ValueError("cannot build an index from an empty corpus")
    if store_path is not None:
        # Claim the directory first: an existing index fails before the passes.
        store_format._prepare_dir(store_path, overwrite)

    gen = torch.Generator().manual_seed(config.seed)
    c = config.resolved_n_centroids(n_tokens)
    sample_idx = sample_indices(n_tokens, c, config, gen)
    sample = gather_sample(chunks, sample_idx, n_tokens, dim, device)
    centroids = kmeans.spherical_kmeans(sample, c, iters=config.kmeans_iters, generator=gen)
    del sample

    pb = quantization.packed_bytes(dim, config.nbits)
    if store_path is not None:
        arr_dir = os.path.join(store_path, store_format.ARRAY_DIR)
        assign_scratch = os.path.join(arr_dir, "assign.scratch")

        def out(name, dtype, shape):
            return np.memmap(os.path.join(arr_dir, name), dtype=dtype, mode="w+", shape=shape)

        assign_all = out("assign.scratch", np.int32, (n_tokens,))
        packed_out = out("packed_codes.bin", np.uint8, (n_tokens, pb))
        docs_out = out("token_doc_ids.bin", np.int32, (n_tokens,))
    else:
        assign_all = np.empty((n_tokens,), np.int32)
        packed_out = np.empty((n_tokens, pb), np.uint8)
        docs_out = np.empty((n_tokens,), np.int32)
    small = encode_corpus(
        normalized_chunks(chunks, device), centroids, config.nbits, n_tokens,
        assign_out=assign_all, packed_out=packed_out, docs_out=docs_out,
    )
    static = dict(dim=int(dim), nbits=config.nbits, cap=int(small["cluster_sizes"].max()),
                  n_docs=int(n_docs), n_tokens=int(n_tokens))
    if store_path is None:
        return WarpIndex.from_arrays(
            dict(small, packed_codes=packed_out, token_doc_ids=docs_out, **static),
            device=device,
        )
    packed_out.flush()
    docs_out.flush()
    del packed_out, docs_out, assign_all
    os.remove(assign_scratch)
    _finalize_store(store_path, small, static, config)
    return store_format.load_index(store_path, device=device)


def _finalize_store(path: str, small: dict, static: dict, build_config) -> None:
    """Write the small arrays and the manifest around the memmap-written
    packed codes and doc ids (the manifest last)."""
    arrays = {}
    for name in ("centroids", "cluster_offsets", "cluster_sizes", "bucket_weights",
                 "bucket_cutoffs"):
        rel = f"{store_format.ARRAY_DIR}/{name}.bin"
        meta = store_format._write_array(os.path.join(path, rel), small[name])
        arrays[name] = store_format._entry(rel, meta)
    n_tokens = static["n_tokens"]
    pb = quantization.packed_bytes(static["dim"], static["nbits"])
    for name, meta in (
        ("packed_codes", {"dtype": "uint8", "shape": [n_tokens, pb]}),
        ("token_doc_ids", {"dtype": "int32", "shape": [n_tokens]}),
    ):
        rel = f"{store_format.ARRAY_DIR}/{name}.bin"
        if n_tokens:
            # Written chunk by chunk through a memmap: stream the file back.
            meta["checksum"] = integrity.checksum_file(os.path.join(path, rel))
        arrays[name] = store_format._entry(rel, meta)
    store_format._write_manifest(path, {
        "format": store_format.FORMAT_NAME,
        "version": store_format.FORMAT_VERSION,
        "kind": store_format.KIND_SINGLE,
        "static": static,
        "arrays": arrays,
        "build_config": store_format._config_dict(build_config),
    })


def build_index_to_store(
    chunks: ChunkSource,
    path: str,
    n_docs: int,
    config: IndexBuildConfig = IndexBuildConfig(),
    *,
    n_tokens: int | None = None,
    dim: int | None = None,
    overwrite: bool = False,
    device=None,
) -> WarpIndex:
    """Out-of-core build straight into a store directory; returns the index
    loaded from it onto ``device`` (None -> the card). Peak host memory is
    O(chunk + n_centroids)."""
    return build_index_chunked(
        chunks, n_docs, config, n_tokens=n_tokens, dim=dim, store_path=path,
        overwrite=overwrite, device=device,
    )
