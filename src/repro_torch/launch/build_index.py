"""Index store CLI of the PyTorch port: build / add / compact / inspect /
verify / smoke.

  # out-of-core build on the card from .npy inputs (mmap-read, streamed)
  PYTHONPATH=src python -m repro_torch.launch.build_index build \\
      --out idx.warpidx --emb emb.npy --doc-ids doc_ids.npy --n-docs 100000

  # or from the synthetic corpus generator
  PYTHONPATH=src python -m repro_torch.launch.build_index build \\
      --out idx.warpidx --synth-docs 500 --nbits 4

  # append new documents as a delta segment against the frozen base
  PYTHONPATH=src python -m repro_torch.launch.build_index add \\
      --index idx.warpidx --synth-docs 50 --synth-seed 9

  # fold delta segments (and tombstoned rows) into a fresh base
  PYTHONPATH=src python -m repro_torch.launch.build_index compact --index idx.warpidx

  # manifest + measured per-component bytes
  PYTHONPATH=src python -m repro_torch.launch.build_index inspect --index idx.warpidx

  # stream every array against its recorded checksum
  PYTHONPATH=src python -m repro_torch.launch.build_index verify --index idx.warpidx

  # load the store and run a small search
  PYTHONPATH=src python -m repro_torch.launch.build_index smoke --index idx.warpidx

``build``, ``add`` and ``smoke`` run on ``--device`` (default ``cuda``;
they raise without CUDA unless given ``--device cpu``); ``compact`` runs
on the host. The stores are those the JAX package's
``repro.launch.build_index`` writes and reads, delta segments included.
``build --n-shards N`` writes a document-sharded store (N shards built on
the one ``--device``; it loads back as a ``ShardedWarpIndex``); a sharded
base takes no delta segments: compact and re-shard instead.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.core import IndexBuildConfig, Retriever, WarpSearchConfig, build_sharded_index
from repro_torch.data import make_corpus, make_queries
from repro_torch.store import (
    add_documents,
    array_chunks,
    build_index_to_store,
    compact,
    inspect_index,
    save_index,
    verify_store,
)


def _add_input_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--emb", help=".npy of f32[N, D] token embeddings")
    ap.add_argument("--doc-ids", help=".npy of i32[N] token doc ids")
    ap.add_argument("--n-docs", type=int, default=None,
                    help="document count (default: max(doc_ids) + 1)")
    ap.add_argument("--synth-docs", type=int, default=None,
                    help="generate a synthetic corpus of this many docs")
    ap.add_argument("--synth-seed", type=int, default=0)
    ap.add_argument("--mean-doc-len", type=int, default=20)


def _load_input(args) -> tuple[np.ndarray, np.ndarray, int]:
    """(embeddings, token_doc_ids, n_docs); .npy inputs stay mmap-backed."""
    if args.synth_docs is not None:
        corpus = make_corpus(args.synth_docs, mean_doc_len=args.mean_doc_len, seed=args.synth_seed)
        return corpus.emb, corpus.token_doc_ids, corpus.n_docs
    if not args.emb or not args.doc_ids:
        raise SystemExit("need --emb + --doc-ids, or --synth-docs")
    emb = np.load(args.emb, mmap_mode="r")
    tdi = np.load(args.doc_ids, mmap_mode="r")
    n_docs = args.n_docs if args.n_docs is not None else int(tdi.max()) + 1
    return emb, tdi, n_docs


def cmd_build(args) -> None:
    emb, tdi, n_docs = _load_input(args)
    cfg = IndexBuildConfig(
        n_centroids=args.n_centroids, nbits=args.nbits, kmeans_iters=args.kmeans_iters,
        seed=args.seed, chunk_size=args.chunk_size,
    )
    t0 = time.perf_counter()
    if args.n_shards:
        sidx = build_sharded_index(emb, tdi, n_docs, args.n_shards, cfg, device=args.device)
        save_index(sidx, args.out, build_config=cfg, overwrite=args.overwrite)
    else:
        build_index_to_store(
            array_chunks(emb, tdi, cfg.chunk_size), args.out, n_docs, cfg,
            n_tokens=int(emb.shape[0]), dim=int(emb.shape[1]), overwrite=args.overwrite,
            device=args.device,
        )
    dt = time.perf_counter() - t0
    info = inspect_index(args.out)
    print(f"built {info['kind']} at {args.out} on {args.device or 'cuda'} in {dt:.1f}s: "
          f"{info['total_bytes'] / 2**20:.1f} MiB ({info['bytes_per_token']:.1f} B/token)")


def cmd_add(args) -> None:
    emb, tdi, n_docs = _load_input(args)
    seg_dir = add_documents(args.index, emb, tdi, n_docs, device=args.device)
    print(f"appended {n_docs} docs ({emb.shape[0]} tokens) -> {seg_dir}")


def cmd_compact(args) -> None:
    t0 = time.perf_counter()
    compact(args.index)
    info = inspect_index(args.index)
    print(f"compacted {args.index} in {time.perf_counter() - t0:.1f}s: "
          f"{info['static']['n_docs']} docs, {info['static']['n_tokens']} tokens, "
          f"{info['total_bytes'] / 2**20:.1f} MiB")


def cmd_inspect(args) -> None:
    print(json.dumps(inspect_index(args.index), indent=1, sort_keys=True))


def cmd_verify(args) -> None:
    """Exit 0 with a summary when clean; ``StoreCorruption`` (listing every
    failing array) otherwise."""
    t0 = time.perf_counter()
    report = verify_store(args.index, full=not args.head_only)
    mode = "head-sampled" if args.head_only else "full-stream"
    print(f"verified {args.index} in {time.perf_counter() - t0:.1f}s ({mode}): "
          f"{report['checked']} arrays ok, {report['unchecked']} without checksums, "
          f"{report['dirs']} manifest dirs")


def cmd_smoke(args) -> None:
    """Load the store and run a small search."""
    retriever = Retriever.from_store(args.index, device=args.device)
    plan = retriever.plan(WarpSearchConfig(nprobe=args.nprobe, k=args.k))
    corpus = make_corpus(64, dim=retriever.index.dim, mean_doc_len=8, seed=123)
    q, qmask, _ = make_queries(corpus, n_queries=1, seed=124)
    docs = plan.retrieve(q[0], qmask[0]).doc_ids.cpu().numpy()
    print(f"plan: {plan.describe()}")
    print(f"smoke top-{args.k}: {docs.tolist()}")
    if not ((docs >= -1) & (docs < retriever.n_docs)).all():
        raise SystemExit("smoke search returned out-of-range doc ids")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a new store directory")
    _add_input_args(b)
    b.add_argument("--out", required=True)
    b.add_argument("--n-centroids", type=int, default=None)
    b.add_argument("--nbits", type=int, default=4, choices=(2, 4, 8))
    b.add_argument("--kmeans-iters", type=int, default=4)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--chunk-size", type=int, default=IndexBuildConfig().chunk_size)
    b.add_argument("--overwrite", action="store_true")
    b.add_argument("--n-shards", type=int, default=0,
                   help="document-sharded build (0 = single)")
    b.add_argument("--device", default=None, help="cuda (the default) or cpu")
    b.set_defaults(fn=cmd_build)

    a = sub.add_parser("add", help="append documents as a delta segment")
    _add_input_args(a)
    a.add_argument("--index", required=True)
    a.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a.set_defaults(fn=cmd_add)

    c = sub.add_parser("compact", help="fold delta segments into the base")
    c.add_argument("--index", required=True)
    c.set_defaults(fn=cmd_compact)

    i = sub.add_parser("inspect", help="print manifest + measured bytes")
    i.add_argument("--index", required=True)
    i.set_defaults(fn=cmd_inspect)

    v = sub.add_parser("verify", help="check every array against its recorded checksum")
    v.add_argument("--index", required=True)
    v.add_argument("--head-only", action="store_true",
                   help="head samples only (the load-time check) instead of every byte")
    v.set_defaults(fn=cmd_verify)

    s = sub.add_parser("smoke", help="load + search sanity check")
    s.add_argument("--index", required=True)
    s.add_argument("--nprobe", type=int, default=8)
    s.add_argument("--k", type=int, default=5)
    s.add_argument("--device", default=None, help="cuda (the default) or cpu")
    s.set_defaults(fn=cmd_smoke)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
