#!/usr/bin/env python3
"""The embedding bag's forward kernel on one GPU, timed and profiled.

    python3 scripts/bench_bag_forward.py [--trees DIR[,DIR...]] [--seed 0] [--out FILE]

For each tree named (a checkout of this repository; by default this one),
in the order given, a child process imports that tree's ``repro_torch``
and times its ``embedding_bag_cuda`` at six inputs, made on the card from
``--seed`` (the same bytes for every tree):

  - ``user_bulk``: the two-tower user tower at serve_bulk (S 262,144, L 8,
    D 256, V 5,000,000; int64 ids uniform over the table, the path's 0/1
    prefix mask as the weights);
  - ``din``: DIN's history as ``chip_smoke.py``'s row 5-DIN makes it (S
    65,536, L 100, D 18, V 1,000,000; int64 ids uniform with a duplicate
    in every bag, weights uniform in [0, 1) with a fifth of them 0);
  - ``din_path``: DIN's history as the path makes it (``recsys_batch``'s
    ids and prefix mask, the mask times attention weights uniform in
    [-1, 1), so masked slots hold 0.0 and -0.0);
  - ``xdeepfm_bulk``: xDeepFM's linear term at serve_bulk (S 262,144, L 39,
    D 1, V 10,000,000; int32 ids, weights 1);
  - ``user_p99`` and ``din_p99``: the serve_p99 batch (S 512) at the user
    tower's and at DIN's path inputs.

Each call is timed as ``chip_smoke.time_cuda`` times it (median of 25
CUDA-event-timed runs, each after a 256 MB write that empties the L2),
then profiled: 5 calls, each after the same flush, under
``torch.profiler``, giving every CUDA kernel's mean device time per call.
Each input also reports the SHA-256 of the output's bytes, the share of
weights that are nonzero and the bound from the tree's
``embedding_bag.work(...)`` (bytes over 3.35 TB/s, fmas over 67 TFLOP/s).
Trees given as ``build/parent,.,.,build/parent`` compare two commits on
one card in turns; a tree that is not this checkout is unpacked beforehand
with ``git archive`` into a directory ``.gitignore`` lists. Prints one
JSON line per tree run, a summary (each input's times in turn order and
whether every run's output hash agrees), then the card's name and power
limit; writes the JSON lines to ``--out`` too. Exits non-zero without a
card, or if two runs' hashes differ.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# name, S, L, table, ids dtype, weights
CASES = (
    ("user_bulk", 262_144, 8, "user", "int64", "prefix"),
    ("din", 65_536, 100, "din", "int64", "fifth_zero"),
    ("din_path", 65_536, 100, "din", "int64", "attention"),
    ("xdeepfm_bulk", 262_144, 39, "linear", "int32", "ones"),
    ("user_p99", 512, 8, "user", "int64", "prefix"),
    ("din_p99", 512, 100, "din", "int64", "attention"),
)
TABLES = {"user": (5_000_000, 256), "din": (1_000_000, 18), "linear": (10_000_000, 1)}
PROFILED_CALLS = 5


def make_table(torch, name: str, seed: int, dev):
    v, d = TABLES[name]
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randn(v, d, generator=g, device=dev).mul_(0.05)


def make_bags(torch, s: int, l: int, v: int, dtype: str, weights: str, seed: int, dev):
    """(ids, weights) of one input, made on the card from ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    idx = torch.randint(0, v, (s, l), generator=g, device=dev)
    if weights == "ones":
        w = torch.ones(s, l, device=dev)
    elif weights == "fifth_zero":
        idx[:, 1] = idx[:, 0]  # a duplicate in every bag
        w = torch.rand(s, l, generator=g, device=dev)
        w = torch.where(torch.rand(s, l, generator=g, device=dev) < 0.2, 0.0, w)
    else:  # the path's prefix mask: 1..L valid slots
        n = torch.randint(1, l + 1, (s, 1), generator=g, device=dev)
        w = (torch.arange(l, device=dev) < n).float()
        if weights == "attention":
            w = w * (torch.rand(s, l, generator=g, device=dev) * 2 - 1)
    return idx.to(getattr(torch, dtype)).contiguous(), w.contiguous()


def profile_kernels(torch, fn, flush) -> dict:
    """{kernel name: mean device ms per call} over PROFILED_CALLS calls,
    each after the L2 flush."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    total: dict = {}
    for _ in range(PROFILED_CALLS):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return {k: t / PROFILED_CALLS for k, t in sorted(total.items(), key=lambda kv: -kv[1])}


def child(tree: str, seed: int) -> dict:
    """One tree's measurements (run in a process of its own, with that
    tree's ``src`` first on the path)."""
    sys.path.insert(0, os.path.join(tree, "src"))
    import torch

    from repro_torch.kernels import LAUNCHES, _build
    from repro_torch.kernels.autotune_sweep import event_ms
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, work

    dev = torch.device("cuda")
    _build.build_all()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": tree}
    tables: dict = {}
    for i, (name, s, l, tname, dtype, weights) in enumerate(CASES):
        if tname not in tables:
            tables = {tname: make_table(torch, tname, seed + 100 + list(TABLES).index(tname), dev)}
            torch.cuda.empty_cache()
        table = tables[tname]
        v, d = table.shape
        idx, w = make_bags(torch, s, l, v, dtype, weights, seed + i, dev)

        def fn():
            return embedding_bag_cuda(table, idx, w)

        before = LAUNCHES["embedding_bag"]
        got = fn()
        torch.cuda.synchronize()
        launches = LAUNCHES["embedding_bag"] - before
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        needed = int((w != 0).sum())
        ops, nbytes = work(s=s, l=l, d=d, needed=needed, index_bytes=idx.element_size())
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        ms = event_ms(fn, warmup=3, iters=25, flush=flush)
        kernels = profile_kernels(torch, fn, flush)
        out[name] = {
            "shape": [s, l, d, v], "ids": dtype, "ms": ms,
            "profiled_ms": sum(kernels.values()), "kernels": kernels, "sha256": digest,
            "nonzero_share": needed / (s * l), "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "launches_per_call": launches,
        }
        del idx, w, got
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    return out


def tree_dir(tree: str) -> str:
    """The tree's absolute directory, relative to this checkout."""
    path = os.path.abspath(os.path.join(ROOT, tree))
    if not os.path.isdir(os.path.join(path, "src", "repro_torch")):
        raise SystemExit(f"bench_bag_forward: no checkout at {path} (unpack one with "
                         "mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent)")
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child, args.seed)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bench_bag_forward: no CUDA device", file=sys.stderr)
        return 2
    lines = []
    for tree in args.trees.split(","):
        run = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree_dir(tree),
             "--seed", str(args.seed)],
            capture_output=True, text=True, check=False)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        lines.append(run.stdout.strip().splitlines()[-1])
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    runs = [json.loads(line) for line in lines]
    agree = True
    for name, *_ in CASES:
        hashes = {r[name]["sha256"] for r in runs}
        agree &= len(hashes) == 1
        print(f"{name}: ms {[round(r[name]['ms'], 5) for r in runs]} (trees {args.trees}); bound "
              f"{runs[-1][name]['bound_ms']:.5f} ms; nonzero {runs[-1][name]['nonzero_share']:.4f}; "
              f"hashes {'agree' if len(hashes) == 1 else 'DIFFER'}")
    print(runs[-1]["card"])
    return 0 if agree else 1


if __name__ == "__main__":
    sys.exit(main())
