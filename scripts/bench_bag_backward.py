#!/usr/bin/env python3
"""The embedding bag's backward on one GPU, timed whole and split by kernel.

    python3 scripts/bench_bag_backward.py [--trees DIR[,DIR...]] [--seed 0] [--out FILE]

For each tree named (a checkout of this repository; by default this one),
in the order given, a child process imports that tree's ``repro_torch``
and times its ``embedding_bag_backward_cuda`` at three inputs:

  - ``din``: DIN's history (S 65,536, L 100, D 18, V 1,000,000; int64 ids
    uniform over the table with a duplicate in every bag, weights uniform
    in [0, 1) with a fifth of them 0, as ``chip_smoke.py``'s row 5b-DIN):
    the table's gradient, the weights', and both in one call;
  - ``two_tower``: the two-tower user tower at its training batch (S
    32,768, L 8, D 256, V 5,000,000; int64 ids, a 0/1 prefix mask as the
    weights): the table's gradient;
  - ``xdeepfm``: xDeepFM's linear term at one training microbatch (S
    16,384, L 39, D 1, V 10,000,000; int32 ids, weights 1): the table's
    gradient.

Each call is timed as ``chip_smoke.time_cuda`` times it (median of 25
CUDA-event-timed runs, each after a 256 MB write that empties the L2),
then profiled: 5 calls, each after the same flush, under
``torch.profiler``, giving every CUDA kernel's mean device time per call
and those times summed by step (``STEPS``: the parent design's index
preparation, sort, zero fills and two kernels, or the redesign's sort
passes, row offsets, rows pass and slots pass). Trees given as
``build/parent,.,.,build/parent`` compare two commits on one card in
turns; a tree that is not this checkout is unpacked beforehand with ``git
archive`` into a directory ``.gitignore`` lists. Prints one JSON line per tree run,
then the card's name and power limit; writes the lines to ``--out`` too.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Kernel name -> step, first match wins (the redesign's names, then the
# parent design's: torch.sort's CUB kernels, the fills, the index casts).
STEPS = (
    ("sort passes (keys, histograms, scans, scatters)", r"sort_(histogram|scan|scatter)_kernel"),
    ("row offsets", r"row_offsets_kernel"),
    ("rows pass (dtable)", r"grad_rows"),
    ("slots pass (dw)", r"grad_slots"),
    ("grad_table_kernel", r"grad_table_kernel"),
    ("grad_weights_kernel", r"grad_weights_kernel"),
    ("sort (torch.sort)", r"[Rr]adix|[Ss]ort|cub::"),
    ("zero fills", r"FillFunctor|[Mm]emset"),
    ("flatten + where + long", r"."),
)
CASES = (  # name, S, L, D, V, ids dtype, gradients timed
    ("din", 65_536, 100, 18, 1_000_000, "int64", ("table", "weights", "both")),
    ("two_tower", 32_768, 8, 256, 5_000_000, "int64", ("table",)),
    ("xdeepfm", 16_384, 39, 1, 10_000_000, "int32", ("table",)),
)
PROFILED_CALLS = 5


def step_of(kernel: str) -> str:
    return next(step for step, pat in STEPS if re.search(pat, kernel))


def inputs(torch, name, s, l, d, v, dtype, seed, dev):
    """(table, ids, weights, grad) of one case, made on the card from
    ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    table = torch.randn(v, d, generator=g, device=dev).mul_(0.05)
    idx = torch.randint(0, v, (s, l), generator=g, device=dev)
    if name == "din":
        idx[:, 1] = idx[:, 0]  # a duplicate in every bag
        w = torch.rand(s, l, generator=g, device=dev)
        w = torch.where(torch.rand(s, l, generator=g, device=dev) < 0.2, 0.0, w)
    elif name == "two_tower":
        n = torch.randint(1, l + 1, (s, 1), generator=g, device=dev)
        w = (torch.arange(l, device=dev) < n).float()
    else:
        w = torch.ones(s, l, device=dev)
    grad = torch.randn(s, d, generator=g, device=dev)
    return table, idx.to(getattr(torch, dtype)).contiguous(), w, grad


def profile_split(torch, fn, flush) -> dict:
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

    from repro_torch.kernels import _build
    from repro_torch.kernels.autotune_sweep import event_ms
    from repro_torch.kernels.embedding_bag import embedding_bag_backward_cuda

    dev = torch.device("cuda")
    _build.build_all()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": tree}
    for i, (name, s, l, d, v, dtype, grads) in enumerate(CASES):
        table, idx, w, g = inputs(torch, name, s, l, d, v, dtype, seed + i, dev)
        res = {"shape": [s, l, d, v], "ids": dtype}
        for which in grads:
            kw = {"table": dict(), "weights": dict(table_grad=False, weights_grad=True),
                  "both": dict(weights_grad=True)}[which]

            def fn(kw=kw):
                return embedding_bag_backward_cuda(table, idx, w, g, **kw)

            ms = event_ms(fn, warmup=3, iters=25, flush=flush)
            kernels = profile_split(torch, fn, flush)
            steps: dict = {}
            for k, t in kernels.items():
                steps[step_of(k)] = steps.get(step_of(k), 0.0) + t
            res[which] = {"ms": ms, "profiled_ms": sum(kernels.values()), "steps": steps,
                          "kernels": kernels}
        out[name] = res
        del table, idx, w, g
        torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    return out


def tree_dir(tree: str) -> str:
    """The tree's absolute directory, relative to this checkout."""
    path = os.path.abspath(os.path.join(ROOT, tree))
    if not os.path.isdir(os.path.join(path, "src", "repro_torch")):
        raise SystemExit(f"bench_bag_backward: no checkout at {path} (unpack one with "
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
        print("bench_bag_backward: no CUDA device", file=sys.stderr)
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
    print(json.loads(lines[-1])["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
