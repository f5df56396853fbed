#!/usr/bin/env python3
"""``chip_smoke.py``'s ``sharded`` and ``ranks`` phases alone, for a machine
with up to four cards.

    python3 scripts/ranks_smoke.py [--seed 0]

Builds the CUDA kernels, synthesises the LoTTE Lifestyle index on cuda:0
as ``chip_smoke.py`` does (``make_index``, the same seed), runs the
``sharded`` phase (the index cut into 4 document shards stacked on one
card, its store, and the stack's results and latencies) and then the
``ranks`` phase over that store: a gloo world of 4 ranks sharing cuda:0
and an NCCL world of min(cards, 4) ranks, one card each, every rank's
results, launches and bytes held to the stack's (``phase_ranks``), and
``launch.serve --ranks``. Ties are judged at the scoring kernels' limit
``TOL`` (``chip_smoke.py`` uses the kernel phase's measured error, which
this script does not run). Prints each card's name and power limit and
exits nonzero when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    os.environ.setdefault("REPRO_AUTOTUNE_TABLE", os.devnull)

    import torch

    if not torch.cuda.is_available():
        print("ranks_smoke: torch.cuda.is_available() is False; this script runs on "
              "CUDA GPUs only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s; "
           f"{torch.cuda.device_count()} card(s): {cs.card()}")
    dev = torch.device("cuda")
    index = cs.make_index(torch, args.seed, dev)
    work = tempfile.mkdtemp(prefix="ranks_smoke_")
    try:
        sh = cs.phase_sharded(torch, index, dev, args.seed + 8, cs.TOL,
                              os.path.join(work, "sharded"))
        counts = cs.phase_ranks(torch, index, sh, args.seed + 13, cs.TOL, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    cs.log(json.dumps({"ranks_launches": counts}))
    cs.log(cs.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
