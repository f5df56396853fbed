#!/usr/bin/env python3
"""The ragged worklist kernel's split on one GPU: how many blocks to launch.

    python3 scripts/bench_ragged_split.py [--factors 1,2,4] [--seed 0]

``csrc/ragged_fused_gather_score.cu`` launches blocks that each take an
equal contiguous range of worklist tiles. Ranges of padding tiles finish
at once, so with one wave of blocks the SMs that hold them idle; with more
blocks the card's block scheduler refills those slots, at the cost of
shorter blocks. The kernel launches one block per ``kTilesPerBlock``
tiles, between one and ``kOversubscribe`` times the blocks the card holds
at once. This script builds it once per factor f, always launching f times
the blocks the card holds (a copy of the source with ``kTilesPerBlock``
set to 1 and ``kOversubscribe`` to f), and once as it is ("kept"), one
``nvcc`` each, in parallel, under ``build/bench_ragged/``; it times each
build at the kernel phase's inputs of ``chip_smoke.py``
(the synthetic LoTTE Lifestyle index from ``--seed``; one query of 32
tokens, the batched retrieve's 4 and the server's largest batch of 8, at
the adaptive rung, tile_c 32):
  - in the order of the builds and back (a, b, c, c, b, a), median of 25
    CUDA-event-timed launches after a 256 MB L2 flush each (chip_smoke's
    ``time_cuda``);
  - without the flush, each launch queued behind a spin kernel so that
    the host's launch is not timed;
  - under ``torch.profiler``, 25 launches back to back: the mean device
    time of the kernel alone, as a retrieve's profile reports it;
  - with every tile made padding (nvalid 0: the launch, the tiles' round
    trip and the zero fill, no rows);
beside an empty kernel timed after the same flush. Every build is first
held to the plain version within 1e-4. Prints one JSON line with the
card's name and power limit; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

SOURCE = "ragged_fused_gather_score"
PER_BLOCK = re.compile(r"constexpr int kTilesPerBlock = \d+;")
FACTOR = re.compile(r"constexpr int kOversubscribe = \d+;")


def build(factors) -> dict:
    """{"f": entry point launching f waves, ..., "kept": the source's}:
    patched copies of the source compiled in parallel."""
    from repro_torch.kernels import _build

    out_root = os.path.join(ROOT, "build", "bench_ragged")
    src = (_build.CSRC / f"{SOURCE}.cu").read_text()
    if not (PER_BLOCK.search(src) and FACTOR.search(src)):
        raise SystemExit("kTilesPerBlock or kOversubscribe not found in the kernel source")
    variants = {"kept": src}
    for f in factors:
        fixed = PER_BLOCK.sub("constexpr int kTilesPerBlock = 1;", src)
        variants[str(f)] = FACTOR.sub(f"constexpr int kOversubscribe = {f};", fixed)
    procs = {}
    for f, text in variants.items():
        d = os.path.join(out_root, f)
        os.makedirs(d, exist_ok=True)
        shutil.copy(_build.CSRC / "score_rows.cuh", d)
        with open(os.path.join(d, f"{SOURCE}.cu"), "w") as fh:
            fh.write(text)
        lib = os.path.join(d, f"lib{SOURCE}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, os.path.join(d, f"{SOURCE}.cu")]
        procs[f] = (subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE), lib)
    fns = {}
    for f, (proc, lib) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for build {f}: {err.decode()[-2000:]}")
        fn = getattr(ctypes.CDLL(lib), f"warp_{SOURCE}")
        fn.argtypes = _build.KERNELS[SOURCE][1]
        fn.restype = ctypes.c_int
        fns[f] = fn
    return fns


def time_warm(torch, fn, iters: int = 25) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs
    without a flush, each queued behind a ~0.1 ms spin kernel so that the
    host's launch of ``fn`` is not inside the timed interval."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(200_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[iters // 2]


def time_profiled(torch, fn, iters: int = 25) -> float:
    """Mean device milliseconds of the kernels ``fn`` launches, over
    ``iters`` launches back to back under ``torch.profiler`` (no flush, no
    launch latency: what a retrieve's profile reports per kernel)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
             if SOURCE in e.key)
    return us / iters / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--factors", default="1,2,4")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    factors = [int(x) for x in args.factors.split(",")]
    names = [str(f) for f in factors] + ["kept"]

    import torch

    if not torch.cuda.is_available():
        print("bench_ragged_split: needs a CUDA GPU", file=sys.stderr)
        return 2
    from repro_torch.core import Retriever, WarpSearchConfig
    from repro_torch.kernels import _build, ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    fns = build(factors)
    dev = torch.device("cuda")
    index = cs.make_index(torch, args.seed, dev)
    cfg = Retriever.from_index(index, device=dev).plan(WarpSearchConfig(
        nprobe=cs.ARCH["nprobe"], k=cs.ARCH["k"], k_impute=cs.ARCH["k_impute"],
        gather="fused", layout="ragged", executor="kernel",
    )).config
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stream = _build.stream_ptr(dev)
    codes = index.packed_codes
    n, pb = codes.shape
    # An empty kernel timed the same way: what any launch costs here.
    result = {"card": smi, "builds": names, "ms": {
        "empty kernel": cs.time_cuda(torch, lambda: torch.cuda._sleep(0), flush),
    }}
    for n_queries, seed in ((1, 12345), (4, 54321), (8, 8888)):
        starts, sizes, pscore, v = cs.kernel_probes(torch, index, cfg, n_queries, seed)
        work, rung = cs.kernel_worklist(torch, cfg, starts, sizes, pscore, cfg.tile_c, n_queries)
        w, tile = work.row0.numel(), cfg.tile_c
        kw = dict(nbits=index.nbits, dim=index.dim, tile_c=tile)
        want = ref.ragged_fused_gather_score(codes, *work, v, **kw)
        out = torch.empty(w * tile, device=dev)

        def launch(fn):
            rc = fn(codes.data_ptr(), *(a.data_ptr() for a in work), v.data_ptr(), out.data_ptr(),
                    n, w, tile, v.shape[0], pb, index.dim, index.nbits, stream)
            if rc:
                raise SystemExit(f"launch failed: {rc}")

        host_ms = {}
        for f, fn in fns.items():
            out.fill_(float("nan"))
            launch(fn)
            err = float((out - want).abs().max())
            if not err <= cs.TOL:
                raise SystemExit(f"build {f}: max abs err {err} vs the plain version")
            # Does the launch call wait for the device? Time it on the host
            # behind a spin kernel of ~50 ms.
            torch.cuda.synchronize()
            torch.cuda._sleep(100_000_000)
            t0 = time.perf_counter()
            launch(fn)
            host_ms[f] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        times = {f: [] for f in names}
        for f in names + names[::-1]:
            times[f].append(cs.time_cuda(torch, lambda: launch(fns[f]), flush))
        key = f"Q {32 * n_queries}: W {w}, rung {rung}, {int(work.nvalid.sum())} valid rows, " \
              f"{int((work.nvalid == 0).sum())} padding tiles"
        result["ms"][key] = dict(times)
        result["ms"][key]["host ms of one launch call behind a ~50 ms spin kernel"] = host_ms
        # Without the flush: the worklist, the v-tables and the output stay
        # in L2 as the previous kernels of a retrieve leave them.
        result["ms"][key]["no flush"] = {
            f: time_warm(torch, lambda: launch(fns[f])) for f in names
        }
        result["ms"][key]["profiled"] = {
            f: time_profiled(torch, lambda: launch(fns[f])) for f in names
        }
        # The same launch over padding tiles only: the launch, the tiles'
        # round trip and the zero fill, no rows.
        valid = work.nvalid.clone()
        work.nvalid.zero_()
        result["ms"][key]["padding only"] = {
            f: cs.time_cuda(torch, lambda: launch(fns[f]), flush) for f in names
        }
        work.nvalid.copy_(valid)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
