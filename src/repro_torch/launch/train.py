"""Training launcher of the PyTorch port: train a registered LM arch on
synthetic batches. Counterpart of ``repro/launch/train.py``, with its
flags and ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --ckpt-dir /tmp/run1 [--device cpu]

It runs on ``--device`` (cuda by default, raising without CUDA; pass
``--device cpu`` for the CPU). As in JAX, ``--reduced`` is on whatever
the command line says, so the arch's reduced config is trained. Each
batch array is drawn from ``numpy.random.default_rng([seed, step,
crc32(name)])``: a pure function of (seed, step, name) in every process,
so a run resumed from ``--ckpt-dir`` (the newest committed step) trains
on the batches the interrupted run would have. (JAX keys it by
``hash(name)``, which Python salts per process.) The recsys and GNN
families do not train in the port yet.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from repro_torch.configs.families import LM_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.core.types import resolve_device
from repro_torch.models.convert import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainState


def batch_key(seed: int, step: int, name: str) -> list[int]:
    """The numpy seed of batch array ``name`` at ``step``."""
    return [seed, step, zlib.crc32(name.encode())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    fam = arch.family
    if fam.name == "warp":
        raise SystemExit("warp-xtr is a serving arch; use launch.serve")
    if fam.name != "lm":
        raise NotImplementedError(
            f"{args.arch}: {fam.name} training is not yet ported (the recsys losses wait "
            "for a later slice of the port)"
        )
    if LM_SHAPES[args.shape].kind != "train":
        raise SystemExit(f"{args.shape} is not a training shape")
    dev = resolve_device(args.device)

    specs = fam.input_specs(arch, args.shape, reduced=True)
    step_fn = fam.step_fn(arch, args.shape, reduced=True)

    def make_batch(step: int) -> dict:
        out = {}
        for name, (shape, _) in specs.items():
            r = np.random.default_rng(batch_key(args.seed, step, name))
            out[name] = torch.from_numpy(r.integers(0, 64, shape).astype(np.int32)).to(dev)
        return out

    g = torch.Generator(device=dev).manual_seed(args.seed)
    state = TrainState.create(init_params(arch.reduced, g, device=dev))
    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore_checkpoint(args.ckpt_dir, state)
            print(f"[resume] step {start}")

    for step in range(start, args.steps):
        state, metrics = step_fn(state, make_batch(step))
        if (step + 1) % max(1, args.steps // 10) == 0:
            print(f"step {step+1}/{args.steps} loss={float(metrics['loss']):.4f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, step + 1, state)
            ckpt.retain_last(args.ckpt_dir, 3)
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
