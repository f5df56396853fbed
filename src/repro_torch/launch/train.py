"""Training launcher of the PyTorch port: train a registered arch (an LM,
gin-tu or a recsys model) on synthetic batches. Counterpart of
``repro/launch/train.py``, with its flags and ``--device``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 20 --ckpt-dir /tmp/run1 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch din --steps 6 [--device cpu]

It runs on ``--device`` (cuda by default, raising without CUDA; pass
``--device cpu`` for the CPU). As in JAX, ``--reduced`` is on whatever
the command line says, so the arch's reduced config is trained, on the
cell's input specs: integer inputs in [0, 64), masks all ones, float
inputs standard normal. ``--shape`` defaults to the arch's first train
shape (JAX's default, train_4k, names an LM shape only). Each batch array
is drawn from ``numpy.random.default_rng([seed, step, crc32(name)])``: a
pure function of (seed, step, name) in every process, so a run resumed
from ``--ckpt-dir`` (the newest committed step) trains on the batches the
interrupted run would have. (JAX keys it by ``hash(name)``, which Python
salts per process.) GIN's labels are drawn in [0, n_classes): JAX draws
them in [0, 64) too, and a label >= n_classes makes every loss NaN.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from repro_torch.configs.families import GNN_SHAPES_REDUCED
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
    ap.add_argument("--shape", default=None, help="a train shape of the arch (default: its first)")
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
    shape = args.shape or next(s for s in arch.shapes if arch.cell(s).kind == "train")
    if shape not in arch.shapes:
        raise SystemExit(f"{shape} is not a shape of {args.arch}: {arch.shapes}")
    if arch.cell(shape).kind != "train":
        raise SystemExit(f"{shape} is not a training shape")
    dev = resolve_device(args.device)

    specs = fam.input_specs(arch, shape, reduced=True)
    step_fn = fam.step_fn(arch, shape, reduced=True)
    cfg = arch.reduced
    if fam.name == "gnn":
        cfg = fam._cfg_for(arch, GNN_SHAPES_REDUCED[shape], True)

    def make_batch(step: int) -> dict:
        out = {}
        for name, (dims, dtype) in specs.items():
            r = np.random.default_rng(batch_key(args.seed, step, name))
            if "mask" in name:
                a = np.ones(dims, np.float32)
            elif dtype == torch.float32:
                a = r.standard_normal(dims).astype(np.float32)
            else:
                hi = cfg.n_classes if fam.name == "gnn" and name == "labels" else 64
                a = r.integers(0, hi, dims).astype(np.int32)
            out[name] = torch.from_numpy(a).to(dev)
        return out

    g = torch.Generator(device=dev).manual_seed(args.seed)
    state = TrainState.create(init_params(cfg, g, device=dev))
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
