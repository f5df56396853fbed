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

``--ranks N`` trains an LM, recsys or GNN arch over a (data, model) mesh of N
ranks (``--mesh D,M``, (1, N) by default; ``launch/ranks.py::run_mesh``),
as JAX's step does under its shardings: NCCL on the cards (one rank a
card), gloo on the CPU (``--device cpu``) or on one card named with its
index (``--backend gloo --device cuda:0``). Every rank draws the weights
and the global batch as one process does and keeps its blocks and rows
(``train.shard_batch``, JAX's microbatch order; gin-tu's replicated
weights and its block of every node and edge array); the checkpoints are the
one-process files (rank 0 writes them), so a run resumes on a mesh of
another shape or in one process. Rank 0 prints.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --steps 6 --ranks 4 --mesh 2,2 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \
      --steps 6 --ranks 4 --mesh 2,2 [--device cpu]
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
from repro_torch.models.convert import train_layout
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainState, shard_batch


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
    ap.add_argument("--ranks", type=int, default=None,
                    help="train over a (data, model) mesh of N ranks (the LM, recsys and GNN "
                    "archs)")
    ap.add_argument("--mesh", default=None, help="the mesh's shape as D,M (default 1,N)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' backend (default: nccl on the cards, gloo on the CPU)")
    args = ap.parse_args(argv)
    if args.ranks is not None:
        return _over_ranks(args)
    return _train(args)


def _over_ranks(args) -> int:
    from repro_torch.launch.ranks import run_mesh

    if get_arch(args.arch).family.name == "warp":
        raise SystemExit("warp-xtr is a serving arch; use launch.serve")
    shape = tuple(int(d) for d in args.mesh.split(",")) if args.mesh else (1, args.ranks)
    if len(shape) != 2 or shape[0] * shape[1] != args.ranks:
        raise SystemExit(f"--mesh {args.mesh} is not a (data, model) shape of {args.ranks} ranks")
    cpu = args.device == "cpu"
    backend = args.backend or ("gloo" if cpu else "nccl")
    device = args.device if cpu or backend == "gloo" else None
    run_mesh(_rank, shape, backend=backend, device=device, args=(args,))
    return 0


def _rank(mesh, args) -> None:
    args.device = str(mesh.device)
    _train(args, mesh)


def _train(args, mesh=None) -> int:
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
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
    step_fn = fam.step_fn(arch, shape, reduced=True, **({} if mesh is None else {"mesh": mesh}))
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
        if mesh is not None:  # this rank's rows, in JAX's microbatch order
            out = shard_batch(out, mesh, arch.train_microbatches)
        return out

    g = torch.Generator(device=dev).manual_seed(args.seed)
    layout = None if mesh is None else train_layout(cfg, mesh)
    state = TrainState.create(init_params(cfg, g, device=dev, mesh=mesh), layout=layout)
    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, start = ckpt.restore_checkpoint(args.ckpt_dir, state, layout=layout)
            say(f"[resume] step {start}")

    for step in range(start, args.steps):
        state, metrics = step_fn(state, make_batch(step))
        if (step + 1) % max(1, args.steps // 10) == 0:
            say(f"step {step+1}/{args.steps} loss={float(metrics['loss']):.4f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save_checkpoint(args.ckpt_dir, step + 1, state, layout=layout)
            if mesh is None or mesh.rank == 0:
                ckpt.retain_last(args.ckpt_dir, 3)
    say("done" if mesh is None else f"done ({mesh.size} ranks, mesh {tuple(mesh.devices_shape)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
