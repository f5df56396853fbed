"""The dry run of the port: every (arch x shape) cell run for real on the
card, with its memory, its counted FLOPs, bytes and collective traffic,
its roofline terms and its MFU. Counterpart of ``repro/launch/dryrun.py``,
which lowers and compiles each cell for a TPU mesh without running it; the
port has no compiler to ask, so it runs the step and counts it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch warp-xtr --ranks 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --ranks 4
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gin-tu --ranks 4 --mesh 4,1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu --reduced

For each cell (``run_cell``):

  (a) reckon the bytes of the state and the inputs from the family's
      ``abstract_state`` and ``input_specs`` (nothing allocated);
  (b) cut only what does not fit in the card's free memory: the depth
      while the state alone does not fit, then the batch (users, rows or
      candidates), then the depth again; a step that runs out of memory
      halves the batch (then the depth) and runs again. Each cut is
      listed in the record's ``reduced``;
  (c) materialize the state from ``seed`` on the device: parameters by
      ``models/convert.py::init_params`` (``TrainState`` for a train cell,
      bf16 weights for the LM's serving cells), the warp index by
      ``warp_family.synth_index``, and a batch of the cell's inputs;
  (d) run ``step_fn`` once untimed, then ``iters`` times, each timed with
      CUDA events (the median is ``p50_ms``), the peak from
      ``torch.cuda.max_memory_allocated`` after a reset;
  (e) count one more step under ``launch/cost.py``'s ``StepCost``;
      the kernel launches it made (``_build.LAUNCHES``) beside each
      kernel's calls and work (``kernels``, ``kernel_calls``);
  (f) write one JSON record to ``<out>/<mesh>/<arch>__<shape>.json``,
      ``<mesh>`` "single" or "ranks<N>", with JAX's keys where they mean
      the same, and ``measured.{p50_ms, peak_bytes, mfu}``,
      ``peak_flops``, ``reduced`` and ``device.{name, power_limit}``.

MFU is the analytic ``model_flops`` of what ran (the cut cell) over p50 x
devices x ``roofline.peak_for`` the step's compute dtype. ``--ranks N``
runs the warp cells over a world of N shard ranks (``launch/ranks.py``:
NCCL on the cards, gloo on the CPU), each rank cutting its own shard of
the synthetic index (``distributed.rank_shard``); rank 0 times and counts,
and its collectives come from the counter. For the LM, recsys and GNN
families ``--ranks N`` runs the cells over a (data, model) mesh of N
ranks (``--mesh D,M``, (1, N) by default; ``launch/ranks.py::run_mesh``):
the LM and recsys serving and train cells, and gin-tu's train cells.
Every rank materializes its own blocks of the state and the inputs,
placed by the family's ``state_pspec`` and ``input_pspec``
(``long_500k``'s cache split by sequence; a train batch drawn whole and
cut by ``train.shard_batch`` in JAX's microbatch order, the moments ZeRO-1
where the arch's experts are ``tp_only``; a graph drawn whole and each
node and edge array cut over the data axes, GIN's parameters replicated),
and runs the step; rank 0's time, peak and counted work (its collectives
counted per op in ``collectives.counts``: all-reduces, all-gathers and
reduce-scatters, a train step's backward and remat recomputation
included) make the record, ``mesh`` "ranks<N>", MFU over N devices. The
fit reckons each rank's share as 1/N of the state and inputs, times the
ranks that share a card. A failing cell is recorded with
``ok: false``, its error and traceback, and the run exits 1. Nothing falls
back to the CPU or to a plain version.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import tempfile
import time
import traceback

import numpy as np
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.configs.registry import all_cells, get_arch
from repro_torch.launch import cost, roofline

__all__ = ["device_info", "main", "resolve_work", "run_cell", "spec_bytes"]

# The share of the card's free memory the reckoned state and inputs may
# take; the rest is left to the step's activations.
FIT_SHARE = 0.9


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them ({"name": "cpu",
    "power_limit": None} on the CPU)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    name, limit = (x.strip() for x in line.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


def _pairs(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _pairs(v)
    else:
        yield tree


def spec_bytes(tree) -> int:
    """Bytes of a tree of (shape, dtype) pairs."""
    return int(sum(
        int(np.prod(dims, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        for dims, dtype in _pairs(tree)
    ))


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def _new_bytes(out, inputs) -> int:
    """Bytes of the tensors of ``out`` that are not storage of ``inputs``
    (a train step updates its state in place; a cache comes back as the
    same tensors)."""
    seen = {t.untyped_storage().data_ptr() for t in _tensors(inputs)}
    return int(sum(t.numel() * t.element_size() for t in _tensors(out)
                   if t.untyped_storage().data_ptr() not in seen))


# ---------------------------------------------------------------------------
# the cell as it runs: its config, its batch and its cuts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Cell:
    arch: ArchDef  # the arch as run (its depth may be cut)
    shape: str
    shape_obj: object  # the family's shape at the batch run
    reduced: bool
    cuts: list

    @property
    def family(self):
        return self.arch.family

    @property
    def config(self):
        return self.arch.reduced if self.reduced else self.arch.config


def _shapes(fam, reduced: bool) -> dict:
    from repro_torch.configs import families
    from repro_torch.configs.warp_family import WARP_SHAPES, WARP_SHAPES_REDUCED

    return {
        "lm": (families.LM_SHAPES_REDUCED if reduced else families.LM_SHAPES),
        "gnn": (families.GNN_SHAPES_REDUCED if reduced else families.GNN_SHAPES),
        "recsys": (families.RECSYS_SHAPES_REDUCED if reduced else families.RECSYS_SHAPES),
        "warp": (WARP_SHAPES_REDUCED if reduced else WARP_SHAPES),
    }[fam.name]


def _batch_field(fam, s) -> str | None:
    """The field of the family's shape that is cut as its batch."""
    if fam.name == "lm":
        return "global_batch"
    if fam.name == "recsys":
        return "n_candidates" if s.kind == "retrieval" else "batch"
    if fam.name == "warp":
        return "batch"
    return None  # a graph is not cut


def _with_batch(cell: _Cell, n: int) -> _Cell:
    field = _batch_field(cell.family, cell.shape_obj)
    old = getattr(cell.shape_obj, field)
    what = {"global_batch": "batch", "batch": "batch", "n_candidates": "candidates"}[field]
    return dataclasses.replace(
        cell, shape_obj=dataclasses.replace(cell.shape_obj, **{field: n}),
        cuts=cell.cuts + [f"{what} {old} -> {n}"],
    )


def _with_depth(cell: _Cell, n_layers: int) -> _Cell:
    cfg = dataclasses.replace(cell.config, n_layers=n_layers)
    arch = dataclasses.replace(cell.arch, **{"reduced" if cell.reduced else "config": cfg})
    return dataclasses.replace(cell, arch=arch,
                               cuts=cell.cuts + [f"layers {cell.config.n_layers} -> {n_layers}"])


def _halve_batch(cell: _Cell) -> _Cell | None:
    """The cell at half its batch, or None at a batch of 1. A train step
    splits its batch into the arch's ``train_microbatches``: at one row
    per microbatch, the microbatches are halved with the batch."""
    field = _batch_field(cell.family, cell.shape_obj)
    if field is None or getattr(cell.shape_obj, field) < 2:
        return None
    half = getattr(cell.shape_obj, field) // 2
    mb = cell.arch.train_microbatches
    if cell.shape_obj.kind != "train" or half >= mb:
        return _with_batch(cell, half)
    arch = dataclasses.replace(cell.arch, train_microbatches=max(1, mb // 2))
    out = _with_batch(dataclasses.replace(cell, arch=arch), half)
    out.cuts[-1] += f" (microbatches {mb} -> {arch.train_microbatches})"
    return out


def _cut_once(cell: _Cell) -> _Cell:
    """The batch halved, else the depth."""
    half = _halve_batch(cell)
    if half is not None:
        return half
    if cell.family.name == "lm" and cell.config.n_layers > 1:
        return _with_depth(cell, cell.config.n_layers // 2)
    raise MemoryError(f"{cell.arch.name}/{cell.shape} does not fit and has nothing left to cut "
                      f"(cut so far: {'; '.join(cell.cuts) or 'nothing'})")


def _batch_axis_specs(cell: _Cell, specs: dict) -> dict:
    """The family's input specs at the cell's (possibly cut) batch: each
    input's batch axis (axis 0, a cache's axis 1) resized."""
    fam, s_full = cell.family, _shapes(cell.family, cell.reduced)[cell.shape]
    field = _batch_field(fam, s_full)
    if field is None:
        return specs
    full, n = getattr(s_full, field), getattr(cell.shape_obj, field)

    def resize(name, spec, axis):
        if isinstance(spec, dict):
            return {k: resize(k, v, 1 if k in ("k", "v") else 0) for k, v in spec.items()}
        dims, dtype = spec
        if len(dims) > axis and dims[axis] == full:
            dims = dims[:axis] + (n,) + dims[axis + 1:]
        return (tuple(dims), dtype)

    return {k: resize(k, v, 0) for k, v in specs.items()}


def _reckon(cell: _Cell, n_shards: int = 1) -> tuple[int, int]:
    fam = cell.family
    kw = {"n_shards": n_shards} if fam.name == "warp" else {}
    state = fam.abstract_state(cell.arch, cell.shape, reduced=cell.reduced, **kw)
    inputs = _batch_axis_specs(cell, fam.input_specs(cell.arch, cell.shape, reduced=cell.reduced))
    return spec_bytes(state), spec_bytes(inputs)


def _fit(cell: _Cell, budget: int | None, n_shards: int = 1) -> _Cell:
    """Cut the depth while the state alone overflows ``budget``, then the
    batch (then the depth) while state and inputs do."""
    if budget is None:
        return cell
    while (_reckon(cell, n_shards)[0] > budget and cell.family.name == "lm"
           and cell.config.n_layers > 1):
        cell = _with_depth(cell, cell.config.n_layers // 2)
    while sum(_reckon(cell, n_shards)) > budget:
        cell = _cut_once(cell)
    return cell


# ---------------------------------------------------------------------------
# materializing a cell
# ---------------------------------------------------------------------------


def _ints(g, hi: int, dims, dev) -> torch.Tensor:
    return torch.randint(0, max(1, int(hi)), tuple(dims), generator=g, device=dev,
                         dtype=torch.int32)


def _lm(cell: _Cell, g, dev):
    from repro_torch.models import KVCache, TransformerLM, init_params
    from repro_torch.train.loop import TrainState

    cfg, s = cell.config, cell.shape_obj
    b, sl = s.global_batch, s.seq_len
    if s.kind == "train":
        state = TrainState.create(init_params(cfg, g, device=dev))
        return state, {"tokens": _ints(g, cfg.vocab, (b, sl), dev),
                       "labels": _ints(g, cfg.vocab, (b, sl), dev)}
    model = TransformerLM.from_params(cfg, init_params(cfg, g, device=dev, dtype=torch.bfloat16))
    cache = KVCache.empty(cfg, b, sl, device=dev)
    if s.kind == "prefill":
        return model, {"tokens": _ints(g, cfg.vocab, (b, sl), dev), "cache": cache}
    cache.length.fill_(sl - 1)  # decode one token against a cache of sl - 1
    return model, {"tokens": _ints(g, cfg.vocab, (b,), dev), "cache": cache}


def _gnn(cell: _Cell, g, dev, mesh=None):
    """The cell's state and graph; over ``mesh``, this rank's replicated
    state and its block of every node and edge array (the graph drawn
    whole first, so every rank draws alike)."""
    from repro_torch.launch import sharding
    from repro_torch.models import init_params
    from repro_torch.models.convert import train_layout
    from repro_torch.train.loop import TrainState

    s = cell.shape_obj
    cfg = cell.family._cfg_for(cell.arch, s, cell.reduced)
    batch = {
        "x": torch.randn(s.n_nodes, s.d_feat, generator=g, device=dev),
        "edge_src": _ints(g, s.n_nodes, (s.n_edges,), dev),
        "edge_dst": _ints(g, s.n_nodes, (s.n_edges,), dev),
        "labels": _ints(g, s.n_classes, (s.n_graphs or s.n_nodes,), dev),
    }
    if s.batch_nodes:
        batch["edge_mask"] = torch.ones(s.n_edges, device=dev)
        batch["label_mask"] = (torch.arange(s.n_nodes, device=dev) < s.batch_nodes).float()
        batch["labels"] = _ints(g, s.n_classes, (s.n_nodes,), dev)
    if s.n_graphs:
        batch["graph_ids"] = torch.repeat_interleave(
            torch.arange(s.n_graphs, device=dev, dtype=torch.int32), s.n_nodes // s.n_graphs)
    if mesh is None:
        return TrainState.create(init_params(cfg, g, device=dev)), batch
    batch = sharding.local_batch(batch, cell.family.input_pspec(cell.arch, cell.shape, mesh), mesh)
    params = init_params(cfg, g, device=dev, mesh=mesh)
    return TrainState.create(params, layout=train_layout(cfg, mesh)), batch


def _recsys(cell: _Cell, g, dev):
    from repro_torch.models import init_params
    from repro_torch.models.recsys import RECSYS_MODELS
    from repro_torch.train.loop import TrainState

    batch = _recsys_batch(cell, g, dev)
    params = init_params(cell.config, g, device=dev)
    if cell.shape_obj.kind == "train":
        return TrainState.create(params), batch
    return RECSYS_MODELS[type(cell.config)].from_params(cell.config, params), batch


def _recsys_batch(cell: _Cell, g, dev) -> dict:
    cfg = cell.config
    specs = _batch_axis_specs(cell, cell.family.input_specs(cell.arch, cell.shape,
                                                            reduced=cell.reduced))
    batch = {}
    for name, (dims, dtype) in specs.items():
        if dtype == torch.int32:
            vocab = cfg.user_vocab if name.startswith("user") else getattr(
                cfg, "item_vocab", getattr(cfg, "vocab", None))
            batch[name] = _ints(g, vocab, dims, dev)
        elif "mask" in name:
            batch[name] = torch.ones(dims, device=dev)
        elif name == "labels":
            batch[name] = _ints(g, 2, dims, dev).float()
        else:
            batch[name] = torch.randn(dims, generator=g, device=dev)
    return batch


def _warp_queries(index, cfg, batch: int, g):
    """Noisy unit copies of random centroids, 8..Q active tokens each."""
    dev, qm = index.device, cfg.query_maxlen
    n = max(1, batch)
    cids = torch.randint(0, index.n_centroids, (n, qm), generator=g, device=dev)
    q = index.centroids[cids] + 0.04 * torch.randn(n, qm, cfg.dim, generator=g, device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    active = torch.randint(min(8, qm), qm + 1, (n, 1), generator=g, device=dev)
    qmask = torch.arange(qm, device=dev) < active
    q = q * qmask.unsqueeze(-1)
    if batch > 1:
        return {"q": q, "qmask": qmask}
    return {"q": q[0], "qmask": qmask[0]}


def _search_config(cell: _Cell, search_overrides):
    scfg = cell.family.search_config(cell.arch, cell.shape, reduced=cell.reduced)
    return dataclasses.replace(scfg, **(search_overrides or {}))


def _warp(cell: _Cell, g, dev, seed: int, search_overrides):
    from repro_torch.configs.warp_family import synth_index
    from repro_torch.core import Retriever

    index = synth_index(cell.config, cell.shape_obj, seed, dev)
    plan = Retriever.from_index(index, device=dev).plan(_search_config(cell, search_overrides))
    return plan, _warp_queries(index, cell.config, cell.shape_obj.batch, g)


def _materialize(cell: _Cell, dev, seed: int, search_overrides=None):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    name = cell.family.name
    if name == "lm":
        return _lm(cell, g, dev)
    if name == "gnn":
        return _gnn(cell, g, dev)
    if name == "recsys":
        return _recsys(cell, g, dev)
    return _warp(cell, g, dev, seed, search_overrides)


def _dtype(cell: _Cell) -> torch.dtype:
    """The dtype the cell's products run in: the LM's compute dtype, else
    float32."""
    return cell.config.dtype if cell.family.name == "lm" else torch.float32


# ---------------------------------------------------------------------------
# timing, counting, the record
# ---------------------------------------------------------------------------


def _time(step, state, batch, dev, iters: int):
    """Median ms of ``iters`` timed steps after one untimed, the peak
    bytes allocated over them (None on the CPU) and the last output."""
    out = step(state, batch)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = int(torch.cuda.max_memory_allocated(dev))
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = step(state, batch)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = None
    return statistics.median(times), peak, out


def _count(step, state, batch, dev) -> tuple[cost.StepCost, dict]:
    """One step under ``StepCost``, and the kernel launches it made
    (``_build.LAUNCHES``, by name)."""
    from repro_torch.kernels import _build

    before = dict(_build.LAUNCHES)
    with cost.StepCost() as c:
        step(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return c, {k: n - before[k] for k, n in _build.LAUNCHES.items() if n != before[k]}


def _kernels(c: cost.StepCost, launches: dict) -> tuple[dict, list]:
    """The record's ``kernels`` (each LAUNCHES name's calls, work and
    launches in the counted step) and ``kernel_calls`` (each call's name,
    work function and shapes)."""
    out = {name: dict(k, launches=launches.get(name, 0)) for name, k in c.kernels.items()}
    for name, n in launches.items():
        out.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0, "launches": n})
    calls = [[name, f"{work.__module__}:{work.__name__}", shapes]
             for name, work, shapes in c.kernel_calls]
    return out, calls


def _record(arch: ArchDef, shape, cell: _Cell, *, mesh: str, n_devices: int, dev, p50_ms,
            peak, arg_bytes: int, out_bytes: int, c: cost.StepCost, launches: dict,
            reckoned) -> dict:
    """The cell's record: ``model_flops`` is the whole cell's (``arch``
    at the cell's uncut shape, the reduced one with ``reduced``), MFU
    reads the FLOPs of what ran (``cell``, ``model_flops_run``)."""
    peak_flops = roofline.peak_for(_dtype(cell))
    terms = roofline.roofline_terms(
        per_device_flops=c.flops, per_device_bytes=c.bytes,
        per_device_collective_bytes=c.collective_bytes, n_devices=n_devices,
        peak_flops=peak_flops,
    )
    whole = dataclasses.replace(arch, config=arch.reduced if cell.reduced else arch.config)
    mf = roofline.model_flops(whole, shape, shape_obj=_shapes(arch.family, cell.reduced)[shape])
    mf_run = roofline.model_flops(dataclasses.replace(cell.arch, config=cell.config), shape,
                                  shape_obj=cell.shape_obj)
    bound = terms["step_lower_bound_s"]
    terms["model_mfu_at_bound"] = mf_run / (n_devices * peak_flops) / bound if bound else 0.0
    temp = None if peak is None else max(0, peak - arg_bytes - out_bytes)
    kernels, calls = _kernels(c, launches)
    return {
        "arch": arch.name,
        "shape": shape,
        "mesh": mesh,
        "n_devices": n_devices,
        "ok": True,
        "device": device_info(dev),
        "peak_flops": peak_flops,
        "reduced": list(cell.cuts),
        "reckoned": {"state_bytes": reckoned[0], "input_bytes": reckoned[1]},
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "total_per_device": peak if peak is not None else arg_bytes + out_bytes,
        },
        "per_device_flops": c.flops,
        "per_device_bytes": c.bytes,
        "kernels": kernels,
        "kernel_calls": calls,
        "collectives": {**c.collectives, "counts": dict(c.op_counts)},
        "roofline": terms,
        "model_flops": mf,
        "model_flops_run": mf_run,
        "useful_flops_ratio": mf_run / max(1.0, terms["hlo_flops_global"]),
        "measured": {
            "p50_ms": p50_ms,
            "peak_bytes": peak,
            "mfu": mf_run / (p50_ms * 1e-3 * n_devices * peak_flops),
        },
    }


def resolve_work(ref: str):
    """The work function a record's ``kernel_calls`` names ("module:name")."""
    import importlib

    module, name = ref.split(":")
    return getattr(importlib.import_module(module), name)


def _free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _resolve(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the dry run runs on the card by default — "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def run_cell(
    arch_name: str,
    shape: str,
    *,
    device="cuda",
    reduced: bool = False,
    ranks: int | None = None,
    seed: int = 0,
    iters: int = 5,
    arch: ArchDef | None = None,
    search_overrides: dict | None = None,
    verbose: bool = True,
    mesh: tuple[int, int] | None = None,
    backend: str | None = None,
    batch: int | None = None,
    layers: int | None = None,
) -> dict:
    """Run one cell on ``device`` and return its record (see the module).
    ``arch`` replaces the registry's ``ArchDef`` (``hillclimb``'s
    variants); ``search_overrides`` replace fields of a warp cell's
    ``search_config``; ``ranks`` runs a warp cell over that many shard
    ranks, any other cell over a (data, model) mesh of that many ranks
    (``mesh``, (1, ranks) by default). ``backend`` is the
    world's: NCCL on the cards (one rank per card) and gloo on the CPU by
    default; gloo with ``device="cuda:0"`` puts every rank on that card.
    ``batch`` and ``layers`` start an LM cell at that batch and depth
    (each listed as a cut), where the fit would only find them by running
    out of memory (it reckons the state, not a train step's gradients)."""
    dev = _resolve(device)
    arch = arch or get_arch(arch_name)
    if shape not in arch.shapes:
        raise KeyError(f"{shape!r} is not a shape of {arch_name}: {arch.shapes}")
    fam = arch.family
    cell = _Cell(arch, shape, _shapes(fam, reduced)[shape], reduced, [])
    field = _batch_field(fam, cell.shape_obj)
    if batch is not None and field is not None and batch != getattr(cell.shape_obj, field):
        cell = _with_batch(cell, batch)
    if layers is not None and fam.name == "lm" and layers != cell.config.n_layers:
        cell = _with_depth(cell, layers)
    if ranks is not None:
        if fam.name == "warp":
            return _run_ranked(arch_name, cell, dev, ranks, seed, iters, search_overrides,
                               verbose)
        return _run_mesh(cell, dev, ranks, mesh or (1, ranks), backend, seed, iters, verbose)
    reckoned = _reckon(cell)
    budget = int(torch.cuda.mem_get_info(dev)[0] * FIT_SHARE) if dev.type == "cuda" else None
    cell = _fit(cell, budget)
    while True:
        step = fam.step_fn(cell.arch, shape, reduced=reduced)
        state = batch = out = None
        try:
            state, batch = _materialize(cell, dev, seed, search_overrides)
            p50, peak, out = _time(step, state, batch, dev, iters)
            out_bytes = _new_bytes(out, (state, batch))
            out = None
            c, launches = _count(step, state, batch, dev)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        state = batch = out = None
        _free(dev)
        cell = _cut_once(cell)
        cell.cuts[-1] += " (out of memory)"
    arg_bytes = sum(_reckon(cell))
    state = batch = None
    _free(dev)
    rec = _record(arch, shape, cell, mesh="single", n_devices=1, dev=dev, p50_ms=p50,
                  peak=peak, arg_bytes=arg_bytes, out_bytes=out_bytes, c=c, launches=launches,
                  reckoned=reckoned)
    if verbose:
        _print(rec)
    return rec


def _print(rec: dict) -> None:
    t, m = rec["roofline"], rec["measured"]
    cut = "; ".join(rec["reduced"]) or "whole"
    peak = "n/a" if m["peak_bytes"] is None else f"{m['peak_bytes'] / 2**30:.2f} GiB"
    print(f"[{rec['mesh']}] {rec['arch']}/{rec['shape']}: p50 {m['p50_ms']:.3f} ms, peak "
          f"{peak}, mfu {m['mfu']:.4f}, bottleneck {t['bottleneck']} "
          f"({t['step_lower_bound_s'] * 1e3:.3f} ms bound), {cut}", flush=True)


# ---------------------------------------------------------------------------
# a warp cell over shard ranks
# ---------------------------------------------------------------------------


def _rank_body(group, arch_name, cell, seed, iters, search_overrides, out_path):
    """One rank of a ranked warp cell: the synthetic index made on the
    rank's device, its shard cut (``rank_shard``), a ``Retriever`` of it;
    rank 0 plans, times, counts and writes its numbers, ranks 1.. follow."""
    from repro_torch.configs.warp_family import synth_index
    from repro_torch.core import Retriever
    from repro_torch.core.distributed import rank_shard
    from repro_torch.serving import follow

    dev = group.device
    index = synth_index(cell.config, cell.shape_obj, seed, dev)
    shard = rank_shard(index, group)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    batch = _warp_queries(index, cell.config, cell.shape_obj.batch, g)
    del index
    _free(dev)
    retriever = Retriever(shard)
    if group.rank != 0:
        follow(group)
        return
    try:
        plan = retriever.plan(_search_config(cell, search_overrides))
        step = cell.family.step_fn(cell.arch, cell.shape, reduced=cell.reduced)
        p50, peak, out = _time(step, plan, batch, dev, iters)
        out_bytes = _new_bytes(out, batch)
        c, launches = _count(step, plan, batch, dev)
        arg_bytes = shard.nbytes() + sum(t.numel() * t.element_size() for t in _tensors(batch))
    finally:
        group.stop()
    with open(out_path, "w") as f:
        json.dump({"p50": p50, "peak": peak, "out_bytes": out_bytes, "arg_bytes": arg_bytes,
                   "aten_flops": c.aten_flops, "aten_bytes": c.aten_bytes, "n_ops": c.n_ops,
                   "kernels": c.kernels, "per_op": dict(c.per_op), "launches": launches,
                   "kernel_calls": [[n, f"{w.__module__}:{w.__name__}", sh]
                                    for n, w, sh in c.kernel_calls],
                   "n_collectives": c.n_collectives}, f)


def _run_ranked(arch_name, cell, dev, n, seed, iters, search_overrides, verbose) -> dict:
    from repro_torch.launch.ranks import run_world

    backend = "nccl" if dev.type == "cuda" else "gloo"
    reckoned = _reckon(cell, n)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        out_path = os.path.join(tmp, "rank0.json")
        run_world(_rank_body, n, backend=backend, device=None if dev.type == "cuda" else "cpu",
                  args=(arch_name, cell, seed, iters, search_overrides, out_path))
        with open(out_path) as f:
            got = json.load(f)
    c = cost.StepCost()
    c.aten_flops, c.aten_bytes, c.n_ops = got["aten_flops"], got["aten_bytes"], got["n_ops"]
    c.kernels, c.n_collectives = got["kernels"], got["n_collectives"]
    c.kernel_calls = [(n, resolve_work(w), sh) for n, w, sh in got["kernel_calls"]]
    c.per_op.update(got["per_op"])
    rank0 = torch.device("cuda", 0) if dev.type == "cuda" else dev
    rec = _record(cell.arch, cell.shape, cell, mesh=f"ranks{n}", n_devices=n, dev=rank0,
                  p50_ms=got["p50"], peak=got["peak"], arg_bytes=got["arg_bytes"],
                  out_bytes=got["out_bytes"], c=c, launches=got["launches"], reckoned=reckoned)
    if verbose:
        _print(rec)
    return rec


# ---------------------------------------------------------------------------
# an LM, recsys or GNN cell over a mesh of ranks
# ---------------------------------------------------------------------------


def _materialize_mesh(cell: _Cell, mesh, seed: int):
    """This rank's blocks of the cell's state and inputs: every rank draws
    the same numbers (one seeded generator on its device) and keeps its
    own blocks."""
    from repro_torch.launch import sharding
    from repro_torch.models import KVCache, TransformerLM, init_params
    from repro_torch.models.convert import train_layout
    from repro_torch.models.recsys import RECSYS_MODELS
    from repro_torch.train.loop import TrainState, shard_batch

    dev = mesh.device
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cfg, s = cell.config, cell.shape_obj
    if cell.family.name == "gnn":
        return _gnn(cell, g, dev, mesh)
    if s.kind == "train":  # the global batch drawn whole, the rank's rows kept
        if cell.family.name == "recsys":
            batch = _recsys_batch(cell, g, dev)
        else:
            b, sl = s.global_batch, s.seq_len
            batch = {"tokens": _ints(g, cfg.vocab, (b, sl), dev),
                     "labels": _ints(g, cfg.vocab, (b, sl), dev)}
        batch = {k: v.clone() for k, v in shard_batch(
            batch, mesh, cell.arch.train_microbatches).items()}
        params = init_params(cfg, g, device=dev, mesh=mesh)
        return TrainState.create(params, layout=train_layout(cfg, mesh)), batch
    if cell.family.name == "recsys":
        batch = sharding.local_batch(_recsys_batch(cell, g, dev),
                                     cell.family.input_pspec(cell.arch, cell.shape, mesh), mesh)
        params = init_params(cfg, g, device=dev, mesh=mesh)
        return RECSYS_MODELS[type(cfg)].from_params(cfg, params, mesh=mesh), batch
    params = init_params(cfg, g, device=dev, dtype=torch.bfloat16, mesh=mesh)
    model = TransformerLM.from_params(cfg, params, mesh=mesh)
    specs = cell.family.input_pspec(cell.arch, cell.shape, mesh)
    b, sl = s.global_batch, s.seq_len
    tokens = _ints(g, cfg.vocab, (b, sl) if s.kind == "prefill" else (b,), dev)
    tokens = sharding.local_block(tokens, specs["tokens"], mesh).clone()
    shard_seq = specs["cache"]["k"][2] is not None  # long_500k: the cache split by sequence
    shape = (cfg.n_layers, b, sl, cfg.n_kv_heads, cfg.resolved_head_dim)
    shape = sharding.local_shape(shape, specs["cache"]["k"], mesh)[:3] + (
        sharding.kv_heads_of_rank(cfg, mesh)[1], cfg.resolved_head_dim)
    cache = KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                    torch.zeros(shape, dtype=torch.bfloat16, device=dev),
                    torch.zeros(sharding.local_shape((b,), specs["cache"]["length"], mesh),
                                dtype=torch.int32, device=dev), seq_split=shard_seq)
    if s.kind == "decode":
        cache.length.fill_(sl - 1)  # decode one token against a cache of sl - 1
    return model, {"tokens": tokens, "cache": cache}


def _mesh_body(mesh, cell, seed, iters, out_path):
    """One rank of a cell over a mesh: its blocks materialized, the step
    timed and counted on every rank (they run in lockstep); rank 0 writes
    its numbers."""
    dev = mesh.device
    state, batch = _materialize_mesh(cell, mesh, seed)
    step = cell.family.step_fn(cell.arch, cell.shape, reduced=cell.reduced, mesh=mesh)
    p50, peak, out = _time(step, state, batch, dev, iters)
    out_bytes = _new_bytes(out, (state, batch))
    out = None
    c, launches = _count(step, state, batch, dev)
    arg_bytes = sum(t.numel() * t.element_size() for t in _tensors((state, batch)))
    if mesh.rank == 0:
        with open(out_path, "w") as f:
            json.dump({"p50": p50, "peak": peak, "out_bytes": out_bytes, "arg_bytes": arg_bytes,
                       "aten_flops": c.aten_flops, "aten_bytes": c.aten_bytes, "n_ops": c.n_ops,
                       "kernels": c.kernels, "per_op": dict(c.per_op),
                       "op_counts": dict(c.op_counts), "launches": launches,
                       "kernel_calls": [[n, f"{w.__module__}:{w.__name__}", sh]
                                        for n, w, sh in c.kernel_calls],
                       "n_collectives": c.n_collectives}, f)


def _run_mesh(cell: _Cell, dev, n: int, shape, backend, seed, iters, verbose) -> dict:
    from repro_torch.launch.ranks import run_mesh

    shape = tuple(int(d) for d in shape)
    if shape[0] * shape[1] != n:
        raise ValueError(f"a mesh of shape {shape} does not have {n} ranks")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cpu":
        world_dev, per_card = "cpu", n
    elif backend == "gloo" and dev.index is not None:
        world_dev, per_card = str(dev), n
    else:
        world_dev, per_card = None, 1 if backend == "nccl" else -(-n // torch.cuda.device_count())
    from repro_torch.launch.ranks import WorldFailed

    reckoned = _reckon(cell)
    if dev.type == "cuda":  # each rank holds ~1/n of the state and inputs
        cell = _fit(cell, int(torch.cuda.mem_get_info(dev)[0] * FIT_SHARE * n / per_card))
    while True:
        with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
            out_path = os.path.join(tmp, "rank0.json")
            try:
                run_mesh(_mesh_body, shape, backend=backend, device=world_dev,
                         args=(cell, seed, iters, out_path))
            except WorldFailed as e:  # a rank out of memory: cut, as one card does
                if "OutOfMemoryError" not in str(e):
                    raise
                cell = _cut_once(cell)
                cell.cuts[-1] += " (out of memory)"
                continue
            with open(out_path) as f:
                got = json.load(f)
            break
    c = cost.StepCost()
    c.aten_flops, c.aten_bytes, c.n_ops = got["aten_flops"], got["aten_bytes"], got["n_ops"]
    c.kernels, c.n_collectives = got["kernels"], got["n_collectives"]
    c.kernel_calls = [(k, resolve_work(w), sh) for k, w, sh in got["kernel_calls"]]
    c.per_op.update(got["per_op"])
    c.op_counts.update(got["op_counts"])
    rank0 = torch.device("cuda", dev.index or 0) if dev.type == "cuda" else dev
    rec = _record(cell.arch, cell.shape, cell, mesh=f"ranks{n}", n_devices=n, dev=rank0,
                  p50_ms=got["p50"], peak=got["peak"], arg_bytes=got["arg_bytes"],
                  out_bytes=got["out_bytes"], c=c, launches=got["launches"],
                  reckoned=(reckoned[0] // n, reckoned[1] // n))
    if verbose:
        _print(rec)
    return rec


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ranks", type=int, default=None,
                    help="run the warp cells over N shard ranks, the LM, recsys and gin-tu cells "
                    "over a mesh of N ranks (NCCL on the cards)")
    ap.add_argument("--mesh", default=None,
                    help="the (data, model) shape of the mesh as D,M (default 1,N)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="the ranks' backend (default: nccl on the cards, gloo on the CPU)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced configs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=None,
                    help="start each cell at this batch (listed as a cut)")
    ap.add_argument("--layers", type=int, default=None,
                    help="start each LM cell at this depth (listed as a cut)")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --all or --arch")
    _resolve(args.device)

    if args.all:
        cells = all_cells(include_warp=True)
    else:
        cells = [(args.arch, s) for s in ([args.shape] if args.shape else get_arch(args.arch).shapes)]
    mesh_shape = tuple(int(d) for d in args.mesh.split(",")) if args.mesh else None
    mesh = "single" if args.ranks is None else f"ranks{args.ranks}"
    outdir = os.path.join(args.out, mesh)
    os.makedirs(outdir, exist_ok=True)
    failures = 0
    for arch_name, shape in cells:
        try:
            rec = run_cell(arch_name, shape, device=args.device, reduced=args.reduced,
                           ranks=args.ranks, seed=args.seed, iters=args.iters, mesh=mesh_shape,
                           backend=args.backend, batch=args.batch, layers=args.layers)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures += 1
            rec = {
                "arch": arch_name,
                "shape": shape,
                "mesh": mesh,
                "ok": False,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"[FAIL] {mesh} {arch_name}/{shape}: {e}", flush=True)
        with open(os.path.join(outdir, f"{arch_name}__{shape}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        _free(torch.device(args.device))
    print(f"dry run complete; {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
