"""What one step costs: FLOPs, HBM bytes and collective traffic, counted
while it runs. The port's counterpart of ``repro/launch/hlo_cost.py``
and ``hlo_analysis.py``, which read the same three numbers out of XLA's
optimized HLO text; the port has no HLO, so it counts the eager ops as
they dispatch:

  flops  — per ATen op: the matmul, convolution and attention formulas of
           ``torch.utils.flop_counter`` (2 · M · N · K per product), plus
           one flop per output element of a pointwise op;
  bytes  — per ATen op: its tensor operands' bytes plus its outputs'
           bytes, each op an HBM round trip as each fusion is in
           ``hlo_cost.py``. Views, allocations and metadata move nothing;
           a copy or fill writes its destination without reading it; a
           gather (``index``, ``embedding``, ...) reads the rows it
           returns, and a scatter writes the rows it is given, not the
           whole table;
  kernels — each hand-written CUDA kernel reports its own work, once per
           call, from its ``work(...)`` function beside the wrapper
           (``kernel``): the kernels are bound with ``ctypes``, so no
           dispatch mode sees them. While a kernel wrapper runs the
           counter counts none of the ATen ops inside it, so a call on the
           CPU (the plain version) and on the card (the kernel) count the
           same work;
  collectives — per-device link traffic of each collective a
           ``RankGroup`` runs (``collective``), by the ring formulas of
           ``hlo_analysis.py`` (``collective_bytes``).

    with StepCost() as c:
        step(state, batch)
    c.flops, c.bytes, c.collective_bytes, c.kernels

``mesh_train_collectives`` reckons, from a config and a mesh shape, the
collectives a train step over the mesh runs (``train/loop.py``), op by
op: what ``StepCost.op_counts`` must count.
"""

from __future__ import annotations

import collections
import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

__all__ = ["StepCost", "active", "collective", "collective_bytes", "kernel", "COLLECTIVES",
           "mesh_train_collectives"]

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute", "broadcast",
)

_aten = torch.ops.aten
# Ops that allocate or describe tensors without moving their bytes.
_NO_TRAFFIC = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten._local_scalar_dense, _aten.lift_fresh,
    _aten.detach, _aten.alias, _aten.set_, _aten.resize_,
}
# Gathers: the source is read only at the rows returned (operand 0).
_GATHERS = {_aten.index, _aten.index_select, _aten.embedding, _aten.gather, _aten.take}
# Writes into operand 0 without reading it.
_OVERWRITES = {_aten.copy_, _aten.fill_, _aten.zero_}
# Scatters into operand 0 in place: only the given rows are written.
_SCATTERS = {
    _aten.index_put_, _aten.index_add_, _aten.index_copy_, _aten.scatter_, _aten.scatter_add_,
    _aten.scatter_reduce_, _aten._index_put_impl_,
}

_ACTIVE: list = []


def active() -> "StepCost | None":
    """The innermost counter running, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def collective_bytes(op: str, nbytes: float, group: int) -> float:
    """Per-device link traffic of one collective over ``group`` ranks, by
    the ring formulas of ``repro/launch/hlo_analysis.py``: ``nbytes`` is
    the operand's bytes, the gathered output's for an all-gather.

      all-reduce:         2 * S * (n-1)/n
      all-gather:         S_out * (n-1)/n   (received bytes)
      reduce-scatter:     S_in * (n-1)/n
      all-to-all:         S * (n-1)/n
      collective-permute: S
      broadcast:          S * (n-1)/n       (received bytes; the port's own)
    """
    if op not in COLLECTIVES:
        raise ValueError(f"{op!r} is not one of {COLLECTIVES}")
    group = max(2, int(group))
    factor = (group - 1) / group
    if op == "all-reduce":
        return 2.0 * nbytes * factor
    if op == "collective-permute":
        return float(nbytes)
    return nbytes * factor


def _nbytes(t) -> int:
    if not isinstance(t, torch.Tensor) or t.is_meta:
        return 0
    return t.numel() * t.element_size()


class _Dispatch(TorchDispatchMode):
    def __init__(self, cost: "StepCost"):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.cost._quiet == 0:
            self.cost._aten(func, args, kwargs, out)
        return out


class StepCost:
    """Counts the work of everything run inside it (see the module).
    Totals: ``flops``, ``bytes`` (the ATen ops' plus the kernels'),
    ``aten_flops``, ``aten_bytes``, ``n_ops``; ``kernels`` maps each
    ``LAUNCHES`` name to ``{"calls", "flops", "bytes"}`` and
    ``kernel_calls`` lists each call as (name, work function, shapes);
    ``collectives`` is ``{"per_op": {op: bytes}, "total_bytes", "n_ops"}``
    like ``hlo_analysis.collective_traffic``'s."""

    def __init__(self):
        self.aten_flops = 0.0
        self.aten_bytes = 0.0
        self.n_ops = 0
        self.kernels: dict = {}
        self.kernel_calls: list = []
        self.per_op: dict = collections.defaultdict(float)
        self.op_counts: dict = collections.defaultdict(int)  # collectives by op
        self.n_collectives = 0
        self._quiet = 0
        self._mode = None

    def __enter__(self) -> "StepCost":
        _ACTIVE.append(self)
        self._mode = _Dispatch(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        self._mode = None
        _ACTIVE.remove(self)

    # ---- totals ----
    @property
    def kernel_flops(self) -> float:
        return float(sum(k["flops"] for k in self.kernels.values()))

    @property
    def kernel_bytes(self) -> float:
        return float(sum(k["bytes"] for k in self.kernels.values()))

    @property
    def flops(self) -> float:
        return self.aten_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        return self.aten_bytes + self.kernel_bytes

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.per_op.values()))

    @property
    def collectives(self) -> dict:
        return {"per_op": dict(self.per_op), "total_bytes": self.collective_bytes,
                "n_ops": self.n_collectives}

    # ---- counting ----
    def _aten(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if func.is_view or packet in _NO_TRAFFIC:
            return
        self.n_ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if packet in flop_registry:
            self.aten_flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.aten_flops += float(sum(t.numel() for t in outs))
        operands = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if packet in _GATHERS and operands:
            # the source is read at the returned rows only
            nbytes = sum(map(_nbytes, outs)) * 2 + sum(map(_nbytes, operands[1:]))
        elif packet in _SCATTERS and operands:
            # the destination is written (and read) at the given rows only
            nbytes = 2 * sum(map(_nbytes, operands[1:]))
        elif packet in _OVERWRITES and operands:
            nbytes = sum(map(_nbytes, operands[1:])) + sum(map(_nbytes, outs))
        else:
            nbytes = sum(map(_nbytes, operands)) + sum(map(_nbytes, outs))
        self.aten_bytes += float(nbytes)

    def add_kernel(self, name: str, work, shapes: dict) -> tuple[float, float]:
        flops, nbytes = work(**shapes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += float(flops)
        k["bytes"] += float(nbytes)
        self.kernel_calls.append((name, work, shapes))
        return flops, nbytes

    def add_collective(self, op: str, nbytes: float, group: int) -> None:
        self.per_op[op] += collective_bytes(op, nbytes, group)
        self.op_counts[op] += 1
        self.n_collectives += 1


def _resolve(v):
    """A shape argument: an int, a tensor scalar, or a callable giving
    either (data-dependent work, read only while counting)."""
    if callable(v):
        v = v()
    return int(v) if isinstance(v, torch.Tensor) else v


@contextlib.contextmanager
def kernel(name: str, work, **shapes):
    """Around one call of a kernel wrapper: the active counter (if any)
    adds ``work(**shapes)`` under ``name`` (the kernel's ``LAUNCHES``
    name) and counts none of the ATen ops run inside. Shapes that depend
    on the data may be passed as callables; they run only while a counter
    is active."""
    c = active()
    if c is None:
        yield
        return
    c._quiet += 1  # the reckoning of data-dependent shapes is not the step's work
    try:
        c.add_kernel(name, work, {k: _resolve(v) for k, v in shapes.items()})
        yield
    finally:
        c._quiet -= 1


def collective(op: str, nbytes: float, group: int) -> None:
    """Report one collective of ``nbytes`` (see ``collective_bytes``) over
    ``group`` ranks to the active counter, if any."""
    c = active()
    if c is not None:
        c.add_collective(op, nbytes, group)


def mesh_train_collectives(cfg, shape: tuple[int, int], *, microbatches: int = 1,
                           executor: str = "kernel") -> dict:
    """The collectives one train step of ``cfg`` runs over a (data, model)
    mesh of ``shape``, by op, as the layers' code implies (an op over axes
    of one rank runs nothing). Per microbatch, for the LM with L layers:

      forward   all-gather: each layer's weights split over the data axes
                  (FSDP, one collective), the head's, and a gathered MoE
                  dispatch's tokens, over
                  data; the D-split embedding, V-split logits and a tied
                  D-split head's table over model
                all-reduce: each layer's two row-parallel sums (after wo,
                  after the FFN or MoE), a vocab-split embedding over model;
                  the loss's numerator and count, and a local dispatch's
                  aux, over data
      backward  reduce-scatter: each forward gather over data (FSDP, tokens)
                all-reduce: each ``copy_to`` over model (the attention's
                  and FFN's inputs, the experts' input and gate weights, the
                  q/k norm scales, the head's input)
      remat     each layer's forward collectives again, but its last sum
                  (recomputation stops at the layer's last saved tensor)

    and once per step: one all-reduce of the gradients replicated over the
    data axes, one over model for kv heads shared by several model ranks,
    a reduce-scatter and an all-gather per ZeRO-1 parameter, one all-reduce
    of the global norm's squares over the mesh (compression adds one of the
    maxes). The recsys models: their takes' and bags' model
    sums, DIN's ``copy_to`` of the bag weights, two-tower's gather of the
    item embeddings (reduce-scattered back) and of log_q, the loss's sums.
    A tied D-split head is taken to see more positions a microbatch than
    d_model (as at train_4k), so it gathers its table.

    GIN (``GINConfig``, L layers, D = [data > 1], g = [graph readout]):

      forward   per layer an all-gather of the node rows and a
                  reduce-scatter of the messages' partial sums, over data;
                  the readout's reduce-scatter of the graphs' sums (g); one
                  all-reduce of the loss's numerator and count
      backward  each layer's transposes (a reduce-scatter of the gathered
                  rows' gradient, an all-gather of the summed messages'),
                  but layer 0's: its input x takes no gradient, so neither
                  collective runs; the readout's all-gather (g)

    so all-gathers D·(2L - 1 + g), reduce-scatters D·(2L - 1 + g) and
    all-reduces D; the step adds the replicated gradients' all-reduce over
    data (D) and the norm's over the mesh, none over model."""
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.convert import train_layout
    from repro_torch.models.gnn import GINConfig
    from repro_torch.models.transformer import TransformerConfig

    d, m = (int(x) for x in shape)
    mesh = make_mesh((d, m), ("data", "model"))
    D, M = d > 1, m > 1
    n = collections.Counter()
    if isinstance(cfg, TransformerConfig):
        moe = cfg.moe
        gathered_tokens = moe is not None and not moe.local_dispatch and D
        fsdp_w = 1  # a layer's FSDP weights (wq, wk, wv, wo, the FFN's or experts') in one gather
        # Each layer's forward; remat runs it again in the backward, up to the
        # layer's last saved tensor: all but the final sum (after the FFN).
        again = 1 if cfg.remat else 0
        per = collections.Counter()
        per["all-gather"] += cfg.n_layers * D * (fsdp_w + gathered_tokens) * (1 + again)
        per["all-reduce"] += cfg.n_layers * M * (2 + again)
        per["reduce-scatter"] += cfg.n_layers * D * (fsdp_w + gathered_tokens)
        per["all-reduce"] += cfg.n_layers * M * (2 + (1 if moe is not None else 0)
                                                 + (2 if cfg.qk_norm else 0))
        if cfg.embed_shard == "d":
            per["all-gather"] += M
        elif cfg.embed_shard == "vocab":
            per["all-reduce"] += M
        if not cfg.tie_embeddings:  # the V-split head: its FSDP gather, the logits' gather
            per["all-gather"] += D + M
            per["reduce-scatter"] += D
            per["all-reduce"] += M
        elif cfg.embed_shard == "vocab":  # the V-split product gathered; copy_to's sum
            per["all-gather"] += M
            per["all-reduce"] += M
        elif cfg.embed_shard == "d":  # the table gathered
            per["all-gather"] += M
        per["all-reduce"] += D * (2 + (moe is not None and moe.local_dispatch))
        layout = train_layout(cfg, mesh)
        zero1 = [k for k in layout.param_specs if D and layout.zero1_dim(k) is not None]
        bucket = any(sharding.grad_sync_axes(sp, mesh) and layout.zero1_dim(k) is None
                     for k, sp in layout.param_specs.items())
        shared = cfg.n_kv_heads < m
    elif isinstance(cfg, GINConfig):
        per = collections.Counter()
        passes = 2 * cfg.n_layers - 1 + (cfg.readout == "graph")
        per["all-gather"] += D * passes
        per["reduce-scatter"] += D * passes
        per["all-reduce"] += D
        zero1, bucket, shared = [], D, False
    else:
        per = _recsys_collectives(cfg, D, M, executor)
        zero1, bucket, shared = [], D, False
    for op, k in per.items():
        n[op] += microbatches * k
    n["all-reduce"] += int(bool(bucket)) + int(shared)
    n["reduce-scatter"] += len(zero1)
    n["all-gather"] += len(zero1)
    if d * m > 1:
        n["all-reduce"] += 1
    return {op: int(k) for op, k in sorted(n.items()) if k}


def _recsys_collectives(cfg, D: bool, M: bool, executor: str) -> collections.Counter:
    """Per (micro)batch collectives of a recsys model's train step (see
    ``mesh_train_collectives``)."""
    from repro_torch.models.recsys import DINConfig, SASRecConfig, TwoTowerConfig, XDeepFMConfig

    kernel = executor == "kernel"
    per = collections.Counter()
    if isinstance(cfg, TwoTowerConfig):  # a bag or a take per tower; the in-batch gathers
        per["all-reduce"] += 2 * M
        per["all-gather"] += 2 * D
        per["reduce-scatter"] += D
        per["all-reduce"] += D
    elif isinstance(cfg, SASRecConfig):  # the history, positives and negatives; two sums
        per["all-reduce"] += 3 * M + 2 * D
    elif isinstance(cfg, XDeepFMConfig):  # the table and the linear term
        per["all-reduce"] += 2 * M + D
    elif isinstance(cfg, DINConfig):  # target and history takes, the bag and its copy_to
        per["all-reduce"] += (2 + 2 * kernel) * M + D
    return per
