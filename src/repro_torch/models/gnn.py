"""GIN (Graph Isomorphism Network, arXiv:1810.00826) with segment-sum
message passing, and the fanout neighbor sampler of ``minibatch_lg``.
Counterpart of ``repro/models/gnn.py``.

GIN update: h_v' = MLP((1 + eps) * h_v + sum_{u in N(v)} h_u). The
aggregation is a gather over the edge index and a segment sum, plain XLA
ops in JAX (no Pallas kernel), so plain torch ops here, with JAX's index
semantics kept exactly:

- ``h[edge_src]`` wraps a negative index once, then clamps into [0, n):
  at n = 4, -1 -> 3, -6 -> 0, 5 -> 3; the gradient of a clamped row is
  dropped (``gather_rows``);
- the segment sum drops every id outside [0, num_segments), negative
  ones included (``segment_sum``);
- the loss reads ``max(labels, 0)`` of the log-probabilities, and a label
  >= n_classes gives NaN, as ``take_along_axis``'s fill does.

The segment sum, and so the gather's backward, is deterministic on the
card: ``index_put_(..., accumulate=True)`` sorts its indices
(``index_add_`` would add with atomics). A dropped edge goes to one extra
row past the segments, sliced off after: no host sync, no copy of the
messages, and a NaN message there reaches no output.
``GIN.from_params`` builds the module from a state dict (``convert``'s),
dense layers in ``nn.Linear``'s [d_out, d_in] layout.

Over a (data, model) mesh of ranks (``forward(..., mesh=)``, ``loss(...,
mesh=)``; ``launch/mesh.py``) each rank holds the replicated parameters
and its block of every node and edge array, split over the data axes as
JAX's ``GNNFamily.input_pspec`` splits them; node and graph ids stay
global. A rank computes what JAX's step computes under those shardings:

- each layer all-gathers the node rows [N/D, d] over the data axes into
  the whole [N, d] (its backward reduce-scatters), gathers and sums the
  rank's edges into a partial [N, d] with N the global node count (so
  JAX's index semantics hold as above), and reduce-scatters that back to
  the rank's rows (its backward all-gathers); the rest of the layer runs
  on the rank's rows;
- the graph readout sums the rank's rows by their global ``graph_ids``
  into [n_graphs, H] and reduce-scatters it to the rank's block of graphs,
  the one its labels hold;
- the loss is global: its numerator and count are all-reduced over the
  data axes in one collective whose backward is the identity, so each
  rank's gradient is its own rows' share (``train.sync_grads`` sums
  them).

Ranks that differ only along the model axis hold the same blocks and run
the same ops, so they agree bit for bit. With no mesh, or one whose data
axes hold one rank, the code is the one-process code.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L

__all__ = ["GINConfig", "GIN", "gather_rows", "segment_sum", "neighbor_sample"]


@dataclasses.dataclass(frozen=True)
class GINConfig:
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 16
    learnable_eps: bool = True
    readout: str = "node"  # "node" (classification) | "graph" (sum pooling)


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[idx]`` as JAX indexes and differentiates it: a negative index
    wraps once, then every index is clamped into [0, n); the gradient of a
    row whose wrapped index lies outside [0, n) is dropped, as the
    transposed gather (XLA's scatter-add) drops it."""
    return _GatherRows.apply(h, idx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx):
        n = h.shape[0]
        idx = idx.long()
        wrapped = torch.where(idx < 0, idx + n, idx)
        ctx.save_for_backward(wrapped)
        ctx.n = n
        return h[wrapped.clamp(0, n - 1)]

    @staticmethod
    def backward(ctx, grad):
        (wrapped,) = ctx.saved_tensors
        return segment_sum(grad, wrapped, ctx.n), None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed by segment id, an id
    outside [0, num_segments) dropped. Deterministic: ``index_put_`` with
    accumulate sorts; a dropped row lands in an extra row that is sliced
    off."""
    seg = segment_ids.long()
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1, *data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_put_((seg,), data, accumulate=True)[:num_segments]


class _GINLayer(nn.Module):
    def __init__(self, d_in: int, d_hidden: int):
        super().__init__()
        self.mlp1 = L.Dense(d_in, d_hidden, bias=True)
        self.mlp2 = L.Dense(d_hidden, d_hidden, bias=True)
        self.eps = nn.Parameter(torch.zeros(()))


class GIN(nn.Module):
    """State dict: ``layers.{i}.{mlp1,mlp2}.{weight,bias}``,
    ``layers.{i}.eps`` (a scalar), ``head.{weight,bias}``."""

    def __init__(self, cfg: GINConfig):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1)
        self.layers = nn.ModuleList(_GINLayer(d, cfg.d_hidden) for d in dims)
        self.head = L.Dense(cfg.d_hidden, cfg.n_classes, bias=True)

    @classmethod
    def from_params(cls, cfg: GINConfig, params: dict, *, trainable: bool = False):
        """A model over ``params`` without copying them (see
        ``TransformerLM.from_params``); frozen unless ``trainable``."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(params, strict=True, assign=True)
        if not trainable:
            model.requires_grad_(False)
        return model

    def forward(self, x, edge_src, edge_dst, edge_mask=None, graph_ids=None, n_graphs=None, *,
                mesh=None):
        """x f32[N, d_feat], edge_src/edge_dst int[E], edge_mask [E] (padding),
        graph_ids int[N] and n_graphs for graph readout -> logits. Over
        ``mesh``: the rank's blocks of the node and edge arrays, and its
        rows (or graphs) of the logits (see the module)."""
        data = _data_axes(mesh)
        n = x.shape[0] if data is None else x.shape[0] * mesh.size_of(data)
        h = x
        for lp in self.layers:
            whole = h if data is None else mesh.all_gather(h, data, 0)
            msgs = gather_rows(whole, edge_src)  # gather
            del whole
            if edge_mask is not None:
                msgs = msgs * edge_mask[:, None]
            agg = segment_sum(msgs, edge_dst, n)  # scatter
            del msgs
            if data is not None:
                agg = mesh.reduce_scatter(agg, data, 0)
            h = (1.0 + lp.eps) * h + agg
            h = F.relu(lp.mlp1(h))
            h = F.relu(lp.mlp2(h))
        if self.cfg.readout == "graph":
            if graph_ids is None or n_graphs is None:
                raise ValueError("graph readout needs graph_ids and n_graphs")
            h = segment_sum(h, graph_ids, n_graphs)
            if data is not None:
                h = mesh.reduce_scatter(h, data, 0)
        return self.head(h)

    def loss(self, batch: dict, *, mesh=None):
        """The mean cross-entropy of the labels (over ``label_mask`` where
        given) -> (loss, {"ce": loss}); over ``mesh``, of the global batch
        from the rank's blocks."""
        logits = self(
            batch["x"], batch["edge_src"], batch["edge_dst"], batch.get("edge_mask"),
            batch.get("graph_ids"), batch.get("n_graphs"), mesh=mesh,
        )
        labels = torch.clamp_min(batch["labels"].long(), 0)
        mask = batch.get("label_mask")
        logp = torch.log_softmax(logits.float(), dim=-1)
        c = logp.shape[-1]
        picked = torch.take_along_dim(logp, labels.clamp_max(c - 1)[..., None], dim=-1)[..., 0]
        nll = torch.where(labels < c, -picked, math.nan)  # take_along_axis fills NaN
        data = _data_axes(mesh)
        if data is not None:  # the global numerator and count, one collective
            if mask is not None:
                num, count = torch.sum(nll * mask), torch.sum(mask)
            else:
                num, count = torch.sum(nll), torch.tensor(float(nll.numel()), device=nll.device)
            num, count = mesh.all_reduce(torch.stack([num, count]), data).unbind()
            loss = num / torch.clamp_min(count, 1)
        elif mask is not None:
            loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1)
        else:
            loss = torch.mean(nll)
        return loss, {"ce": loss}


def _data_axes(mesh):
    """The data axes of ``mesh`` when they hold more than one rank, else None."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import data_axes

    data = data_axes(mesh)
    return data if mesh.size_of(data) > 1 else None


def neighbor_sample(
    rng: np.random.Generator,
    indptr: np.ndarray,
    indices: np.ndarray,
    seed_nodes: np.ndarray,
    fanouts: tuple[int, ...],
):
    """Layer-wise fanout neighbor sampling (GraphSAGE-style) on a CSR graph.

    Returns a fixed-capacity padded subgraph:
      nodes   i64[n_sub]      original node ids (seed first)
      edge_src/edge_dst i32[E_cap] local ids, padded
      edge_mask bool[E_cap]
    Deterministic per (rng, seeds), and JAX's sampler draw for draw: the
    same ``Generator`` state gives the same output. This is the
    ``minibatch_lg`` data path.
    """
    frontier = np.asarray(seed_nodes, np.int64)
    all_nodes = [frontier]
    edges_src: list[np.ndarray] = []
    edges_dst: list[np.ndarray] = []
    for fanout in fanouts:
        src_list = []
        dst_list = []
        for v in frontier:
            lo, hi = indptr[v], indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            take = min(fanout, deg)
            picks = rng.choice(indices[lo:hi], size=take, replace=False)
            src_list.append(picks)
            dst_list.append(np.full(take, v, np.int64))
        if src_list:
            src = np.concatenate(src_list)
            dst = np.concatenate(dst_list)
            edges_src.append(src)
            edges_dst.append(dst)
            frontier = np.unique(src)
            all_nodes.append(frontier)
        else:
            break

    nodes = np.unique(np.concatenate(all_nodes))
    # seeds first for stable readout
    seeds = np.asarray(seed_nodes, np.int64)
    rest = np.setdiff1d(nodes, seeds, assume_unique=False)
    nodes = np.concatenate([seeds, rest])
    remap = {int(g): i for i, g in enumerate(nodes)}

    if edges_src:
        src = np.concatenate(edges_src)
        dst = np.concatenate(edges_dst)
        src_l = np.fromiter((remap[int(s)] for s in src), np.int32, len(src))
        dst_l = np.fromiter((remap[int(d)] for d in dst), np.int32, len(dst))
    else:
        src_l = np.zeros(0, np.int32)
        dst_l = np.zeros(0, np.int32)

    cap = int(len(seed_nodes) * math.prod(fanouts) * 1.25) + 8
    e = len(src_l)
    pad = max(0, cap - e)
    edge_mask = np.concatenate([np.ones(e, bool), np.zeros(pad, bool)])[:cap]
    src_p = np.concatenate([src_l, np.zeros(pad, np.int32)])[:cap]
    dst_p = np.concatenate([dst_l, np.zeros(pad, np.int32)])[:cap]
    return nodes.astype(np.int64), src_p, dst_p, edge_mask
