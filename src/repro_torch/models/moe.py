"""Mixture-of-Experts FFN of the port (Mixtral/DBRX style: top-k softmax
routing). Counterpart of ``repro/models/moe.py``.

Dispatch is JAX's static-capacity CSR gather: the (token, slot) pairs are
sorted by expert (a stable sort), each expert takes at most
``cap = max(1, int(capacity_factor * T * k / E))`` of them in that order,
and the rest are dropped (they add 0). Dropped pairs are by design, as in
JAX; at decode T is the batch, so most pairs are dropped there.

The combine is deterministic: each token's kept expert outputs are
summed in expert order, one rounding per add in the compute dtype, which
is the order in which JAX's ``segment_sum`` over the flattened [E, cap]
slots meets them. (``index_add_`` would add them with atomics on CUDA, in
an order that changes from run to run.)

``local_dispatch`` is JAX's ``shard_map`` over the data and model axes.
On one device it is the same function: one data shard holds every token
and the ``psum`` over a one-device axis adds nothing; its aux loss takes
the mean of the one-hot over (tokens, slots) at once, as JAX's local body
does. ``dispatch_data_axes``, ``dispatch_model_axis`` and the model
config's ``moe_weight_mode`` only place arrays on a TPU mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.warpselect import topk_lower_index_first
from repro_torch.models import layers as L

__all__ = ["MoEConfig", "MoE", "Dispatch", "moe_init", "route", "dispatch", "moe_apply"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    local_dispatch: bool = False
    dispatch_data_axes: tuple[str, ...] = ("data",)
    dispatch_model_axis: str = "model"

    def capacity(self, t: int) -> int:
        """Slots per expert for ``t`` tokens, in Python floats as JAX computes it."""
        return max(1, int(self.capacity_factor * t * self.top_k / self.n_experts))


class Dispatch(NamedTuple):
    order: torch.Tensor  # int64[T*k]: the stable sort of the flat pairs by expert
    counts: torch.Tensor  # int64[E]: pairs routed to each expert
    cap: int
    tok_idx: torch.Tensor  # int64[E, cap]: the token in each slot
    valid: torch.Tensor  # bool[E, cap]: slot < counts[e]
    gate_w: torch.Tensor  # f32[E, cap]: the slot's weight, 0 where not valid
    slot: torch.Tensor  # int64[T, k]: pair (t, j)'s slot e * cap + rank, -1 if dropped


def moe_init(generator: torch.Generator, cfg: MoEConfig, d_model: int, d_ff: int, *,
             device=None, dtype=torch.float32) -> dict:
    """Weights with JAX's distributions, drawn in float32 from ``generator``:
    the router normal * 1/sqrt(d_model) (stored [E, D]), gate and up
    [E, D, F] normal * 1/sqrt(d_model), down [E, F, D] normal *
    1/sqrt(d_ff). Keys are the ``MoE`` module's names."""
    e = cfg.n_experts

    def normal(*shape, fan):
        w = torch.randn(*shape, generator=generator, device=device)
        return w.mul_(1.0 / math.sqrt(fan)).to(dtype)

    return {
        "router.weight": normal(e, d_model, fan=d_model),
        "gate": normal(e, d_model, d_ff, fan=d_model),
        "up": normal(e, d_model, d_ff, fan=d_model),
        "down": normal(e, d_ff, d_model, fan=d_ff),
    }


def route(x: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """x [T, D], router weight [E, D] -> (probs f32[T, E], top_p f32[T, k]
    renormalised, top_e int64[T, k]): a float32 router, softmax, top-k with
    ``lax.top_k``'s tie order."""
    probs = torch.softmax(x.float() @ router_w.float().T, dim=-1)
    top_p, top_e = topk_lower_index_first(probs, cfg.top_k)
    return probs, top_p / top_p.sum(-1, keepdim=True), top_e


def dispatch(top_e: torch.Tensor, top_p: torch.Tensor, cfg: MoEConfig) -> Dispatch:
    """The static-capacity CSR dispatch of ``_moe_apply_global``: the flat
    (token, slot) pairs sorted stably by expert, ``cap`` slots per expert,
    positions clamped to T·k − 1, weight 0 past ``counts``."""
    t, k = top_e.shape
    e = cfg.n_experts
    cap = cfg.capacity(t)
    dev = top_e.device
    flat_e = top_e.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    stok = order // k  # the token of each sorted pair (flat index t * k + j)
    sw = top_p.reshape(-1)[order]
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(cap, device=dev)
    pos = (offsets.unsqueeze(-1) + ranks).clamp(max=t * k - 1)
    valid = ranks < counts.unsqueeze(-1)
    gate_w = torch.where(valid, sw[pos], torch.zeros((), device=dev))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    rank = inv - offsets[flat_e]
    slot = torch.where(rank < cap, flat_e * cap + rank, -1).reshape(t, k)
    return Dispatch(order, counts, cap, stok[pos], valid, gate_w, slot)


def moe_apply(params: dict, cfg: MoEConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (y [T, D] in ``x.dtype``, aux loss f32 scalar). The
    caller flattens batch x sequence. ``params``: "router" [E, D], "gate"
    and "up" [E, D, F], "down" [E, F, D]; the experts run in ``x.dtype``."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, top_p, top_e = route(x, params["router"], cfg)

    # Load-balancing auxiliary loss (Switch-style).
    me = probs.mean(0)
    onehot = F.one_hot(top_e, e).float()
    ce = onehot.mean((0, 1)) if cfg.local_dispatch else onehot.sum(1).mean(0) / k
    aux = e * torch.sum(me * ce)

    dsp = dispatch(top_e, top_p, cfg)
    xe = x[dsp.tok_idx]  # [E, cap, D]
    h = F.silu(torch.bmm(xe, params["gate"].to(x.dtype)))
    h = h * torch.bmm(xe, params["up"].to(x.dtype))
    ye = torch.bmm(h, params["down"].to(x.dtype))  # [E, cap, D]
    ye = (ye * dsp.gate_w.unsqueeze(-1).to(ye.dtype)).reshape(e * dsp.cap, d)

    # Each token's kept slots, in expert order (= flat slot order).
    by_expert = torch.sort(top_e, dim=-1).indices
    slot = torch.gather(dsp.slot, 1, by_expert)
    zero = torch.zeros((), dtype=ye.dtype, device=x.device)
    parts = torch.where((slot >= 0).unsqueeze(-1), ye[slot.clamp(min=0)], zero)  # [T, k, D]
    y = torch.zeros((t, d), dtype=ye.dtype, device=x.device)
    for j in range(k):
        y = y + parts[:, j]
    return y.to(x.dtype), aux


class MoE(nn.Module):
    """The MoE FFN's parameters: ``router.weight`` [E, D] (``Dense``'s
    layout), ``gate`` and ``up`` [E, D, F], ``down`` [E, F, D] (JAX's)."""

    def __init__(self, cfg: MoEConfig, d_model: int, d_ff: int):
        super().__init__()
        self.cfg = cfg
        e = cfg.n_experts
        self.router = L.Dense(d_model, e)
        self.gate = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.up = nn.Parameter(torch.empty(e, d_model, d_ff))
        self.down = nn.Parameter(torch.empty(e, d_ff, d_model))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        params = {"router": self.router.weight, "gate": self.gate, "up": self.up, "down": self.down}
        return moe_apply(params, self.cfg, x)
