"""AdamW of the port, over an ordered dict of tensors. Counterpart of
``repro/train/optimizer.py``.

``m`` and ``v`` are float32, ``step`` an int32 tensor, and the learning
rate and bias corrections are float32 tensors computed as JAX computes
them. ``adamw_update`` updates the parameters, ``m`` and ``v`` in place
(under ``torch.no_grad``) and returns them (JAX returns new trees): at
full width the state leaves no room on the card for a second copy.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm", "schedule"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: dict) -> dict:
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = step.float()
    warm = torch.clamp(step / max(1, cfg.warmup_steps), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """Scale every gradient by min(1, max_norm / ||grads||), the norm over
    every leaf (the embedding included) in float32."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict) -> tuple[dict, dict, dict]:
    """One step: clip, ``lr = schedule(step + 1)``, Adam moments, bias
    corrections ``1 - beta^step`` in float32, and the decay added to the
    update (not to the gradient). -> (params, opt state, {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float()
        m, v = state["m"][name], state["v"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        p.sub_((lr * delta).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"lr": lr, "grad_norm": gnorm}
