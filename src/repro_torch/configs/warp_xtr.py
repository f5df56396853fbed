"""warp-xtr: the paper's own engine at LoTTE scale (this paper, SIGIR'25).
The port's copy of ``repro/configs/warp_xtr.py``: ``CONFIG`` is the full
width, ``REDUCED`` the small one."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.warp_family import WARP_SHAPES, WARP_SHAPES_REDUCED, WarpArchConfig
from repro_torch.core.types import WarpSearchConfig

CONFIG = WarpArchConfig(nprobe=32, k=100)
REDUCED = WarpArchConfig(nprobe=8, k=10, k_impute=16)
SOURCE = "this paper (SIGIR'25)"


def search_config(shape: str, reduced: bool = False) -> WarpSearchConfig:
    """The search config of ``shape`` with ``t_prime`` and ``k_impute``
    resolved for its geometry, as the JAX family's ``search_config``
    resolves them; the executor stays "auto" (the plan picks it from the
    index's device)."""
    cfg = REDUCED if reduced else CONFIG
    s = (WARP_SHAPES_REDUCED if reduced else WARP_SHAPES)[shape]
    base = WarpSearchConfig(
        nprobe=min(cfg.nprobe, max(4, s.n_centroids // 2)),
        k=min(cfg.k, s.n_docs),
        k_impute=min(cfg.k_impute, max(4, s.n_centroids // 2)),
    )
    return dataclasses.replace(
        base,
        t_prime=base.resolved_t_prime(s.n_tokens),
        k_impute=base.resolved_k_impute(max(4, s.n_centroids)),
    )
