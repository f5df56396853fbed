"""WARP engine configurations: the port's copies of ``WarpArchConfig``,
``WarpShape``, ``WARP_SHAPES`` and ``WARP_SHAPES_REDUCED`` from
``repro/configs/warp_family.py`` (the LoTTE geometries of the paper's own
workload). The mesh and the sharded step functions are not ported."""

from __future__ import annotations

import dataclasses

__all__ = ["WARP_SHAPES", "WARP_SHAPES_REDUCED", "WarpArchConfig", "WarpShape"]


@dataclasses.dataclass(frozen=True)
class WarpArchConfig:
    dim: int = 128
    nbits: int = 4
    query_maxlen: int = 32
    nprobe: int = 32
    k: int = 100
    k_impute: int = 64


@dataclasses.dataclass(frozen=True)
class WarpShape:
    kind: str
    n_tokens: int
    n_docs: int
    n_centroids: int
    cap: int
    batch: int  # concurrent queries


WARP_SHAPES = {
    # LoTTE Lifestyle test: 23.71M tokens (paper Table 4).
    "search_lifestyle": WarpShape("serve", 23_710_000, 119_461, 1 << 17, 1024, 1),
    # LoTTE Pooled test: 660.04M tokens, 2.8M passages.
    "search_pooled": WarpShape("serve", 660_040_000, 2_819_103, 1 << 19, 2048, 1),
    # Pooled with a batch of 8 concurrent queries (throughput cell).
    "qps_pooled_b8": WarpShape("serve", 660_040_000, 2_819_103, 1 << 19, 2048, 8),
}

WARP_SHAPES_REDUCED = {
    "search_lifestyle": WarpShape("serve", 6000, 300, 64, 128, 1),
    "search_pooled": WarpShape("serve", 8000, 400, 64, 128, 1),
    "qps_pooled_b8": WarpShape("serve", 8000, 400, 64, 128, 4),
}
