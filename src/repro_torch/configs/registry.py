"""``--arch <id>`` registry of the port: the port's copy of
``repro/configs/registry.py``, listing every arch of the JAX registry in
its order (the five LMs, gin-tu, the four recsys models and warp-xtr)."""

from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    din,
    gin_tu,
    mixtral_8x7b,
    qwen2_0_5b,
    qwen3_4b,
    sasrec,
    two_tower_retrieval,
    warp_xtr,
    xdeepfm,
    yi_6b,
)
from repro_torch.configs.base import ArchDef

__all__ = ["ARCHS", "ASSIGNED", "get_arch", "list_archs", "all_cells"]

_MODULES = [
    mixtral_8x7b,
    dbrx_132b,
    qwen2_0_5b,
    yi_6b,
    qwen3_4b,
    gin_tu,
    two_tower_retrieval,
    sasrec,
    xdeepfm,
    din,
    warp_xtr,
]

ARCHS: dict[str, ArchDef] = {m.get_def().name: m.get_def() for m in _MODULES}

# The assigned cells exclude warp-xtr (which adds 3 of its own).
ASSIGNED = [n for n in ARCHS if n != "warp-xtr"]


def get_arch(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def all_cells(include_warp: bool = True) -> list[tuple[str, str]]:
    return [
        (name, s)
        for name, arch in ARCHS.items()
        if include_warp or name != "warp-xtr"
        for s in arch.shapes
    ]
