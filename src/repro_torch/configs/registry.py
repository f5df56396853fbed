"""``--arch <id>`` registry of the port: the port's copy of
``repro/configs/registry.py``, listing the archs the port has (the five
LMs, the four recsys models and warp-xtr). The JAX registry's ``gin-tu``
is absent until the GNN family is ported; ``get_arch`` says so."""

from __future__ import annotations

from repro_torch.configs import (
    dbrx_132b,
    din,
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

__all__ = ["ARCHS", "ASSIGNED", "NOT_PORTED", "get_arch", "list_archs", "all_cells"]

_MODULES = [
    mixtral_8x7b,
    dbrx_132b,
    qwen2_0_5b,
    yi_6b,
    qwen3_4b,
    two_tower_retrieval,
    sasrec,
    xdeepfm,
    din,
    warp_xtr,
]

ARCHS: dict[str, ArchDef] = {m.get_def().name: m.get_def() for m in _MODULES}
NOT_PORTED = ("gin-tu",)  # archs of the JAX registry the port does not have yet

# The assigned cells exclude warp-xtr (which adds 3 of its own).
ASSIGNED = [n for n in ARCHS if n != "warp-xtr"]


def get_arch(name: str) -> ArchDef:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch (the GNN family waits "
                       f"for a later slice); ported: {sorted(ARCHS)}")
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
