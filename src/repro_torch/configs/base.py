"""ArchDef: one selectable architecture (``--arch <id>``) and its shape
cells. The port's copy of ``repro/configs/base.py``."""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ArchDef", "ShapeCell"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (architecture x input-shape) cell."""

    name: str
    kind: str  # train | prefill | decode | serve | retrieval
    meta: dict


@dataclasses.dataclass(frozen=True)
class ArchDef:
    name: str
    family: Any  # the family's entry point in the port (configs/families.py)
    config: Any  # full-scale model config (public-literature dims)
    reduced: Any  # small config for CPU tests
    shapes: tuple[str, ...]
    source: str = ""
    train_microbatches: int = 1
    notes: str = ""

    def cell(self, shape_name: str) -> ShapeCell:
        return self.family.shape_cell(self, shape_name)
