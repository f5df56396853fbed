"""warp-xtr: the paper's own engine at LoTTE scale (this paper, SIGIR'25).
The port's copy of ``repro/configs/warp_xtr.py``: ``CONFIG`` is the full
width, ``REDUCED`` the small one."""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.warp_family import WarpArchConfig, WarpFamily
from repro_torch.core.types import WarpSearchConfig

CONFIG = WarpArchConfig(nprobe=32, k=100)
REDUCED = WarpArchConfig(nprobe=8, k=10, k_impute=16)
SOURCE = "this paper (SIGIR'25)"


def search_config(shape: str, reduced: bool = False) -> WarpSearchConfig:
    """``WarpFamily.search_config`` of warp-xtr's ``shape``."""
    return WarpFamily.search_config(get_def(), shape, reduced=reduced)


def get_def() -> ArchDef:
    return ArchDef(
        name="warp-xtr", family=WarpFamily, config=CONFIG, reduced=REDUCED,
        shapes=("search_lifestyle", "search_pooled", "qps_pooled_b8"), source=SOURCE,
    )
