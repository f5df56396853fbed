"""WARP engine of the PyTorch port: types, stages and the Retriever."""

from repro_torch.core.engine import resolve_config, search, search_batch
from repro_torch.core.reduction import TopKResult, two_stage_reduce
from repro_torch.core.retriever import Retriever, SearchPlan
from repro_torch.core.types import WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import warp_select

__all__ = [
    "Retriever",
    "SearchPlan",
    "TopKResult",
    "WarpIndex",
    "WarpSearchConfig",
    "resolve_config",
    "resolve_device",
    "search",
    "search_batch",
    "two_stage_reduce",
    "warp_select",
]
