"""WARP engine of the PyTorch port: types, stages and the Retriever."""

from repro_torch.core.baselines import maxsim_bruteforce, plaid_style_search, xtr_reference
from repro_torch.core.engine import resolve_config, search, search_batch
from repro_torch.core.index import build_index, index_stats
from repro_torch.core.reduction import TopKResult, two_stage_reduce
from repro_torch.core.retriever import Retriever, SearchPlan
from repro_torch.core.types import IndexBuildConfig, WarpIndex, WarpSearchConfig, resolve_device
from repro_torch.core.warpselect import warp_select

__all__ = [
    "IndexBuildConfig",
    "Retriever",
    "SearchPlan",
    "TopKResult",
    "WarpIndex",
    "WarpSearchConfig",
    "build_index",
    "index_stats",
    "maxsim_bruteforce",
    "plaid_style_search",
    "resolve_config",
    "resolve_device",
    "search",
    "search_batch",
    "two_stage_reduce",
    "warp_select",
    "xtr_reference",
]
