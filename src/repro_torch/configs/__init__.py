"""Model configurations of the PyTorch port (its own copies of the JAX
package's ``repro/configs``), each module with ``CONFIG``, ``REDUCED``,
``SOURCE`` and ``get_def``; ``registry`` lists them by ``--arch`` name and
``families`` holds the family entry points and their shapes."""

from repro_torch.configs.families import (
    LM_SHAPES,
    LM_SHAPES_REDUCED,
    RECSYS_SHAPES,
    RECSYS_SHAPES_REDUCED,
    LMShape,
    RecsysShape,
)
from repro_torch.configs.registry import ARCHS, get_arch, list_archs

__all__ = [
    "ARCHS", "get_arch", "list_archs", "LMShape", "LM_SHAPES", "LM_SHAPES_REDUCED",
    "RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED", "RecsysShape",
]
