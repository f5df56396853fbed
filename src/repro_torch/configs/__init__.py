"""Model configurations of the PyTorch port (its own copies of the JAX
package's ``repro/configs``): qwen2-0.5b, the four recsys models
(two-tower-retrieval, din, xdeepfm, sasrec) and the recsys shapes, and
warp-xtr with the WARP shapes (``warp_family``, ``warp_xtr``)."""

from repro_torch.configs.families import RECSYS_SHAPES, RECSYS_SHAPES_REDUCED, RecsysShape

__all__ = ["RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED", "RecsysShape"]
