"""Scoring kernels of the PyTorch port: CUDA C++ for sm_90a (``csrc/``),
their wrappers, and the plain PyTorch versions they are held against."""

from repro_torch.kernels._build import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
