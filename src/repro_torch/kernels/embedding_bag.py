"""Embedding-bag kernel wrapper (EmbeddingBag(sum), padded form).

``embedding_bag`` computes out[s] = sum_l w[s, l] * table[idx[s, l]]: the
CUDA kernel ``csrc/embedding_bag.cu`` on a CUDA tensor, the plain version
``ref.embedding_bag_bags`` on a CPU tensor. Counterpart of
``repro/kernels/embedding_bag.py::embedding_bag_kernel_call``; as there, an
index outside [0, V) contributes exactly 0. One launch takes any S, L, V
and D: no padding to tiles. The table may be a view whose rows are any
number of floats apart (its columns contiguous), and it is never copied:
a table of millions of rows is read where it lies.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

__all__ = ["embedding_bag", "embedding_bag_cuda"]

_INDEX_DTYPES = (torch.int32, torch.int64)


def embedding_bag(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """table f32[V, D], bag_indices int32/int64[S, L], bag_weights f32[S, L]
    -> f32[S, D]."""
    if table.device.type == "cpu":
        return ref.embedding_bag_bags(table, bag_indices, bag_weights)
    return embedding_bag_cuda(table, bag_indices, bag_weights)


def embedding_bag_cuda(
    table: torch.Tensor, bag_indices: torch.Tensor, bag_weights: torch.Tensor
) -> torch.Tensor:
    """The CUDA kernel (one warp per bag)."""
    dev = _build.cuda_device(table)
    if table.dtype != torch.float32:
        raise ValueError(
            f"table has dtype {table.dtype}; the kernel takes float32 (a table is "
            "not copied to cast it)"
        )
    if table.dim() != 2:
        raise ValueError(f"table has shape {tuple(table.shape)}; expected [V, D]")
    v, d = table.shape
    if d > 1 and table.stride(1) != 1:
        raise ValueError("table needs contiguous columns (stride 1 along D)")
    if bag_indices.dim() != 2 or bag_indices.dtype not in _INDEX_DTYPES:
        raise ValueError(
            f"bag_indices is {bag_indices.dtype} of shape {tuple(bag_indices.shape)}; "
            "expected int32 or int64 [S, L]"
        )
    s, l = bag_indices.shape
    _build.require(bag_indices, "bag_indices", bag_indices.dtype, dev)
    _build.require(bag_weights, "bag_weights", torch.float32, dev, (s, l))
    if s == 0 or l == 0 or d == 0:
        return torch.zeros((s, d), dtype=torch.float32, device=dev)
    out = torch.empty((s, d), dtype=torch.float32, device=dev)
    lib = _build.library("embedding_bag")
    rc = lib.warp_embedding_bag(
        table.data_ptr(), bag_indices.data_ptr(), bag_weights.data_ptr(), out.data_ptr(),
        s, l, d, v, table.stride(0), int(bag_indices.dtype == torch.int64),
        _build.stream_ptr(dev),
    )
    _build.check("embedding_bag", rc)
    _build.LAUNCHES["embedding_bag"] += 1
    return out
