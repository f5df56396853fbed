"""Spherical k-means over token embeddings (index construction, paper
§4.1). Counterpart of ``repro/core/kmeans.py``.

Points are L2-normalized, so cosine similarity is a dot product and the
assignment is the argmax of one float32 matrix product (full precision:
the caller keeps TF32 off, as on the retrieval path).

Determinism on the card: ``index_add_`` of float32 on CUDA adds with
atomics in no fixed order, so float per-cluster sums would change from run
to run. A Lloyd step sums in int64 fixed point instead (each coordinate of
a unit vector rounded to a multiple of 2^-40, far below a float32 ulp of
the centroid): integer addition is exact, so the sums, and the centroids,
are the same bits whatever order the atomics add in.
"""

from __future__ import annotations

import torch

__all__ = [
    "ASSIGN_BUDGET_BYTES",
    "assign_block",
    "assign_clusters",
    "cluster_sums",
    "l2_normalize",
    "lloyd_step",
    "spherical_kmeans",
]

# Bytes of the float32 [block, C] product one assignment block may take.
ASSIGN_BUDGET_BYTES = 1 << 30
_MAX_BLOCK = 4096


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / ||x|| row-wise, float32. The squared norm is summed in float64
    (each product exact) and its inverse square root rounded once to
    float32, so the result is the same on every device."""
    ss = (x.double() ** 2).sum(dim=-1, keepdim=True)
    return x.float() * (1.0 / torch.sqrt(ss + eps)).float()


def assign_block(n_centroids: int) -> int:
    """Rows per assignment block: the largest power of two, at most 4096,
    whose float32 [rows, n_centroids] product fits ``ASSIGN_BUDGET_BYTES``."""
    rows = max(1, ASSIGN_BUDGET_BYTES // (4 * max(1, n_centroids)))
    return min(_MAX_BLOCK, 1 << (rows.bit_length() - 1))


def assign_clusters(
    points: torch.Tensor, centroids: torch.Tensor, *, block: int | None = None
) -> torch.Tensor:
    """argmax_c <x, c> for every point -> int64[N], the first maximal index
    on ties (as ``jnp.argmax``). Blocks of ``block`` rows (default
    ``assign_block``); a short last block is zero-padded to full size, so
    every point's dot products come from a product of one fixed shape and
    the result does not depend on how the caller chunks the points."""
    n, d = points.shape
    block = block or assign_block(centroids.shape[0])
    out = torch.empty(n, dtype=torch.long, device=points.device)
    ct = centroids.T
    for lo in range(0, n, block):
        blk = points[lo : lo + block]
        m = blk.shape[0]
        if m < block:
            blk = torch.cat([blk, blk.new_zeros(block - m, d)])
        out[lo : lo + m] = torch.argmax(blk @ ct, dim=-1)[:m]
    return out


def cluster_sums(points: torch.Tensor, assign: torch.Tensor, k: int):
    """(sums f64[k, D], counts i64[k]) of unit-norm ``points`` per cluster,
    summed exactly in int64 fixed point (module docstring)."""
    n = points.shape[0]
    bits = min(40, 62 - max(1, n).bit_length())  # |sum| < 2^62 for any split
    fixed = torch.round(points.double() * 2.0**bits).long()
    sums = torch.zeros(k, points.shape[1], dtype=torch.long, device=points.device)
    sums.index_add_(0, assign, fixed)
    counts = torch.bincount(assign, minlength=k)
    return sums.double() / 2.0**bits, counts


def lloyd_step(
    points: torch.Tensor, centroids: torch.Tensor, reseed_idx: torch.Tensor
) -> torch.Tensor:
    """One spherical Lloyd iteration over unit ``points``; an empty cluster
    takes the point ``reseed_idx[c]`` (i64[k], drawn by the caller)."""
    k = centroids.shape[0]
    assign = assign_clusters(points, centroids)
    sums, counts = cluster_sums(points, assign, k)
    new = (sums / counts.clamp_min(1).unsqueeze(1)).float()
    reseed = points[reseed_idx.to(points.device)]
    return l2_normalize(torch.where((counts > 0).unsqueeze(1), new, reseed))


def spherical_kmeans(
    points: torch.Tensor, k: int, *, iters: int = 8, generator: torch.Generator
) -> torch.Tensor:
    """Lloyd iterations with cosine assignment -> f32[k, D] unit centroids.

    ``generator`` (a CPU ``torch.Generator``) draws the initial
    permutation, then each step's reseed indices, so a build draws the
    same on every device. O(iters * n * k * D)."""
    n = points.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n_points={n}")
    points = l2_normalize(points)
    perm = torch.randperm(n, generator=generator)[:k]
    centroids = points[perm.to(points.device)]
    for _ in range(iters):
        reseed = torch.randint(0, n, (k,), generator=generator)
        centroids = lloyd_step(points, centroids, reseed)
    return centroids
