"""Core datatypes of the PyTorch port: the index and the search config.

``WarpIndex`` holds the index arrays as torch tensors on one device (the
counterpart of ``repro/core/types.py::WarpIndex``; the arrays play the
role of weights). ``WarpSearchConfig`` carries the same fields, defaults
and validation as the JAX config, so a resolved config of either package
compares field by field with the other's.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

__all__ = ["WarpIndex", "WarpSearchConfig", "resolve_device"]

GATHER_STRATEGIES = ("materialize", "fused")
EXECUTOR_STRATEGIES = ("auto", "kernel", "reference")
MEMORY_STRATEGIES = ("full", "scan_qtokens")
LAYOUT_STRATEGIES = ("dense", "ragged", "auto")
REDUCE_IMPLS = ("scan", "segment")
SUM_IMPLS = ("gather", "lut")
BUFFERING_STRATEGIES = ("auto", "double", "single")
TILE_SOURCES = ("config", "autotune", "heuristic")

ARRAY_FIELDS = (
    "centroids",
    "packed_codes",
    "token_doc_ids",
    "cluster_offsets",
    "cluster_sizes",
    "bucket_weights",
    "bucket_cutoffs",
)
STATIC_FIELDS = ("dim", "nbits", "cap", "n_docs", "n_tokens")
_DTYPES = {
    "centroids": torch.float32,
    "packed_codes": torch.uint8,
    "token_doc_ids": torch.int32,
    "cluster_offsets": torch.int32,
    "cluster_sizes": torch.int32,
    "bucket_weights": torch.float32,
    "bucket_cutoffs": torch.float32,
}


def resolve_device(device) -> torch.device:
    """``None`` -> the card. Raises when CUDA is absent: the port never
    falls back to the CPU on its own; callers ask for it explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default — pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class WarpIndex:
    """Compressed multi-vector index, all arrays on one device.

    centroids f32[C, D], packed_codes u8[N, D*b/8] (CSR-by-cluster order),
    token_doc_ids i32[N], cluster_offsets i32[C + 1], cluster_sizes i32[C],
    bucket_weights f32[2^b], bucket_cutoffs f32[2^b - 1]; static geometry
    dim, nbits, cap (max cluster size), n_docs, n_tokens.
    """

    centroids: torch.Tensor
    packed_codes: torch.Tensor
    token_doc_ids: torch.Tensor
    cluster_offsets: torch.Tensor
    cluster_sizes: torch.Tensor
    bucket_weights: torch.Tensor
    bucket_cutoffs: torch.Tensor

    dim: int = 128
    nbits: int = 4
    cap: int = 0
    n_docs: int = 0
    n_tokens: int = 0

    @property
    def n_centroids(self) -> int:
        return self.centroids.shape[0]

    @property
    def n_buckets(self) -> int:
        return 1 << self.nbits

    @property
    def device(self) -> torch.device:
        return self.packed_codes.device

    def nbytes(self) -> int:
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size()
            for f in ARRAY_FIELDS
        )

    def to(self, device) -> "WarpIndex":
        device = torch.device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in ARRAY_FIELDS}
        )

    @classmethod
    def from_arrays(cls, src: Any, *, device) -> "WarpIndex":
        """Build from any object or dict carrying the ``WarpIndex`` array
        fields (numpy-convertible: numpy, memmap, a JAX ``WarpIndex``'s
        arrays) and the static fields. Arrays keep their values exactly;
        only dtypes are normalized to the index's own."""
        get = src.get if isinstance(src, dict) else lambda k: getattr(src, k)
        device = torch.device(device)
        arrays = {}
        for f in ARRAY_FIELDS:
            a = np.asarray(get(f))
            if not a.flags.writeable:
                a = a.copy()  # torch.from_numpy needs a writable buffer
            arrays[f] = torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=_DTYPES[f]
            )
        return cls(**arrays, **{k: int(get(k)) for k in STATIC_FIELDS})


@dataclasses.dataclass(frozen=True)
class WarpSearchConfig:
    """Hyperparameters of WARP retrieval; the port's twin of
    ``repro/core/types.py::WarpSearchConfig`` (same fields, defaults and
    validation — see that docstring for each field's meaning).

    Differences in meaning on this port:

    executor: "kernel" runs the hand-written CUDA kernels and needs the
              index on the card; "reference" runs the plain PyTorch
              versions; "auto" is "kernel" on CUDA and "reference" on CPU.
    buffering: kept so resolved configs and ``describe()`` compare equal
              to the JAX ones. It does nothing on CUDA: the DMA schedules
              it names are TPU notions.
    """

    nprobe: int = 32
    t_prime: int | None = None
    t_prime_max: int = 1 << 16
    k: int = 100
    k_impute: int = 64
    gather: str = "materialize"
    executor: str = "auto"
    memory: str = "full"
    layout: str = "dense"
    tile_c: int | None = None
    buffering: str = "auto"
    reduce_impl: str = "scan"
    sum_impl: str = "gather"
    worklist_tiles: int | None = None
    worklist_buckets: tuple[int, ...] | None = None
    tile_source: str | None = None
    use_kernel: bool | None = None
    scan_qtokens: bool | None = None
    fused_gather: bool | None = None

    def __post_init__(self):
        shims = (
            ("use_kernel", "executor", {True: "kernel", False: "reference"}),
            ("scan_qtokens", "memory", {True: "scan_qtokens", False: "full"}),
            ("fused_gather", "gather", {True: "fused", False: "materialize"}),
        )
        for legacy, field, mapping in shims:
            val = getattr(self, legacy)
            if val is None:
                continue
            warnings.warn(
                f"WarpSearchConfig.{legacy} is deprecated; use "
                f"{field}={mapping[bool(val)]!r} instead",
                DeprecationWarning,
                stacklevel=3,
            )
            object.__setattr__(self, field, mapping[bool(val)])
            object.__setattr__(self, legacy, None)
        _check_choice("gather", self.gather, GATHER_STRATEGIES)
        _check_choice("executor", self.executor, EXECUTOR_STRATEGIES)
        _check_choice("memory", self.memory, MEMORY_STRATEGIES)
        _check_choice("layout", self.layout, LAYOUT_STRATEGIES)
        _check_choice("reduce_impl", self.reduce_impl, REDUCE_IMPLS)
        _check_choice("sum_impl", self.sum_impl, SUM_IMPLS)
        _check_choice("buffering", self.buffering, BUFFERING_STRATEGIES)
        if self.tile_source is not None:
            _check_choice("tile_source", self.tile_source, TILE_SOURCES)
        if self.worklist_buckets is not None and not isinstance(
            self.worklist_buckets, tuple
        ):
            object.__setattr__(
                self, "worklist_buckets", tuple(self.worklist_buckets)
            )
        if self.tile_c is not None and (self.tile_c < 8 or self.tile_c % 8):
            raise ValueError(
                f"WarpSearchConfig.tile_c={self.tile_c} must be a positive "
                "multiple of 8"
            )

    def resolved_t_prime(self, n_tokens: int) -> int:
        if self.t_prime is not None:
            return int(self.t_prime)
        return int(min(max(1.0, n_tokens**0.5), float(self.t_prime_max)))

    def resolved_k_impute(self, n_centroids: int) -> int:
        return int(min(n_centroids, max(self.k_impute, self.nprobe)))

    def resolved_executor(self, on_cuda: bool) -> str:
        """Concretize executor="auto": CUDA kernels on the card, the plain
        PyTorch versions on the CPU."""
        if self.executor == "auto":
            return "kernel" if on_cuda else "reference"
        return self.executor

    @property
    def wants_kernel(self) -> bool:
        return self.executor == "kernel"


def _check_choice(name: str, value: str, allowed: tuple[str, ...]) -> None:
    if value not in allowed:
        raise ValueError(
            f"WarpSearchConfig.{name}={value!r} is not a valid strategy; "
            f"expected one of {allowed}"
        )
