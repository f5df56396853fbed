"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), all sources in parallel, at first use. Libraries live under
``build/repro_torch_kernels/<hash>/`` in the repository, keyed by a hash
of the sources and flags, so an edited source rebuilds and an unchanged
one is reused. They load with ``ctypes``; every pointer and the stream
pass as ``c_void_p`` (a bare Python int would be cut to 32 bits).

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "LAUNCHES", "reset_launches", "library", "build_all", "check",
    "stream_ptr", "require", "require_codec", "vtable_chunk", "cuda_device",
    "launch_plan", "launch_key",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point of each kernel library: (symbol, argtypes).
KERNELS = {
    "selective_sum": (
        "warp_selective_sum", [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "fused_gather_score": (
        "warp_fused_gather_score",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "ragged_fused_gather_score": (
        "warp_ragged_fused_gather_score",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "flash_attention": (
        "warp_flash_attention",
        [_P, _P, _P, _P, *[_I] * 6, *[_L] * 9, _I, _I, _I, _P],
    ),
    "embedding_bag": (
        "warp_embedding_bag", [_P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _P],
    ),
}
# Further C entry points of a kernel library: {library: {symbol: argtypes}}.
ENTRIES = {
    "fused_gather_score": {  # a measurement carve-out (kernels/fused_gather_score.py)
        "warp_fused_gather_score_probe": [*[_P] * 6, *[_I] * 8, _P],
    },
    "ragged_fused_gather_score": {
        "warp_segmented_ragged_fused_gather_score": [*[_P] * 8, *[_I] * 8, _P],
        "warp_ragged_fused_gather_score_probe": [*[_P] * 7, *[_I] * 8, _P],
    },
    "embedding_bag": {  # the bag's backward (kernels/embedding_bag.py)
        "warp_embedding_bag_grad_table": [*[_P] * 7, _L, _P, _L, _I, _I, _L, _I, _I, _P],
        "warp_embedding_bag_grad_weights": [_P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _P],
    },
}

# What a kernel library reports of the launch it would make, without
# making it (see launch_plan): (symbol, argtypes, the plan's fields).
_SCORE_PLAN = ("threads", "smem_bytes", "resident_blocks", "blocks_per_token", "dims_per_chunk")
PLANS = {
    "selective_sum": ("warp_selective_sum_plan", [_P, _I, _I, _I, _I, _I, _P], _SCORE_PLAN),
    "fused_gather_score": ("warp_fused_gather_score_plan", [_P, *[_I] * 6, _P], _SCORE_PLAN),
    "ragged_fused_gather_score": (
        "warp_ragged_fused_gather_score_plan", [_P, *[_I] * 4, _P],
        ("threads", "smem_bytes", "resident_blocks", "blocks", "tiles_per_block",
         "dims_per_chunk"),
    ),
}

# Kernel launches per wrapper since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else. The segmented ragged
# wrapper launches the ragged library's second entry; the bag's backward
# wrapper adds one per kernel it launches (the table's and the weights'
# gradients) from the bag library's further entries. A measurement launch
# of a fused kernel's carve-out counts under "<name>:<probe>", never under
# the kernel's own name.
PROBED = ("fused_gather_score", "ragged_fused_gather_score")
LAUNCHES = {
    name: 0
    for name in (
        *KERNELS, "segmented_ragged_fused_gather_score", "embedding_bag_backward",
        *(f"{k}:{p}" for k in PROBED for p in ("full", "dma", "compute")),
    )
}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_key(name: str, probe: str | None) -> str:
    """The ``LAUNCHES`` entry of a launch of kernel ``name``: its own for
    the product path (``probe`` None), ``"<name>:<probe>"`` for a
    measurement carve-out."""
    return name if probe is None else f"{name}:{probe}"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from csrc/ at first use and need the CUDA toolkit"
    )


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every kernel library that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: .so path}``; the
    ptxas report of each build is kept beside it as ``<name>.log``."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {name: out_dir / f"lib{name}.so" for name in KERNELS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        log = open(out_dir / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}; see {out_dir / (name + '.log')})")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "; ".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            for n, path in paths.items():
                if n in _LIBS:
                    continue
                dll = ctypes.CDLL(str(path))
                symbol, argtypes = KERNELS[n]
                fn = getattr(dll, symbol)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                for extra, extra_argtypes in ENTRIES.get(n, {}).items():
                    getattr(dll, extra).argtypes = extra_argtypes
                    getattr(dll, extra).restype = ctypes.c_int
                if n in PLANS:
                    plan_symbol, plan_argtypes, _ = PLANS[n]
                    getattr(dll, plan_symbol).argtypes = plan_argtypes
                    getattr(dll, plan_symbol).restype = ctypes.c_int
                dll.warp_error_string.argtypes = [ctypes.c_int]
                dll.warp_error_string.restype = ctypes.c_char_p
                _LIBS[n] = dll
    return _LIBS[name]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, rc: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = library(name).warp_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


SMEM_MAX = 232_448  # bytes of shared memory one block may use on sm_90


def require(t: torch.Tensor, what: str, dtype: torch.dtype, device, shape=None) -> None:
    """What every kernel wrapper checks before a launch: device, dtype,
    contiguity and (where given) shape."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def require_codec(dim: int, nbits: int, pb: int) -> None:
    """The kernels take nbits in {2, 4, 8} and rows of exactly D*b/8
    bytes: any D whose codes fill whole bytes."""
    if nbits not in (2, 4, 8):
        raise ValueError(f"nbits={nbits} not in (2, 4, 8)")
    if dim % (8 // nbits) or pb != dim * nbits // 8:
        raise ValueError(
            f"dim={dim} at nbits={nbits} does not fill whole packed bytes "
            f"(row of {pb} bytes): the kernels index codes byte-wise"
        )


def ring_row_stride(pb: int) -> int:
    """Shared-memory bytes per staged code row of the scoring kernels
    (``score_rows::row_stride``): PB rounded up to an odd number of
    16-byte units."""
    return 16 * (-(-pb // 16) | 1)


def _vtable_fits(dc: int, nbits: int, other: int) -> bool:
    # score_rows::vtable_bytes (the 256-byte slack and dc dims of table),
    # `other` bytes and one warp's ring of 3 chunks of 32 rows of dc dims.
    table = 256 + dc * (1 << nbits) * 4
    return other + table + 3 * 32 * ring_row_stride(dc * nbits // 8) <= SMEM_MAX


def vtable_chunk(dim: int, nbits: int, other: int = 0) -> int:
    """Dimensions per v-table chunk of the scoring kernels
    (``score_rows::dims_per_chunk``): all D where the whole table (on a
    256-byte boundary), ``other`` bytes and one warp's ring of staged rows
    fit one block's shared memory; else the fewest chunks of whole
    128 / b-dim units (16 bytes of a row) that fit, each but the last of the
    returned size. Raises where not even one unit fits beside ``other``."""
    if _vtable_fits(dim, nbits, other):
        return dim
    unit = 128 // nbits
    for n in itertools.count(2):
        per = -(-dim // n)  # ceil(dim / n) dims ...
        dc = -(-per // unit) * unit  # ... up to a whole unit
        if _vtable_fits(dc, nbits, other):
            return dc
        if dc <= unit:
            raise ValueError(
                f"{other} bytes of per-block arrays leave no room in one block's "
                f"{SMEM_MAX} bytes of shared memory for {unit} dims of the v-table "
                f"f32[{dim}, {1 << nbits}] and one warp's staged rows"
            )


def launch_plan(name: str, *args) -> dict:
    """The launch kernel ``name`` (a key of ``PLANS``) would make for these
    arguments: threads and dynamic shared memory per block, blocks resident
    on the card at once, the split (blocks per query token, or the ragged
    kernel's blocks and tiles per block) and the v-table dims per chunk."""
    symbol, _, fields = PLANS[name]
    buf = (ctypes.c_int * len(fields))()
    check(name, getattr(library(name), symbol)(*args, buf))
    return dict(zip(fields, buf))


def cuda_device(t: torch.Tensor) -> torch.device:
    """The tensor's device when it is a CUDA device, else raise: a kernel
    wrapper takes its plain version only for CPU tensors."""
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {t.device} tensor")
    return t.device
