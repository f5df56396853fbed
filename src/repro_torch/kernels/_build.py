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
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "LAUNCHES", "reset_launches", "library", "build_all", "check",
    "stream_ptr", "require", "require_codec", "cuda_device",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
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
}

# Kernel launches per wrapper since the last reset: each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {name: 0 for name in KERNELS}

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    """The kernels take nbits in {2, 4, 8}, rows of exactly D*b/8 bytes,
    and a v-table that fits one block's shared memory."""
    if nbits not in (2, 4, 8):
        raise ValueError(f"nbits={nbits} not in (2, 4, 8)")
    if dim % (8 // nbits) or pb != dim * nbits // 8:
        raise ValueError(
            f"dim={dim} at nbits={nbits} does not fill whole packed bytes "
            f"(row of {pb} bytes): the kernels index codes byte-wise"
        )
    if dim * (1 << nbits) * 4 > SMEM_MAX:
        raise ValueError(
            f"the v-table f32[{dim}, {1 << nbits}] exceeds one block's "
            f"{SMEM_MAX} bytes of shared memory"
        )


def cuda_device(t: torch.Tensor) -> torch.device:
    """The tensor's device when it is a CUDA device, else raise: a kernel
    wrapper takes its plain version only for CPU tensors."""
    if t.device.type != "cuda":
        raise ValueError(f"CUDA kernel called on a {t.device} tensor")
    return t.device
