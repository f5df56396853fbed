"""Versioned on-disk index format: ``MANIFEST.json`` plus raw little-endian
array binaries (``docs/store_format.md``). Counterpart of
``repro/store/format.py``: the same writer, byte for byte, and its reader.

Reading: arrays go mmap -> ``torch.from_numpy`` -> device; on the CPU the
tensors stay zero-copy views of the files, on the card the one
host-to-device copy is the load. Manifest versions 1 and 2 are read.

Only single-index stores are read and written in the port so far; sharded
and segmented stores raise a directed error naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.core.types import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    WarpIndex,
    resolve_device,
)
from repro_torch.store.integrity import (
    StoreCorruption,
    array_nbytes,
    checksum_bytes,
    verify_head,
)

__all__ = [
    "FORMAT_NAME",
    "FORMAT_VERSION",
    "StoreCorruption",
    "array_nbytes",
    "inspect_index",
    "load_index",
    "read_manifest",
    "save_index",
]

FORMAT_NAME = "warp-store"
FORMAT_VERSION = 2
MANIFEST = "MANIFEST.json"
ARRAY_DIR = "arrays"
KIND_SINGLE = "warp_index"
KIND_SHARDED = "sharded_warp_index"
KIND_SEGMENT = "warp_delta_segment"

_SHARDED_TODO = "ROADMAP queue 1, 'Sharded search'"
_SEGMENTED_TODO = "ROADMAP queue 1, 'Segmented indexes'"


# ---------------------------------------------------------------------------
# manifest + raw binary primitives
# ---------------------------------------------------------------------------


def _write_array(path: str, arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    arr.tofile(path)
    meta = {"dtype": arr.dtype.name, "shape": list(arr.shape)}
    if arr.size:
        meta["checksum"] = checksum_bytes(arr.data)
    return meta


def _entry(file: str, arr_like: dict, offset: int = 0) -> dict:
    e = {"file": file, **arr_like}
    if offset:
        e["offset"] = int(offset)
    return e


def _write_manifest(path: str, manifest: dict) -> None:
    # tmp + fsync + atomic rename: a crash mid-write leaves the old
    # manifest or the new one, never a torn file.
    tmp = os.path.join(path, MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, MANIFEST))


def _prepare_dir(path: str, overwrite: bool) -> None:
    if os.path.exists(os.path.join(path, MANIFEST)):
        if not overwrite:
            raise FileExistsError(
                f"{path} already holds an index (pass overwrite=True)"
            )
        shutil.rmtree(path)
    os.makedirs(os.path.join(path, ARRAY_DIR), exist_ok=True)


def _config_dict(build_config: Any) -> dict | None:
    if build_config is None:
        return None
    if dataclasses.is_dataclass(build_config):
        return dataclasses.asdict(build_config)
    return dict(build_config)


def _segment_dirs(path: str) -> list[str]:
    seg_root = os.path.join(path, "segments")
    if not os.path.isdir(seg_root):
        return []
    return [
        os.path.join(seg_root, name)
        for name in sorted(os.listdir(seg_root))
        if os.path.exists(os.path.join(seg_root, name, MANIFEST))
    ]


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------


def save_index(
    index: WarpIndex, path: str, *, build_config: Any = None, overwrite: bool = False
) -> str:
    """Persist a single index as a store directory; returns ``path``. The
    files are those ``repro.store.save_index`` writes for the same arrays.
    ``build_config`` (an ``IndexBuildConfig`` or dict) goes into the
    manifest."""
    if hasattr(index, "n_shards"):
        raise NotImplementedError(
            f"saving a sharded index is not yet ported to repro_torch ({_SHARDED_TODO})"
        )
    if hasattr(index, "segments"):
        raise NotImplementedError(
            f"saving a segmented index is not yet ported to repro_torch ({_SEGMENTED_TODO})"
        )
    if not isinstance(index, WarpIndex):
        raise TypeError(f"cannot save {type(index).__name__}; expected a WarpIndex")
    _prepare_dir(path, overwrite)
    arrays = {}
    for name in ARRAY_FIELDS:
        rel = f"{ARRAY_DIR}/{name}.bin"
        meta = _write_array(os.path.join(path, rel), getattr(index, name).cpu().numpy())
        arrays[name] = _entry(rel, meta)
    _write_manifest(path, {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "kind": KIND_SINGLE,
        "static": {k: int(getattr(index, k)) for k in STATIC_FIELDS},
        "arrays": arrays,
        "build_config": _config_dict(build_config),
    })
    return path


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def read_manifest(path: str) -> dict:
    """Parse and version-check ``path/MANIFEST.json``.

    ``FileNotFoundError`` passes through untouched ("no store here");
    an unreadable manifest is ``StoreCorruption`` ("store here but
    broken"). A v1 manifest loads with a warning: it has no checksums.
    """
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, json.JSONDecodeError) as e:
        raise StoreCorruption(f"{path}: unreadable manifest ({e})") from e
    if manifest.get("format") != FORMAT_NAME:
        raise ValueError(f"{path}: not a {FORMAT_NAME} directory")
    version = int(manifest.get("version", -1))
    if version > FORMAT_VERSION:
        raise ValueError(
            f"{path}: format version {manifest['version']} is newer than "
            f"this reader (v{FORMAT_VERSION})"
        )
    if version < FORMAT_VERSION:
        warnings.warn(
            f"{path}: pre-checksum store format (v{manifest.get('version')}); "
            "arrays load unverified — re-save to record checksums",
            stacklevel=2,
        )
    return manifest


def _load_entry(base_dir: str, entry: dict) -> np.ndarray:
    """One manifest array entry as a copy-on-write memmap (writable for
    ``torch.from_numpy``; writes never reach the file)."""
    path = os.path.normpath(os.path.join(base_dir, entry["file"]))
    dtype = np.dtype(entry["dtype"])
    shape = tuple(int(s) for s in entry["shape"])
    if 0 in shape:
        return np.empty(shape, dtype)
    verify_head(base_dir, entry)
    try:
        return np.memmap(
            path, dtype=dtype, mode="c", offset=int(entry.get("offset", 0)),
            shape=shape,
        )
    except (OSError, ValueError) as e:
        raise StoreCorruption(f"{path}: unreadable ({e})") from e


def _load_single(path: str, manifest: dict, device: torch.device) -> WarpIndex:
    arrays = {
        name: _load_entry(path, entry)
        for name, entry in manifest["arrays"].items()
        if name in ARRAY_FIELDS
    }
    static = manifest["static"]
    return WarpIndex.from_arrays(
        {**arrays, **{k: int(static[k]) for k in STATIC_FIELDS}}, device=device
    )


def load_index(path: str, *, device=None) -> WarpIndex:
    """Load a single-index store onto ``device`` (``None`` -> the card;
    pass ``device="cpu"`` to load on the CPU)."""
    device = resolve_device(device)
    manifest = read_manifest(path)
    kind = manifest["kind"]
    if kind == KIND_SHARDED:
        raise NotImplementedError(
            f"{path} is a sharded store; sharded search is not yet ported "
            f"to repro_torch ({_SHARDED_TODO}) — load it with the JAX "
            "package (repro.store)"
        )
    if kind == KIND_SEGMENT:
        raise ValueError(
            f"{path} is a delta segment; load the owning store directory"
        )
    if kind != KIND_SINGLE:
        raise ValueError(f"{path}: unknown index kind {kind!r}")
    if _segment_dirs(path):
        raise NotImplementedError(
            f"{path} holds delta segments; segmented stores are not yet "
            f"ported to repro_torch ({_SEGMENTED_TODO}) — compact the store "
            "first (repro.store.compact) or serve it with the JAX package"
        )
    return _load_single(path, manifest, device)


# ---------------------------------------------------------------------------
# inspect
# ---------------------------------------------------------------------------


def inspect_index(path: str) -> dict:
    """Measured on-disk footprint per component, from the manifests alone
    (the paper's Table-4 split: centroids, packed residual codes, CSR
    metadata with the codec tables, doc ids), delta segments included."""
    manifest = read_manifest(path)
    comp = {"centroids": 0, "packed_codes": 0, "csr_metadata": 0, "doc_ids": 0}

    def tally(arrays: dict) -> None:
        for name, entry in arrays.items():
            nbytes = array_nbytes(entry)
            if name in ("centroids", "packed_codes"):
                comp[name] += nbytes
            elif name == "token_doc_ids":
                comp["doc_ids"] += nbytes
            elif name != "doc_start":  # offsets, sizes, bucket tables
                comp["csr_metadata"] += nbytes

    tally(manifest["arrays"])
    segs = []
    for seg_dir in _segment_dirs(path):
        seg_manifest = read_manifest(seg_dir)
        tally(seg_manifest["arrays"])
        segs.append({"dir": os.path.basename(seg_dir), "static": seg_manifest["static"]})
    total = sum(comp.values())
    out = {
        "kind": manifest["kind"],
        "version": manifest["version"],
        "static": manifest["static"],
        "components_bytes": comp,
        "total_bytes": total,
        "n_segments": len(segs),
        "segments": segs,
    }
    if manifest["kind"] == KIND_SHARDED:
        out["n_shards"] = manifest["n_shards"]
    n_tokens = manifest["static"].get(
        "n_tokens", manifest["static"].get("n_tokens_total", 0)
    ) + sum(int(s["static"]["n_tokens"]) for s in segs)
    out["bytes_per_token"] = total / max(1, n_tokens)
    return out
