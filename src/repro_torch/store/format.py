"""Store reader: a saved index directory -> a device-resident ``WarpIndex``.

Reads the format that ``repro/store/format.py::save_index`` writes
(``MANIFEST.json`` plus raw little-endian array binaries, manifest
versions 1 and 2; ``docs/store_format.md``). Arrays go mmap ->
``torch.from_numpy`` -> device: on the CPU the tensors stay zero-copy
views of the files; on the card the one host-to-device copy is the load.

Only single-index stores are read in this slice; sharded stores and
stores with delta segments raise a directed error.
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from repro_torch.core.types import STATIC_FIELDS, WarpIndex, resolve_device
from repro_torch.store.integrity import StoreCorruption, verify_head

__all__ = ["StoreCorruption", "read_manifest", "load_index"]

FORMAT_NAME = "warp-store"
FORMAT_VERSION = 2
MANIFEST = "MANIFEST.json"
KIND_SINGLE = "warp_index"
KIND_SHARDED = "sharded_warp_index"
KIND_SEGMENT = "warp_delta_segment"

_WARP_ARRAYS = (
    "centroids",
    "packed_codes",
    "token_doc_ids",
    "cluster_offsets",
    "cluster_sizes",
    "bucket_weights",
    "bucket_cutoffs",
)


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
        if name in _WARP_ARRAYS
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
            "to repro_torch — load it with the JAX package (repro.store)"
        )
    if kind == KIND_SEGMENT:
        raise ValueError(
            f"{path} is a delta segment; load the owning store directory"
        )
    if kind != KIND_SINGLE:
        raise ValueError(f"{path}: unknown index kind {kind!r}")
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root) and any(
        os.path.exists(os.path.join(seg_root, d, MANIFEST))
        for d in os.listdir(seg_root)
    ):
        raise NotImplementedError(
            f"{path} holds delta segments; segmented stores are not yet "
            "ported to repro_torch — compact the store first "
            "(repro.store.compact) or serve it with the JAX package"
        )
    return _load_single(path, manifest, device)
