"""Versioned on-disk index format: ``MANIFEST.json`` plus raw little-endian
array binaries (``docs/store_format.md``). Counterpart of
``repro/store/format.py``: the same writer, byte for byte, and its reader.

Reading: arrays go mmap -> ``torch.from_numpy`` -> device; on the CPU the
tensors stay zero-copy views of the files, on the card the one
host-to-device copy is the load. Manifest versions 1 and 2 are read.

Single-index stores are read and written; a store with delta segments
(``segments/seg_NNNNN/``, written by ``store.segments.add_documents``)
loads as a ``SegmentedWarpIndex``. Sharded stores raise a directed error
naming their ROADMAP item. ``compact``'s lock file and crash recovery
(``recover_interrupted_compact``) are JAX's, step for step.

The fault injection points (``repro_torch.fault``: ``store.array_read``,
``store.manifest_parse``, ``store.segment_load``) and the
``store_save_seconds`` / ``store_load_seconds`` histograms
(``repro_torch.obs``) sit where the JAX package has them; an injected
fault surfaces as ``StoreCorruption``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import fault, obs
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
    "compact_lock_path",
    "inspect_index",
    "list_segment_dirs",
    "load_index",
    "load_segment_arrays",
    "read_manifest",
    "recover_interrupted_compact",
    "save_index",
]

FORMAT_NAME = "warp-store"
FORMAT_VERSION = 2
MANIFEST = "MANIFEST.json"
ARRAY_DIR = "arrays"
COMPACT_TMP_SUFFIX = ".compact-tmp"
COMPACT_OLD_SUFFIX = ".compact-old"
COMPACT_LOCK_SUFFIX = ".compact-lock"
KIND_SINGLE = "warp_index"
KIND_SHARDED = "sharded_warp_index"
KIND_SEGMENT = "warp_delta_segment"

_SHARDED_TODO = "ROADMAP queue 1, 'Sharded search'"
# The arrays of a delta segment's own (centroids and codec are the base's).
SEGMENT_ARRAYS = ("packed_codes", "token_doc_ids", "cluster_offsets", "cluster_sizes")


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


def list_segment_dirs(path: str) -> list[str]:
    """Delta-segment directories of a base index, in append order."""
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
    t0 = time.perf_counter()
    if hasattr(index, "n_shards"):
        raise NotImplementedError(
            f"saving a sharded index is not yet ported to repro_torch ({_SHARDED_TODO})"
        )
    if not isinstance(index, WarpIndex):
        raise TypeError(f"cannot save {type(index).__name__} (segmented "
                        "indexes are saved via their base + delta segments)")
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
    obs.observe("store_save_seconds", time.perf_counter() - t0)
    return path


# ---------------------------------------------------------------------------
# compaction lock and crash recovery
# ---------------------------------------------------------------------------


def compact_lock_path(path: str) -> str:
    return path.rstrip("/\\") + COMPACT_LOCK_SUFFIX


def _read_lock_pid(lock_path: str) -> int:
    try:
        with open(lock_path) as f:
            return int(f.read().strip() or 0)
    except (OSError, ValueError):
        return 0


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _lock_holder_alive(lock_path: str) -> bool:
    """Whether the pid recorded in a compact lock file is still running."""
    return _pid_alive(_read_lock_pid(lock_path))


def recover_interrupted_compact(path: str) -> None:
    """Repair a store whose ``compact()`` died inside the directory swap:
    with ``path`` gone and ``.compact-tmp``/``.compact-old`` beside it,
    promote the complete new base (its manifest is written last) or roll
    back to the old one. A no-op while ``path`` exists, and while another
    LIVE process holds the lock (a reader in the rename window retries)."""
    if os.path.exists(path):
        return
    base = path.rstrip("/\\")
    lock = base + COMPACT_LOCK_SUFFIX
    if os.path.exists(lock):
        pid = _read_lock_pid(lock)
        if pid != os.getpid() and _pid_alive(pid):
            return
    tmp = base + COMPACT_TMP_SUFFIX
    old = base + COMPACT_OLD_SUFFIX
    if os.path.exists(os.path.join(tmp, MANIFEST)) and os.path.isdir(old):
        os.rename(tmp, path)  # the old base went aside: finish the swap
        shutil.rmtree(old, ignore_errors=True)
    elif os.path.isdir(old):
        os.rename(old, path)  # the new base is incomplete: roll back
        shutil.rmtree(tmp, ignore_errors=True)
    if os.path.exists(lock) and not _lock_holder_alive(lock):
        os.remove(lock)


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
        fault.check("store.manifest_parse", path=path)
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise
    except (OSError, json.JSONDecodeError, fault.InjectedFault) as e:
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
    try:
        if fault.FAULTS.plan is not None:
            fault.FAULTS.plan.check("store.array_read", file=path)
        verify_head(base_dir, entry)
        return np.memmap(
            path, dtype=dtype, mode="c", offset=int(entry.get("offset", 0)),
            shape=shape,
        )
    except StoreCorruption:
        raise
    except (OSError, ValueError, fault.InjectedFault) as e:
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


def load_index(
    path: str, *, device=None, with_segments: bool = True, quarantine_segments: bool = False
):
    """Load a store onto ``device`` (``None`` -> the card; pass
    ``device="cpu"`` to load on the CPU): a ``WarpIndex``, or a
    ``SegmentedWarpIndex`` when ``segments/`` holds deltas and
    ``with_segments``. ``quarantine_segments`` skips a corrupt delta
    (recorded in ``.quarantined``) instead of raising; a corrupt base
    always raises ``StoreCorruption``. A crash inside ``compact``'s
    directory swap is repaired first."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    recover_interrupted_compact(path)
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
    base = _load_single(path, manifest, device)
    seg_dirs = list_segment_dirs(path)
    if with_segments and seg_dirs:
        from repro_torch.store.segments import load_segmented  # segments imports us

        out = load_segmented(base, seg_dirs, quarantine=quarantine_segments)
        obs.observe("store_load_seconds", time.perf_counter() - t0)
        return out
    obs.observe("store_load_seconds", time.perf_counter() - t0)
    return base


def load_segment_arrays(seg_dir: str) -> tuple[dict, dict]:
    """(manifest, host arrays) of one delta-segment directory."""
    fault.check("store.segment_load", dir=seg_dir)
    manifest = read_manifest(seg_dir)
    if manifest["kind"] != KIND_SEGMENT:
        raise ValueError(f"{seg_dir}: not a delta segment")
    arrays = {
        name: _load_entry(seg_dir, entry) for name, entry in manifest["arrays"].items()
    }
    return manifest, arrays


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
    for seg_dir in list_segment_dirs(path):
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
