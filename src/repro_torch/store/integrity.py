"""Store integrity: per-array checksums, written and verified.

Counterpart of ``repro/store/integrity.py``: manifests at format version 2
record per-array ``{algo, crc, head_crc, head_bytes}`` checksums. Loading
verifies the head sample of every array (``verify_head``);
``verify_store`` streams every byte. New manifests record CRC32C through
the optional ``crc32c`` package, else ``crc32`` through ``zlib``, as the
JAX package writes them. Stores recorded as ``crc32c`` verify with the
pure-Python Castagnoli CRC below when the package is absent.
"""

from __future__ import annotations

import json
import os
import warnings
import zlib

import numpy as np

__all__ = [
    "StoreCorruption",
    "CHECKSUM_HEAD_BYTES",
    "array_nbytes",
    "crc32c_py",
    "preferred_algo",
    "checksum_update",
    "checksum_bytes",
    "checksum_file",
    "verify_head",
    "verify_entry",
    "verify_store",
]

CHECKSUM_HEAD_BYTES = 65536
_CHUNK = 4 << 20  # streaming read granularity of full-file checksums


class StoreCorruption(RuntimeError):
    """A store array or manifest failed an integrity check."""


try:  # optional C implementation of CRC32C
    import crc32c as _crc32c_mod
except ImportError:  # pragma: no cover - depends on the environment
    _crc32c_mod = None

_CRC32C_TABLE: list[int] | None = None


def _crc32c_table() -> list[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ 0x82F63B78 if crc & 1 else crc >> 1
            table.append(crc)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c_py(data, crc: int = 0) -> int:
    """Pure-Python CRC32C (Castagnoli, reflected):
    ``crc32c_py(b"123456789") == 0xE3069283``."""
    table = _crc32c_table()
    crc ^= 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def preferred_algo() -> str:
    """Checksum algorithm new manifests record."""
    return "crc32c" if _crc32c_mod is not None else "crc32"


def checksum_update(algo: str, crc: int, data) -> int:
    """Extend a checksum over ``data`` (any buffer)."""
    if algo == "crc32":
        return zlib.crc32(data, crc) & 0xFFFFFFFF
    if algo == "crc32c":
        if _crc32c_mod is not None:
            return _crc32c_mod.crc32c(bytes(data), crc)
        return crc32c_py(data, crc)
    raise ValueError(f"unknown checksum algo {algo!r}")


def checksum_bytes(data, *, algo: str | None = None) -> dict:
    """Checksum block of an in-memory buffer (the small-array path)."""
    algo = algo or preferred_algo()
    mv = memoryview(data).cast("B")
    head = mv[: min(len(mv), CHECKSUM_HEAD_BYTES)]
    return {
        "algo": algo,
        "crc": checksum_update(algo, 0, mv),
        "head_crc": checksum_update(algo, 0, head),
        "head_bytes": CHECKSUM_HEAD_BYTES,
    }


def checksum_file(
    path: str, *, offset: int = 0, nbytes: int | None = None,
    algo: str | None = None,
) -> dict:
    """Checksum block of ``nbytes`` of a file from ``offset``, streamed in
    chunks: the path for memmap-written arrays."""
    algo = algo or preferred_algo()
    if nbytes is None:
        nbytes = os.path.getsize(path) - offset
    crc = head_crc = done = 0
    with open(path, "rb") as f:
        f.seek(offset)
        while done < nbytes:
            chunk = f.read(min(_CHUNK, nbytes - done))
            if not chunk:
                raise StoreCorruption(
                    f"{path}: truncated at {offset + done} bytes "
                    f"(expected {offset + nbytes})"
                )
            if done < CHECKSUM_HEAD_BYTES:
                head_crc = checksum_update(
                    algo, head_crc, chunk[: CHECKSUM_HEAD_BYTES - done]
                )
            crc = checksum_update(algo, crc, chunk)
            done += len(chunk)
    return {
        "algo": algo, "crc": crc, "head_crc": head_crc,
        "head_bytes": CHECKSUM_HEAD_BYTES,
    }


def array_nbytes(entry: dict) -> int:
    """On-disk bytes of one manifest array entry."""
    n = 1
    for s in entry["shape"]:
        n *= int(s)
    return n * np.dtype(entry["dtype"]).itemsize


def verify_head(base_dir: str, entry: dict) -> None:
    """Checksum the first ``head_bytes`` of an array entry against the
    recorded ``head_crc``; raises ``StoreCorruption``. Entries without a
    checksum (v1 stores) pass unverified."""
    cs = entry.get("checksum")
    if cs is None:
        return
    path = os.path.normpath(os.path.join(base_dir, entry["file"]))
    offset = int(entry.get("offset", 0))
    want = min(array_nbytes(entry), int(cs.get("head_bytes", CHECKSUM_HEAD_BYTES)))
    try:
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(want)
    except OSError as e:
        raise StoreCorruption(f"{path}: unreadable ({e})") from e
    if len(data) < want:
        raise StoreCorruption(
            f"{path}: truncated ({offset + len(data)} bytes, expected at "
            f"least {offset + want})"
        )
    got = checksum_update(cs["algo"], 0, data)
    if got != int(cs["head_crc"]):
        raise StoreCorruption(
            f"{path}: head checksum mismatch "
            f"({cs['algo']} {got:#010x} != recorded {int(cs['head_crc']):#010x})"
        )


def verify_entry(base_dir: str, name: str, entry: dict, *, full: bool = True):
    """Verify one manifest array entry -> ``(status, detail)``, status one
    of ok / unchecked (no checksum: a v1 store, or an unknown algo) /
    missing / truncated / mismatch. Never raises."""
    path = os.path.normpath(os.path.join(base_dir, entry["file"]))
    offset = int(entry.get("offset", 0))
    nbytes = array_nbytes(entry)
    if not os.path.exists(path):
        return "missing", f"{name}: {path} does not exist"
    if os.path.getsize(path) < offset + nbytes:
        return "truncated", (
            f"{name}: {path} holds {os.path.getsize(path)} bytes, entry "
            f"needs {offset + nbytes}"
        )
    cs = entry.get("checksum")
    if cs is None:
        return "unchecked", f"{name}: no checksum recorded (v1 store)"
    if full:
        span, want = nbytes, int(cs["crc"])
    else:
        span = min(nbytes, int(cs.get("head_bytes", CHECKSUM_HEAD_BYTES)))
        want = int(cs["head_crc"])
    try:
        got = checksum_file(path, offset=offset, nbytes=span, algo=cs["algo"])["crc"]
    except ValueError as e:  # an algo recorded by a newer writer
        return "unchecked", f"{name}: {e}"
    except StoreCorruption as e:
        return "truncated", f"{name}: {e}"
    if got != want:
        which = "" if full else "head "
        return "mismatch", (
            f"{name}: {which}checksum mismatch ({cs['algo']} {got:#010x} != "
            f"recorded {want:#010x}) in {path}"
        )
    return "ok", ""


def _manifest_dirs(path: str) -> list[str]:
    """The root, shard subdirectories and delta segments of a store: every
    directory holding a manifest, in a fixed order."""
    dirs = [path]
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        if name.startswith("shard_") and os.path.exists(os.path.join(sub, "MANIFEST.json")):
            dirs.append(sub)
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root):
        for name in sorted(os.listdir(seg_root)):
            sub = os.path.join(seg_root, name)
            if os.path.exists(os.path.join(sub, "MANIFEST.json")):
                dirs.append(sub)
    return dirs


def verify_store(path: str, *, full: bool = True) -> dict:
    """Verify every array of a store directory (base, shard views, delta
    segments) against its recorded checksum: every byte with ``full``,
    else the head samples ``load_index`` checks. Raises
    ``StoreCorruption`` listing every failure; returns ``{"checked": n,
    "unchecked": n, "dirs": n}`` when clean (unchecked entries warn)."""
    if not os.path.exists(os.path.join(path, "MANIFEST.json")):
        raise StoreCorruption(f"{path}: no MANIFEST.json — not a store")
    errors: list[str] = []
    checked = unchecked = 0
    dirs = _manifest_dirs(path)
    for d in dirs:
        try:
            with open(os.path.join(d, "MANIFEST.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            errors.append(f"{d}: unreadable manifest ({e})")
            continue
        for name, entry in sorted(manifest.get("arrays", {}).items()):
            status, detail = verify_entry(d, name, entry, full=full)
            if status == "ok":
                checked += 1
            elif status == "unchecked":
                unchecked += 1
            else:
                errors.append(detail)
    if errors:
        raise StoreCorruption(
            f"{path}: {len(errors)} integrity failure(s):\n  " + "\n  ".join(errors)
        )
    if unchecked:
        warnings.warn(
            f"{path}: {unchecked} array(s) have no recorded checksum "
            "(pre-checksum store format); re-save to add them",
            stacklevel=2,
        )
    return {"checked": checked, "unchecked": unchecked, "dirs": len(dirs)}
