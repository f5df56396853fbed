"""Load-time integrity check of a store's arrays (read side only).

Counterpart of the read half of ``repro/store/integrity.py``: manifests
at format version 2 record per-array ``{algo, crc, head_crc, head_bytes}``
checksums; loading verifies the head sample of every array. Stores written
with ``algo: crc32`` verify with ``zlib.crc32``; ``crc32c`` ones with the
pure-Python Castagnoli CRC below (or the ``crc32c`` package when present).
"""

from __future__ import annotations

import os
import zlib

import numpy as np

__all__ = ["StoreCorruption", "crc32c_py", "checksum_update", "verify_head"]

CHECKSUM_HEAD_BYTES = 65536


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


def checksum_update(algo: str, crc: int, data) -> int:
    if algo == "crc32":
        return zlib.crc32(data, crc) & 0xFFFFFFFF
    if algo == "crc32c":
        if _crc32c_mod is not None:
            return _crc32c_mod.crc32c(bytes(data), crc)
        return crc32c_py(data, crc)
    raise ValueError(f"unknown checksum algo {algo!r}")


def _entry_nbytes(entry: dict) -> int:
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
    want = min(_entry_nbytes(entry), int(cs.get("head_bytes", CHECKSUM_HEAD_BYTES)))
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
