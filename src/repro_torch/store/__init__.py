"""Store reader of the PyTorch port (single-index stores)."""

from repro_torch.store.format import load_index, read_manifest
from repro_torch.store.integrity import StoreCorruption, crc32c_py

__all__ = ["StoreCorruption", "crc32c_py", "load_index", "read_manifest"]
