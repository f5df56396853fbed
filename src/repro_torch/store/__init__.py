"""Index store of the PyTorch port (single-index stores): the reader, the
writer, the chunked builder and the integrity checks."""

from repro_torch.store.builder import array_chunks, build_index_chunked, build_index_to_store
from repro_torch.store.format import inspect_index, load_index, read_manifest, save_index
from repro_torch.store.integrity import StoreCorruption, crc32c_py, verify_store

__all__ = [
    "StoreCorruption",
    "array_chunks",
    "build_index_chunked",
    "build_index_to_store",
    "crc32c_py",
    "inspect_index",
    "load_index",
    "read_manifest",
    "save_index",
    "verify_store",
]
