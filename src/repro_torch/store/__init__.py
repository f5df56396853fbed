"""Index store of the PyTorch port: the reader, the writer, the chunked
builder, the integrity checks, and delta segments (add, delete, compact)."""

from repro_torch.store.builder import array_chunks, build_index_chunked, build_index_to_store
from repro_torch.store.format import (
    inspect_index,
    load_index,
    load_shard,
    read_manifest,
    save_index,
)
from repro_torch.store.integrity import StoreCorruption, crc32c_py, verify_store
from repro_torch.store.segments import (
    SegmentedWarpIndex,
    add_documents,
    compact,
    delete_documents,
    delta_stats,
    load_segmented,
    read_tombstones,
)

__all__ = [
    "SegmentedWarpIndex",
    "StoreCorruption",
    "add_documents",
    "compact",
    "delete_documents",
    "delta_stats",
    "load_segmented",
    "read_tombstones",
    "array_chunks",
    "build_index_chunked",
    "build_index_to_store",
    "crc32c_py",
    "inspect_index",
    "load_index",
    "load_shard",
    "read_manifest",
    "save_index",
    "verify_store",
]
