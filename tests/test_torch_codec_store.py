"""Port parity: b-bit codec and store reader of ``repro_torch`` against
the JAX package on the same numpy inputs."""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.store import load_index as jax_load_index
from repro.store import save_index
from repro_torch.core import Retriever, WarpIndex, quantization as tq
from repro_torch.store import StoreCorruption, crc32c_py, load_index, read_manifest

torch.set_num_threads(1)  # xdist runs one test process per core

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "torch_fixture", "store")
ARRAYS = (
    "centroids", "packed_codes", "token_doc_ids", "cluster_offsets",
    "cluster_sizes", "bucket_weights", "bucket_cutoffs",
)


@pytest.mark.parametrize("nbits", [2, 4, 8])
@pytest.mark.parametrize("dim", [1, 7, 128, 513])
def test_pack_unpack_match_jax(nbits, dim):
    rng = np.random.default_rng(dim * 10 + nbits)
    codes = rng.integers(0, 1 << nbits, (5, dim), dtype=np.uint8)
    packed_j = np.array(jq.pack_codes(jnp.asarray(codes), nbits))
    packed_t = tq.pack_codes(torch.from_numpy(codes), nbits).numpy()
    np.testing.assert_array_equal(packed_t, packed_j)
    assert packed_t.shape[-1] == tq.packed_bytes(dim, nbits)
    unpacked = tq.unpack_codes(torch.from_numpy(packed_j), nbits, dim).numpy()
    np.testing.assert_array_equal(unpacked, codes)
    np.testing.assert_array_equal(
        unpacked, np.asarray(jq.unpack_codes(jnp.asarray(packed_j), nbits, dim))
    )


def test_decompress_matches_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 16, (6, 32), dtype=np.uint8)
    packed = np.array(jq.pack_codes(jnp.asarray(codes), 4))
    cent = rng.standard_normal((6, 32)).astype(np.float32)
    w = np.sort(rng.standard_normal(16)).astype(np.float32)
    want = jq.decompress(jnp.asarray(packed), jnp.asarray(cent), jnp.asarray(w), nbits=4, dim=32)
    got = tq.decompress(
        torch.from_numpy(packed), torch.from_numpy(cent), torch.from_numpy(w), nbits=4, dim=32
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0)


def test_store_arrays_byte_identical_to_jax_loader():
    want = jax_load_index(FIXTURE)
    got = load_index(FIXTURE, device="cpu")
    for name in ARRAYS:
        a, b = got.__getattribute__(name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), name
    for k in ("dim", "nbits", "cap", "n_docs", "n_tokens"):
        assert getattr(got, k) == getattr(want, k)


def test_from_arrays_takes_a_jax_index():
    jidx = jax_load_index(FIXTURE)
    idx = WarpIndex.from_arrays(jidx, device="cpu")
    for name in ARRAYS:
        assert idx.__getattribute__(name).numpy().tobytes() == np.asarray(
            getattr(jidx, name)
        ).tobytes()
    assert Retriever.from_index(jidx, device="cpu").n_docs == jidx.n_docs


def _copy_store(tmp_path):
    dst = tmp_path / "store"
    shutil.copytree(FIXTURE, dst)
    return str(dst)


def test_flipped_head_byte_raises(tmp_path):
    path = _copy_store(tmp_path)
    binp = os.path.join(path, "arrays", "packed_codes.bin")
    with open(binp, "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(StoreCorruption, match="packed_codes"):
        load_index(path, device="cpu")


def test_truncated_array_raises(tmp_path):
    path = _copy_store(tmp_path)
    binp = os.path.join(path, "arrays", "token_doc_ids.bin")
    with open(binp, "r+b") as f:
        f.truncate(16)
    with pytest.raises(StoreCorruption, match="truncated"):
        load_index(path, device="cpu")


def test_v1_manifest_loads_with_warning(tmp_path):
    path = _copy_store(tmp_path)
    mpath = os.path.join(path, "MANIFEST.json")
    with open(mpath) as f:
        m = json.load(f)
    m["version"] = 1
    for e in m["arrays"].values():
        e.pop("checksum", None)
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.warns(UserWarning, match="pre-checksum"):
        idx = load_index(path, device="cpu")
    assert idx.n_tokens == read_manifest(FIXTURE)["static"]["n_tokens"]


def test_crc32c_vector_and_crc32c_store(tmp_path):
    assert crc32c_py(b"123456789") == 0xE3069283
    path = _copy_store(tmp_path)
    mpath = os.path.join(path, "MANIFEST.json")
    with open(mpath) as f:
        m = json.load(f)
    for e in m["arrays"].values():
        with open(os.path.join(path, e["file"]), "rb") as f:
            head = f.read(e["checksum"]["head_bytes"])
        e["checksum"].update(algo="crc32c", head_crc=crc32c_py(head))
    with open(mpath, "w") as f:
        json.dump(m, f)
    assert load_index(path, device="cpu").n_docs == m["static"]["n_docs"]


def test_unported_store_kinds_raise(tmp_path):
    path = _copy_store(tmp_path)
    seg = os.path.join(path, "segments", "seg_00000")
    os.makedirs(seg)
    with open(os.path.join(seg, "MANIFEST.json"), "w") as f:
        f.write("{}")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_index(path, device="cpu")
    mpath = os.path.join(path, "MANIFEST.json")
    with open(mpath) as f:
        m = json.load(f)
    m["kind"] = "sharded_warp_index"
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_index(path, device="cpu")


def test_missing_store_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_index(str(tmp_path / "nothing"), device="cpu")


def test_saved_then_loaded_jax_index_round_trips(tmp_path):
    jidx = jax_load_index(FIXTURE)
    out = save_index(jidx, str(tmp_path / "resaved"))
    a, b = load_index(out, device="cpu"), load_index(FIXTURE, device="cpu")
    for name in ARRAYS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
