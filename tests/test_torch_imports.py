"""The port stands alone and runs on the card unless asked otherwise:
no JAX and no ``repro`` import anywhere in ``src/repro_torch`` or
``chip_smoke.py``; entry points refuse to fall back to the CPU; the kernel
executor refuses a CPU index."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import Retriever, WarpIndex, WarpSearchConfig
from repro_torch.serving import RetrievalServer
from repro_torch.store import load_index

torch.set_num_threads(1)  # xdist runs one test process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_fixture", "store")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = _port_files()
    assert len(files) >= 17
    bad = [
        f"{os.path.relpath(f, ROOT)}: import {m}"
        for f in files
        for m in _imported_modules(f)
        if m.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys; import repro_torch.core, repro_torch.serving, "
        "repro_torch.store, repro_torch.kernels.ops, repro_torch.data; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    idx = load_index(FIXTURE, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.from_index(idx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.from_store(FIXTURE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(FIXTURE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalServer(idx)


def test_kernel_executor_on_a_cpu_index_raises_at_plan_time():
    r = Retriever.from_store(FIXTURE, device="cpu")
    with pytest.raises(ValueError, match="executor='kernel'"):
        r.plan(WarpSearchConfig(nprobe=8, k=10, executor="kernel"))
    for executor in ("auto", "reference"):
        assert r.plan(WarpSearchConfig(nprobe=8, k=10, executor=executor)).config.executor == "reference"


def test_index_moves_between_devices_unchanged():
    idx = load_index(FIXTURE, device="cpu")
    again = WarpIndex.from_arrays(
        {f: getattr(idx, f).numpy() for f in ("centroids", "packed_codes", "token_doc_ids",
                                             "cluster_offsets", "cluster_sizes",
                                             "bucket_weights", "bucket_cutoffs")}
        | {k: getattr(idx, k) for k in ("dim", "nbits", "cap", "n_docs", "n_tokens")},
        device="cpu",
    )
    assert all(
        np.array_equal(getattr(idx, f).numpy(), getattr(again, f).numpy())
        for f in ("packed_codes", "token_doc_ids", "centroids")
    )
    assert idx.nbytes() == again.nbytes() and idx.device.type == "cpu"
