"""The port stands alone and runs on the card unless asked otherwise:
no JAX and no ``repro`` import anywhere in ``src/repro_torch`` (the
retrieval slice, the LM slice: models, configs, generation, the flash
kernel, the recsys slice: models, configs, the embedding-bag kernel, and
the index build: k-means, the builder, the baselines, the warp-xtr
configs, the CLI, segmented indexes: doc filters, delta segments, and the
serving surface: ``obs``, ``fault``, the server's cache, admission,
scheduler and batcher, the serve launcher, the document-sharded index and
the token encoder, the LM zoo and training: MoE, the arch registry and
families, the optimizer, loop, checkpoints, compression, the batch
pipeline and the train launcher) or ``chip_smoke.py``; entry points
refuse to fall back to the CPU (the server, its reloads and tenants on
the server's device, the serve launcher, the sharded build, the encoder's
weights, the LM's weights and cache, the train loop and launcher); the
kernel executor refuses a CPU index and CPU recsys weights."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import (
    Retriever,
    WarpIndex,
    WarpSearchConfig,
    build_index,
    build_sharded_index,
    maxsim_bruteforce,
    plaid_style_search,
    xtr_reference,
)
from repro_torch.launch import build_index as build_index_cli
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import RetrievalServer
from repro_torch.store import add_documents, array_chunks, build_index_to_store, load_index

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
    assert len(files) >= 24
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {
        "src/repro_torch/models/layers.py",
        "src/repro_torch/models/transformer.py",
        "src/repro_torch/models/convert.py",
        "src/repro_torch/configs/qwen2_0_5b.py",
        "src/repro_torch/serving/generate.py",
        "src/repro_torch/kernels/flash_attention.py",
        "src/repro_torch/models/recsys.py",
        "src/repro_torch/configs/families.py",
        "src/repro_torch/configs/two_tower_retrieval.py",
        "src/repro_torch/configs/din.py",
        "src/repro_torch/configs/xdeepfm.py",
        "src/repro_torch/configs/sasrec.py",
        "src/repro_torch/kernels/embedding_bag.py",
        "src/repro_torch/core/kmeans.py",
        "src/repro_torch/core/index.py",
        "src/repro_torch/core/baselines.py",
        "src/repro_torch/store/builder.py",
        "src/repro_torch/configs/warp_family.py",
        "src/repro_torch/configs/warp_xtr.py",
        "src/repro_torch/launch/build_index.py",
        "src/repro_torch/core/docfilter.py",
        "src/repro_torch/store/segments.py",
        "src/repro_torch/obs/__init__.py",
        "src/repro_torch/obs/metrics.py",
        "src/repro_torch/obs/trace.py",
        "src/repro_torch/fault/__init__.py",
        "src/repro_torch/fault/plan.py",
        "src/repro_torch/serving/cache.py",
        "src/repro_torch/serving/admission.py",
        "src/repro_torch/serving/scheduler.py",
        "src/repro_torch/serving/batcher.py",
        "src/repro_torch/launch/serve.py",
        "src/repro_torch/core/distributed.py",
        "src/repro_torch/models/encoder.py",
        "src/repro_torch/models/moe.py",
        "src/repro_torch/configs/base.py",
        "src/repro_torch/configs/registry.py",
        "src/repro_torch/configs/qwen3_4b.py",
        "src/repro_torch/configs/yi_6b.py",
        "src/repro_torch/configs/mixtral_8x7b.py",
        "src/repro_torch/configs/dbrx_132b.py",
        "src/repro_torch/train/__init__.py",
        "src/repro_torch/train/optimizer.py",
        "src/repro_torch/train/loop.py",
        "src/repro_torch/train/checkpoint.py",
        "src/repro_torch/train/compression.py",
        "src/repro_torch/data/pipeline.py",
        "src/repro_torch/launch/train.py",
    } <= names
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
        "repro_torch.store, repro_torch.kernels.ops, repro_torch.data, "
        "repro_torch.models, repro_torch.configs.qwen2_0_5b, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.embedding_bag, "
        "repro_torch.configs.two_tower_retrieval, repro_torch.configs.din, "
        "repro_torch.configs.xdeepfm, repro_torch.configs.sasrec, "
        "repro_torch.core.kmeans, repro_torch.core.index, repro_torch.core.baselines, "
        "repro_torch.store.builder, repro_torch.configs.warp_family, "
        "repro_torch.configs.warp_xtr, repro_torch.launch.build_index, "
        "repro_torch.core.docfilter, repro_torch.store.segments, "
        "repro_torch.obs, repro_torch.fault, repro_torch.serving.cache, "
        "repro_torch.serving.admission, repro_torch.launch.serve, "
        "repro_torch.core.distributed, repro_torch.models.encoder, "
        "repro_torch.models.moe, repro_torch.configs.registry, repro_torch.train, "
        "repro_torch.data.pipeline, repro_torch.launch.train; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
        "assert not bad, bad; "
        "from repro_torch.kernels import _build; "
        "assert not _build._LIBS, 'a kernel library was built or loaded at import'"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    idx = load_index(FIXTURE, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.from_index(idx)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.from_store(FIXTURE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(FIXTURE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalServer(idx)
    emb, doc_ids = torch.randn(64, 8), torch.arange(64, dtype=torch.int32) // 4
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.build(emb, doc_ids, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(emb, doc_ids, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Retriever.build(emb, doc_ids, 16, n_shards=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_sharded_index(emb, doc_ids, 16, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index_to_store(array_chunks(emb, doc_ids), str(tmp_path / "s"), 16)
    q, qmask = emb[:3], torch.ones(3, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        maxsim_bruteforce(q, qmask, emb, doc_ids, n_docs=16, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xtr_reference(q, qmask, emb, doc_ids, k_prime=8, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plaid_style_search(idx, torch.zeros(3, idx.dim))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        add_documents(str(tmp_path / "s"), emb, doc_ids, 16)
    for cmd in (["build", "--out", str(tmp_path / "c"), "--synth-docs", "20"],
                ["add", "--index", FIXTURE, "--synth-docs", "2"],
                ["smoke", "--index", FIXTURE],
                ["build", "--out", str(tmp_path / "d"), "--synth-docs", "20", "--n-shards", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_index_cli.main(cmd)
    for cmd in ([], ["--traffic", "poisson", "--tenants", "2", "--trace-out", str(tmp_path / "t")],
                ["--n-shards", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_cli.main(cmd)


def test_lm_and_training_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from repro_torch.configs import mixtral_8x7b
    from repro_torch.configs.families import LMFamily, lm_loss_fn
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import KVCache, init_params
    from repro_torch.train import AdamWConfig, train_loop

    cfg = mixtral_8x7b.REDUCED
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KVCache.empty(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMFamily.smoke(get_arch("mixtral-8x7b"), "train_4k")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(init_params_fn=lambda: init_params(cfg, device="cpu"), loss_fn=lm_loss_fn(cfg),
                   batch_iter=lambda s: {}, opt_cfg=AdamWConfig(), n_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "qwen2-0.5b", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_server_tenants_and_reloads_follow_the_server_device(no_cuda, tmp_path):
    """The server's device defaults to the card (raising without it);
    ``add_tenant`` and ``reload`` of a store path load onto the server's
    device, and never onto another on their own."""
    idx = load_index(FIXTURE, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalServer(idx, WarpSearchConfig(nprobe=8, k=10))
    srv = RetrievalServer(idx, WarpSearchConfig(nprobe=8, k=10), device="cpu")
    assert srv.device.type == "cpu"
    srv.add_tenant("t", FIXTURE)
    srv.reload(FIXTURE)
    assert srv.retriever.device.type == "cpu" and srv._state("t").retriever.device.type == "cpu"
    assert srv.summary()["device"] == "cpu"


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


def test_recsys_init_params_defaults_to_cuda_and_raises_without_it(no_cuda):
    from repro_torch.configs import two_tower_retrieval
    from repro_torch.models import init_params

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(two_tower_retrieval.REDUCED)


@pytest.mark.parametrize("name", ["two_tower_retrieval", "din", "xdeepfm", "sasrec"])
def test_recsys_kernel_executor_refuses_cpu_weights(name):
    import importlib

    from repro_torch.models import init_params
    from repro_torch.models.recsys import RECSYS_MODELS

    cfg = importlib.import_module(f"repro_torch.configs.{name}").REDUCED
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="executor='kernel'"):
        RECSYS_MODELS[type(cfg)].from_params(cfg, params, executor="kernel")
