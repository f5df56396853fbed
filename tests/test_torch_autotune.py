"""The port's autotune table, tile resolution and kernel probes against the
JAX package's (CPU).

- ``geometry_key`` and its pow2 buckets, ``TunedTile``'s errors and
  ``overlap_frac``: equal to JAX's on a grid.
- Tables: both packages save the same entries byte for byte, each loads
  the other's file, a version mismatch empties both; a "cuda" entry never
  applies to a CPU plan, a "cpu" one does.
- ``resolve_tile_choice``: JAX's precedence (explicit tile, then the
  table, then the heuristic; an explicit schedule over the tuned one)
  case by case, JAX's table keyed "interpret", the port's "cpu".
- Plans: a JAX subprocess with three host devices builds a single, a
  segmented (base + one delta) and a 3-shard store and plans each at
  layouts dense / ragged / auto, without a table and with one (dense
  tile 64, ragged tile 16, which flips the single index's "auto" from
  dense to ragged). The port loads the same stores on the CPU under the
  same entries keyed "cpu": ``describe()``'s tile_c, tile_source,
  buffering, layout, worklist_tiles and worklist_buckets exactly equal,
  top-k ids equal, scores within 1e-4 (the reference executor's own
  tolerance across packages).
- Probes: a carve-out on the plain path raises (as JAX's does on its
  reference fallback), the split returns {} on a CPU index,
  ``set_kernel_probes`` / ``disable_all``, a traced CPU retrieve with
  probes armed equals the untraced one; the sweep raises without CUDA.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro.kernels import ops as jops
from repro_torch import obs
from repro_torch.core import Retriever, WarpSearchConfig, engine
from repro_torch.kernels import autotune, autotune_sweep, ops, ref
from repro_torch.kernels import fused_gather_score as fgs

torch.set_num_threads(1)  # xdist runs one test process per core

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_fixture", "store")
TOL = dict(rtol=1e-4, atol=1e-4)
TUNED = {"dense": 64, "ragged": 16}
SEARCH = dict(nprobe=8, k=10, executor="reference")
LAYOUTS = ("dense", "ragged", "auto")
STORES = ("single", "segmented", "sharded")
FIELDS = ("tile_c", "tile_source", "buffering", "layout", "worklist_tiles", "worklist_buckets")


@pytest.fixture(autouse=True)
def _reset_tables():
    yield
    autotune.set_default_table(None)
    jat.set_default_table(None)
    obs.disable_all()


# ---------------------------------------------------------------------------
# keys, entries, files
# ---------------------------------------------------------------------------

GEOMETRIES = [
    (layout, nbits, dim, cap, n_tokens)
    for layout in ("dense", "ragged")
    for nbits in (2, 4, 8)
    for dim in (64, 128)
    for cap in (0, 1, 2, 13, 128, 129, 1024)
    for n_tokens in (1, 5955, 23_710_000)
]


def test_geometry_keys_and_buckets_equal_jax():
    for layout, nbits, dim, cap, n_tokens in GEOMETRIES:
        kw = dict(nbits=nbits, dim=dim, cap=cap, n_tokens=n_tokens)
        assert autotune.geometry_key(layout, **kw) == jat.geometry_key(layout, **kw)
    for x in range(0, 1100):
        assert autotune._pow2_bucket(x) == jat._pow2_bucket(x)
    for pkg in (autotune, jat):
        with pytest.raises(ValueError, match="layout"):
            pkg.geometry_key("auto", nbits=4, dim=128, cap=8, n_tokens=8)


BAD_ENTRIES = [
    (dict(tile_c=12), "multiple of 8"),
    (dict(tile_c=0), "multiple of 8"),
    (dict(tile_c=16.0), "int"),
    (dict(buffering="triple"), "buffering"),
    (dict(measured_on="gpu"), "measured_on"),
]


def _entry(pkg, **kw):
    base = dict(tile_c=16, buffering="double", dma_us=3.0, compute_us=2.0, total_us=4.0,
                measured_on="interpret")
    return pkg.TunedTile(**{**base, **kw})


@pytest.mark.parametrize("bad,match", BAD_ENTRIES)
def test_tuned_tile_errors_match_jax(bad, match):
    for pkg in (autotune, jat):
        with pytest.raises(ValueError, match=match):
            _entry(pkg, **bad)


@pytest.mark.parametrize("dma,compute,total", [
    (3.0, 2.0, 4.0), (3.0, 2.0, 5.0), (3.0, 2.0, 3.0), (3.0, 2.0, 1.0), (0.0, 2.0, 2.0),
    (3.0, 0.0, 3.0), (1.5, 1.5, 2.25),
])
def test_overlap_frac_equals_jax(dma, compute, total):
    kw = dict(dma_us=dma, compute_us=compute, total_us=total)
    assert _entry(autotune, **kw).overlap_frac == _entry(jat, **kw).overlap_frac
    want = _entry(jat, **kw).overlap_frac
    assert autotune.overlap_frac(total, dma, compute) == want


def _table(pkg, measured_on="interpret"):
    """Three entries in ``pkg``'s table (the same in both packages)."""
    t = pkg.AutotuneTable()
    t.record("dense", _entry(pkg, tile_c=64, measured_on=measured_on),
             nbits=4, dim=128, cap=120, n_tokens=5955)
    t.record("ragged", _entry(pkg, tile_c=16, buffering="single", measured_on=measured_on),
             nbits=4, dim=128, cap=120, n_tokens=5955)
    t.record("ragged", _entry(pkg, tile_c=32, dma_us=1e-7, measured_on=measured_on),
             nbits=2, dim=64, cap=1024, n_tokens=23_710_000)
    return t


def test_table_files_byte_identical_and_cross_loadable(tmp_path):
    port, jax_t = _table(autotune), _table(jat)
    pp, jp = tmp_path / "port.json", tmp_path / "jax.json"
    port.save(str(pp))
    jax_t.save(str(jp))
    assert pp.read_bytes() == jp.read_bytes()
    assert pp.read_bytes().endswith(b"}\n")
    assert autotune.AutotuneTable.load(str(jp)).to_json() == port.to_json()
    assert jat.AutotuneTable.load(str(pp)).to_json() == jax_t.to_json()
    for k, e in autotune.AutotuneTable.load(str(jp)).entries.items():
        assert e.to_json() == jax_t.entries[k].to_json()
        assert e.overlap_frac == jax_t.entries[k].overlap_frac


def test_version_mismatch_empties_both(tmp_path):
    doc = _table(autotune).to_json()
    doc["autotune_table_version"] = 2
    path = tmp_path / "v2.json"
    path.write_text(json.dumps(doc))
    for pkg in (autotune, jat):
        assert len(pkg.AutotuneTable.from_json(doc)) == 0
        assert len(pkg.AutotuneTable.load(str(path))) == 0


def test_default_table_path_and_missing_or_corrupt_files(tmp_path, monkeypatch):
    monkeypatch.delenv(autotune.TABLE_PATH_ENV, raising=False)
    assert autotune.default_table_path() == os.path.join(ROOT, "build", "autotune_cuda.json")
    monkeypatch.setenv(autotune.TABLE_PATH_ENV, str(tmp_path / "missing.json"))
    autotune.set_default_table(None)
    assert len(autotune.get_default_table()) == 0
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    monkeypatch.setenv(autotune.TABLE_PATH_ENV, str(bad))
    autotune.set_default_table(None)
    assert len(autotune.get_default_table()) == 0
    port = _table(autotune, "cpu")
    good = tmp_path / "good.json"
    port.save(str(good))
    monkeypatch.setenv(autotune.TABLE_PATH_ENV, str(good))
    autotune.set_default_table(None)
    assert autotune.get_default_table().to_json() == port.to_json()
    # JAX refuses an entry measured on "cuda" and falls back to an empty table.
    _table(autotune, "cuda").save(str(good))
    monkeypatch.setenv(jat.TABLE_PATH_ENV, str(good))
    jat.set_default_table(None)
    assert len(jat.get_default_table()) == 0
    assert len(autotune.AutotuneTable.load(str(good))) == 3


def test_backend_kind():
    assert autotune.backend_kind(torch.device("cpu")) == "cpu"
    assert autotune.backend_kind("cuda") == "cuda"
    assert autotune.backend_kind(torch.device("cuda", 1)) == "cuda"
    assert autotune.backend_kind(None) == "cpu"


@pytest.mark.parametrize("measured_on,source", [
    ("cuda", "heuristic"), ("cpu", "autotune"), ("interpret", "heuristic"), ("tpu", "heuristic"),
])
def test_entries_apply_only_on_their_device_kind(measured_on, source):
    r = Retriever.from_store(FIXTURE, device="cpu")
    idx = r.index
    t = autotune.AutotuneTable()
    t.record("ragged", _entry(autotune, tile_c=16, measured_on=measured_on),
             nbits=idx.nbits, dim=idx.dim, cap=idx.cap, n_tokens=idx.n_tokens)
    autotune.set_default_table(t)
    d = r.plan(WarpSearchConfig(nprobe=4, k=5, layout="ragged")).describe()
    assert d["tile_source"] == source
    assert d["tile_c"] == (16 if source == "autotune" else 32)


# ---------------------------------------------------------------------------
# resolve_tile_choice case by case
# ---------------------------------------------------------------------------

GEO = dict(n_tokens=5955, nbits=4, dim=128)
CHOICES = [
    # cap, explicit tile, layout, geometry, buffering
    (120, 24, "dense", True, "auto"),
    (120, 24, "ragged", True, "single"),
    (120, None, "dense", True, "auto"),
    (120, None, "ragged", True, "auto"),
    (120, None, "ragged", True, "double"),
    (120, None, "auto", True, "auto"),
    (120, None, "dense", False, "auto"),
    (120, None, "ragged", False, "auto"),
    (1000, None, "ragged", True, "auto"),
    (1000, None, "dense", True, "single"),
    (1, None, "dense", True, "auto"),
    (0, None, "ragged", False, "auto"),
    (13, None, "dense", False, "auto"),
]


@pytest.mark.parametrize("cap,tile,layout,geo,buffering", CHOICES)
def test_resolve_tile_choice_equals_jax(cap, tile, layout, geo, buffering):
    jax_t, port_t = _table(jat, "interpret"), _table(autotune, "cpu")
    g = GEO if geo else {}
    want = jops.resolve_tile_choice(cap, tile, layout=layout, buffering=buffering, table=jax_t, **g)
    got = ops.resolve_tile_choice(
        cap, tile, layout=layout, buffering=buffering, table=port_t, device="cpu", **g
    )
    assert (got.tile_c, got.source, got.buffering) == (want.tile_c, want.source, want.buffering)
    assert ops.resolve_tile_c(cap, tile, layout=layout) == jops.resolve_tile_c(cap, tile, layout=layout)
    # The port's own table keyed by the JAX package's backend never applies.
    foreign = ops.resolve_tile_choice(
        cap, tile, layout=layout, buffering=buffering, table=_table(autotune, "interpret"),
        device="cpu", **g,
    )
    assert foreign.source in ("config", "heuristic")


# ---------------------------------------------------------------------------
# plans on JAX-built stores, both packages under the same entries
# ---------------------------------------------------------------------------

JAX_SCRIPT = r"""
import json, os, shutil, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
import numpy as np
from repro.core import (IndexBuildConfig, Retriever, WarpSearchConfig, build_index,
                        build_sharded_index)
from repro.data import make_corpus, make_queries
from repro.kernels import autotune
from repro.store import add_documents, save_index

out = sys.argv[1]
tuned, search, layouts = (json.loads(a) for a in sys.argv[2:5])
corpus = make_corpus(n_docs=300, mean_doc_len=20, seed=0)
delta = make_corpus(n_docs=40, mean_doc_len=20, seed=5)
q, qmask, _ = make_queries(corpus, n_queries=4, tokens_per_query=(2, 24), seed=1)
cfg = IndexBuildConfig(nbits=4, kmeans_iters=2, n_centroids=64)
paths = {s: os.path.join(out, s) for s in ("single", "segmented", "sharded")}
save_index(build_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, cfg), paths["single"],
           build_config=cfg)
shutil.copytree(paths["single"], paths["segmented"])
add_documents(paths["segmented"], delta.emb, delta.token_doc_ids, delta.n_docs)
sidx = build_sharded_index(corpus.emb, corpus.token_doc_ids, corpus.n_docs, 3,
                           IndexBuildConfig(nbits=4, kmeans_iters=2, n_centroids=32))
save_index(sidx, paths["sharded"], build_config=cfg)
res, desc = dict(q=q, qmask=qmask), {}
for store, path in paths.items():
    r = Retriever.from_store(path)
    idx = r.index
    n_tokens = idx.resolved_n_tokens() if r.is_sharded else idx.n_tokens
    geo = dict(nbits=idx.nbits, dim=idx.dim, cap=idx.cap, n_tokens=n_tokens)
    desc[store + "/geometry"] = geo
    table = autotune.AutotuneTable()
    for layout, tile in tuned.items():
        table.record(layout, autotune.TunedTile(tile, "double", 1.0, 1.0, 1.5, "interpret"), **geo)
    for arm, tbl in (("heuristic", autotune.AutotuneTable()), ("tuned", table)):
        autotune.set_default_table(tbl)
        r = Retriever.from_store(path)
        for layout in layouts:
            p = r.plan(WarpSearchConfig(**search, gather="fused", layout=layout))
            desc[f"{store}/{arm}/{layout}"] = p.describe()
            if arm == "tuned":
                b = p.retrieve_batch(q, qmask)
                res[f"{store}/{layout}/ids"] = np.asarray(b.doc_ids)
                res[f"{store}/{layout}/scores"] = np.asarray(b.scores)
np.savez(os.path.join(out, "jax.npz"), **res)
with open(os.path.join(out, "describe.json"), "w") as f:
    json.dump(desc, f, default=str)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_plans(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("autotune_jax"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    args = [json.dumps(a) for a in (TUNED, SEARCH, list(LAYOUTS))]
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, out, *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
    )
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    with open(os.path.join(out, "describe.json")) as f:
        desc = json.load(f)
    return dict(out=out, z=dict(np.load(os.path.join(out, "jax.npz"))), describe=desc)


def _port_table(geo):
    t = autotune.AutotuneTable()
    for layout, tile in TUNED.items():
        t.record(layout, autotune.TunedTile(tile, "double", 1.0, 1.0, 1.5, "cpu"), **geo)
    return t


@pytest.mark.parametrize("store", STORES)
def test_tuned_plans_equal_jax(jax_plans, store):
    desc, z = jax_plans["describe"], jax_plans["z"]
    path = os.path.join(jax_plans["out"], store)
    geo = desc[store + "/geometry"]
    r = Retriever.from_store(path, device="cpu")
    n_tokens = r.index.resolved_n_tokens() if r.is_sharded else r.index.n_tokens
    assert dict(nbits=r.index.nbits, dim=r.index.dim, cap=r.index.cap, n_tokens=n_tokens) == geo
    for arm, table in (("heuristic", autotune.AutotuneTable()), ("tuned", _port_table(geo))):
        autotune.set_default_table(table)
        r = Retriever.from_store(path, device="cpu")
        for layout in LAYOUTS:
            plan = r.plan(WarpSearchConfig(**SEARCH, gather="fused", layout=layout))
            got, want = plan.describe(), desc[f"{store}/{arm}/{layout}"]
            assert {f: got[f] for f in FIELDS} == {f: want[f] for f in FIELDS}, (arm, layout)
            assert got["tile_source"] == ("autotune" if arm == "tuned" else "heuristic")
            if arm == "heuristic":
                continue
            assert got["tile_c"] == TUNED[got["layout"]]
            res = plan.retrieve_batch(z["q"], z["qmask"])
            np.testing.assert_array_equal(res.doc_ids.numpy(), z[f"{store}/{layout}/ids"])
            np.testing.assert_allclose(res.scores.numpy(), z[f"{store}/{layout}/scores"], **TOL)


def test_tuned_ragged_tile_flips_auto_like_jax(jax_plans):
    """The single store's "auto": dense under the heuristic's ragged tile
    32, ragged under the tuned 16, in both packages (the plans themselves
    are held to JAX's in ``test_tuned_plans_equal_jax``)."""
    desc = jax_plans["describe"]
    assert desc["single/heuristic/auto"]["layout"] == "dense"
    assert desc["single/tuned/auto"]["layout"] == "ragged"
    assert desc["single/tuned/auto"]["tile_c"] == TUNED["ragged"]


# ---------------------------------------------------------------------------
# probes, the split, the sweep
# ---------------------------------------------------------------------------


def _probe_inputs():
    rng = np.random.default_rng(3)
    n, pb, q, p, cap = 200, 64, 3, 4, 24
    codes = torch.from_numpy(rng.integers(0, 256, (n, pb), dtype=np.uint8))
    offsets = torch.tensor([0, 30, 60, 100, 150, 200], dtype=torch.int32)
    sizes = torch.tensor([24, 20, 24, 10, 24], dtype=torch.int32)
    cids = torch.from_numpy(rng.integers(0, 5, (q, p))).long()
    pscores = torch.from_numpy(rng.standard_normal((q, p)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((q, 128, 16)).astype(np.float32))
    return codes, offsets, sizes, cids, pscores, v, cap


@pytest.mark.parametrize("use_kernel", [False, True])
def test_probes_raise_on_the_plain_path(use_kernel):
    codes, offsets, sizes, cids, pscores, v, cap = _probe_inputs()
    kw = dict(nbits=4, dim=128, cap=cap, use_kernel=use_kernel)
    args = (codes, offsets, sizes, cids, pscores, v)
    base = ops.fused_gather_selective_sum(*args, **kw)
    assert torch.equal(ops.fused_gather_selective_sum(*args, **kw, probe="full"), base)
    for probe in ("dma", "compute"):
        with pytest.raises(ValueError, match=probe):
            ops.fused_gather_selective_sum(*args, **kw, probe=probe)
    with pytest.raises(ValueError, match="carve-out"):
        ops.fused_gather_selective_sum(*args, **kw, probe="bogus")
    with pytest.raises(ValueError, match="double"):
        ops.fused_gather_selective_sum(*args, **kw, buffering="single", probe="compute")
    starts, nv = offsets[cids.reshape(-1)], sizes[cids.reshape(-1)]
    qtok = torch.arange(3).repeat_interleave(4).int()
    rkw = dict(nbits=4, dim=128, tile_c=32, use_kernel=use_kernel)
    rargs = (codes, starts, nv, qtok, pscores.reshape(-1), v)
    rbase = ops.ragged_fused_gather_selective_sum(*rargs, **rkw)
    assert torch.equal(ops.ragged_fused_gather_selective_sum(*rargs, **rkw, probe="full"), rbase)
    for probe in ("dma", "compute"):
        with pytest.raises(ValueError, match=probe):
            ops.ragged_fused_gather_selective_sum(*rargs, **rkw, probe=probe)
    with pytest.raises(ValueError, match="double"):
        ops.ragged_fused_gather_selective_sum(*rargs, **rkw, buffering="single", probe="compute")
    # The CUDA wrappers, which launch the carve-outs: a CPU tensor raises.
    for probe in ("full", "dma", "compute"):
        with pytest.raises(ValueError, match="cpu"):
            fgs.fused_gather_score_cuda(codes, starts.reshape(3, 4), nv.reshape(3, 4), pscores,
                                        v, nbits=4, dim=128, cap=cap, probe=probe)
        with pytest.raises(ValueError, match="cpu"):
            fgs.ragged_fused_gather_score_cuda(*rargs, nbits=4, dim=128, tile_c=32, probe=probe)


def test_jax_rejects_probes_on_its_reference_too():
    """The JAX package's own rule, which the port's errors follow."""
    import jax.numpy as jnp

    codes, offsets, sizes, cids, pscores, v, cap = _probe_inputs()
    with pytest.raises(ValueError, match="probe"):
        jops.fused_gather_selective_sum(
            jnp.asarray(codes.numpy()), jnp.asarray(offsets.numpy()), jnp.asarray(sizes.numpy()),
            jnp.asarray(cids.numpy()), jnp.asarray(pscores.numpy()), jnp.asarray(v.numpy()),
            nbits=4, dim=128, cap=cap, n_tokens=200, use_kernel=False, probe="dma",
        )


@pytest.mark.parametrize("gather,layout,executor", [
    ("fused", "dense", "reference"), ("fused", "ragged", "reference"),
    ("materialize", "ragged", "reference"), ("fused", "ragged", "auto"),
])
def test_split_is_empty_off_the_card(gather, layout, executor):
    r = Retriever.from_store(FIXTURE, device="cpu")
    fdir = os.path.dirname(FIXTURE)
    z = np.load(os.path.join(fdir, "queries.npz"))
    q, m = torch.from_numpy(z["q"][:2]), torch.from_numpy(z["qmask"][:2])
    plan = r.plan(WarpSearchConfig(nprobe=4, k=5, gather=gather, layout=layout, executor=executor))
    sel = engine.select_probes(r.index, q, m, plan.config)
    assert engine.kernel_dma_compute_split(r.index, q, m, sel, plan.config) == {}
    # A kernel config on a CPU index (as a plan on the card would carry it).
    import dataclasses

    kcfg = dataclasses.replace(plan.config, executor="kernel")
    assert engine.kernel_dma_compute_split(r.index, q, m, sel, kcfg) == {}


def test_set_kernel_probes_and_disable_all():
    assert obs.STATE.kernel_probes is False
    obs.set_kernel_probes(1)
    assert obs.STATE.kernel_probes is True
    obs.set_kernel_probes(False)
    assert obs.STATE.kernel_probes is False
    obs.set_kernel_probes(True)
    obs.enable_metrics(obs.MetricsRegistry())
    obs.disable_all()
    assert obs.STATE.kernel_probes is False and obs.STATE.metrics is None


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_traced_cpu_retrieve_with_probes_equals_untraced(layout):
    r = Retriever.from_store(FIXTURE, device="cpu")
    z = np.load(os.path.join(os.path.dirname(FIXTURE), "queries.npz"))
    plan = r.plan(WarpSearchConfig(nprobe=4, k=5, gather="fused", layout=layout))
    base = [plan.retrieve(z["q"][i], z["qmask"][i]) for i in range(2)]
    tracer = obs.set_tracer(obs.Tracer())
    obs.set_kernel_probes(True)
    got = [plan.retrieve(z["q"][i], z["qmask"][i]) for i in range(2)]
    obs.disable_all()
    for a, b in zip(got, base):
        assert torch.equal(a.doc_ids, b.doc_ids) and torch.equal(a.scores, b.scores)
    spans = [e for e in tracer.events() if e.name == "gather_score"]
    assert len(spans) == 2 and all("dma_ms" not in e.args for e in spans)


def test_sweep_raises_without_cuda(monkeypatch, tmp_path):
    r = Retriever.from_store(FIXTURE, device="cpu")
    q, qmask = autotune_sweep.sweep_queries(r.index, 4, seed=0)
    with pytest.raises(RuntimeError, match="card"):
        autotune_sweep.run(r.index, q, qmask, out_path=str(tmp_path / "t.json"))
    assert not (tmp_path / "t.json").exists()
    starts, sizes, pscores, v = autotune_sweep.sweep_probe_set(r.index, q, qmask, nprobe=4, qtokens=4)
    with pytest.raises(RuntimeError, match="card"):
        autotune_sweep.dense_point(r.index, starts, sizes, pscores, v, flush=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="card"):
        autotune_sweep.main(["--store", FIXTURE, "--out", str(tmp_path / "t.json")])
    for flag in ("--seed", "--tiles", "--nprobe", "--qtokens"):  # not the sweep's knobs
        with pytest.raises(SystemExit):
            autotune_sweep.main(["--store", FIXTURE, flag, "4"])


def _np_fold(row: np.ndarray) -> np.float32:
    """score_rows::sink_staged spelled out: XOR of the little-endian words
    of the whole 16-byte units, then of the remaining bytes, folded."""
    full = len(row) // 16 * 16
    x = 0
    for word in np.frombuffer(row[:full].tobytes(), dtype="<u4"):
        x ^= int(word)
    for byte in row[full:]:
        x ^= int(byte)
    return np.float32((x ^ (x >> 16)) & 0xFFFF)


def _np_sink_chain(codes, row, base, nbits, dim, dc):
    acc = None
    for d0 in range(0, dim, dc):
        s = _np_fold(codes[row, d0 * nbits // 8:min(dim, d0 + dc) * nbits // 8])
        acc = np.float32(s + np.float32(base)) if acc is None else np.float32(acc + s)
    return acc


# nbits, dim, dims per v-table chunk: rows of bytes only, of whole units,
# of a unit and 4 bytes in two chunks, and four chunks of 64 bytes.
DMA_TWIN_CASES = [(2, 32, 32), (4, 128, 128), (4, 40, 32), (8, 256, 64)]


@pytest.mark.parametrize("nbits,dim,dc", DMA_TWIN_CASES)
def test_dma_twins_are_the_probe_score_plus_each_rows_fold(nbits, dim, dc):
    """``ref.fused_gather_score_dma`` / ``ref.ragged_fused_gather_score_dma``
    (what the card tests and chip_smoke hold the "dma" carve-out to, bit
    for bit) against a numpy statement of the kernel's sink, slot by slot:
    rows past the codes, sizes past cap and tiles of an unknown token 0."""
    rng = np.random.default_rng(11 + nbits + dim)
    n, pb, cap = 40, dim * nbits // 8, 8
    codes = rng.integers(0, 256, (n, pb), dtype=np.uint8)
    starts = np.array([[0, 35, 10], [-2, 20, 5]], dtype=np.int32)
    sizes = np.array([[8, 8, 3], [4, 12, -1]], dtype=np.int32)
    ps = rng.standard_normal((2, 3)).astype(np.float32)
    got = ref.fused_gather_score_dma(
        torch.from_numpy(codes), torch.from_numpy(starts), torch.from_numpy(sizes),
        torch.from_numpy(ps), nbits=nbits, dim=dim, cap=cap, dims_per_chunk=dc,
    ).numpy()
    want = np.zeros((2, 3, cap), np.float32)
    for q, p, c in np.ndindex(2, 3, cap):
        row = starts[q, p] + c
        if c < min(max(sizes[q, p], 0), cap) and 0 <= row < n:
            want[q, p, c] = _np_sink_chain(codes, row, ps[q, p], nbits, dim, dc)
    np.testing.assert_array_equal(got, want)

    row0 = np.array([0, 36, 12, 3], dtype=np.int32)
    nvalid = np.array([8, 8, 5, 8], dtype=np.int32)
    qtok = np.array([0, 1, 1, 2], dtype=np.int32)  # token 2 of 2: stages nothing
    pscore = rng.standard_normal(4).astype(np.float32)
    got = ref.ragged_fused_gather_score_dma(
        torch.from_numpy(codes), *(torch.from_numpy(a) for a in (row0, nvalid, qtok, pscore)),
        nbits=nbits, dim=dim, tile_c=cap, n_q=2, dims_per_chunk=dc,
    ).numpy()
    want = np.zeros((4, cap), np.float32)
    for w, c in np.ndindex(4, cap):
        row = row0[w] + c
        if qtok[w] < 2 and c < nvalid[w] and row < n:
            want[w, c] = _np_sink_chain(codes, row, pscore[w], nbits, dim, dc)
    np.testing.assert_array_equal(got, want.reshape(-1))
