"""The port's partition-spec rules (``repro_torch/launch/sharding.py``,
the families' ``state_pspec`` / ``input_pspec``) against JAX's, leaf by
leaf through the port's name and transposition map
(``repro_torch/models/convert.py::jax_leaf`` / ``port_layout``), for every
arch x shape of the registry on the production meshes (16x16 and
2x16x16, abstract on both sides) and on (1, 4), (2, 2) and (4, 1). The LM
rule is also held to JAX's at both ``moe_weight_mode``s and all three
``embed_shard``s, and ZeRO-1's moments under ``tp_only``."""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as jax_registry
from repro.launch import sharding as jax_sharding
from repro.models.transformer import TransformerLM as JaxLM
from repro_torch.configs import registry
from repro_torch.configs.families import _param_specs
from repro_torch.launch import sharding
from repro_torch.launch.mesh import data_axes, make_mesh, make_production_mesh
from repro_torch.models.convert import jax_leaf, port_layout

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
}
CELLS = [(a, s) for a in registry.ARCHS for s in registry.get_arch(a).shapes]


def _meshes(key):
    shape, axes = MESHES[key]
    return make_mesh(shape, axes), AbstractMesh(shape, axes)


def _norm(spec) -> tuple:
    """A JAX PartitionSpec's entries as the port states them."""
    out = []
    for p in spec:
        if p is None or p == ():
            out.append(None)
        elif isinstance(p, str):
            out.append((p,))
        else:
            out.append(tuple(p))
    return tuple(out)


def _at(tree, path):
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif isinstance(k, int):
            tree = tree[k]
        else:
            tree = getattr(tree, k)
    return tree


def _jax_paths(tree) -> set:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = set()
    for path, _ in leaves:
        keys = []
        for e in path:
            if isinstance(e, jax.tree_util.DictKey):
                keys.append(e.key)
            elif isinstance(e, jax.tree_util.GetAttrKey):
                keys.append(e.name)
            else:
                keys.append(e.idx)
        out.add(tuple(keys))
    return out


def _compare(port: dict, jax_tree, *, stacked: bool, prefix=()) -> set:
    """Every port leaf equals its JAX leaf's spec in the port's layout;
    returns the JAX paths visited."""
    seen = set()
    for name, spec in port.items():
        if isinstance(spec, dict):
            seen |= _compare(spec, jax_tree, stacked=stacked, prefix=prefix + (name,))
            continue
        path, _, _ = jax_leaf(name, stacked=stacked)
        want = _at(jax_tree, prefix + path)
        assert isinstance(spec, sharding.PartitionSpec), (name, spec)
        assert tuple(spec) == port_layout(_norm(want), name, stacked=stacked), (prefix, name)
        seen.add(prefix + path)
    return seen


def test_production_meshes_and_data_axes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (one.shape, one.axis_names) == ({"data": 16, "model": 16}, ("data", "model"))
    assert two.shape == {"pod": 2, "data": 16, "model": 16}
    assert data_axes(one) == ("data",) and data_axes(two) == ("pod", "data")
    assert one.is_abstract and one.size == 256 and two.size == 512


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_family_specs_match_jax(arch, shape, mesh_key):
    port_mesh, jax_mesh = _meshes(mesh_key)
    a, ja = registry.get_arch(arch), jax_registry.get_arch(arch)
    stacked = a.family.name == "lm"
    got = a.family.state_pspec(a, shape, port_mesh)
    want = ja.family.state_pspec(ja, shape, jax_mesh)
    if a.family.name == "warp":
        assert {k: tuple(v) for k, v in got.items()} == {
            k: _norm(getattr(want, k)) for k in got}
        assert {(k,) for k in got} == _jax_paths(want)
    else:
        seen = _compare(got, want, stacked=stacked)
        assert seen == _jax_paths(want)
    got_in = a.family.input_pspec(a, shape, port_mesh)
    want_in = ja.family.input_pspec(ja, shape, jax_mesh)
    for name, spec in got_in.items():
        w = want_in[name]
        if isinstance(spec, dict):  # the KV cache
            for k, s in spec.items():
                assert tuple(s) == _norm(getattr(w, k)), (name, k)
        else:
            assert tuple(spec) == _norm(w), name
    assert set(got_in) == set(want_in)


LMS = [a for a in registry.ARCHS if registry.get_arch(a).family.name == "lm"]


@pytest.mark.parametrize("mesh_key", ["16x16", "2x16x16", "2x2"])
@pytest.mark.parametrize("embed_shard", ["d", "vocab", "replicated"])
@pytest.mark.parametrize("moe_mode", ["fsdp", "tp_only"])
@pytest.mark.parametrize("arch", LMS)
def test_lm_param_pspec_modes_match_jax(arch, moe_mode, embed_shard, mesh_key):
    port_mesh, jax_mesh = _meshes(mesh_key)
    cfg = registry.get_arch(arch).config
    jcfg = jax_registry.get_arch(arch).config
    abs_params = jax.eval_shape(lambda: JaxLM.init(jax.random.PRNGKey(0), jcfg))
    want = jax_sharding.lm_param_pspec(abs_params, jax_mesh, embed_shard=embed_shard,
                                       moe_weight_mode=moe_mode)
    params = _param_specs(cfg)
    got = sharding.lm_param_pspec(params, port_mesh, embed_shard=embed_shard,
                                  moe_weight_mode=moe_mode)
    assert _compare(got, want, stacked=True) == _jax_paths(want)
    # ZeRO-1's moments over the same layout.
    want_z = jax_sharding.zero1_opt_pspec(want, abs_params, jax_mesh)
    got_z = sharding.zero1_opt_pspec(got, params, port_mesh)
    assert _compare(got_z, want_z, stacked=True) == _jax_paths(want_z)


@pytest.mark.parametrize("arch", LMS)
def test_port_layout_maps_every_lm_shape(arch):
    """The name map also carries JAX's shapes onto the port's."""
    cfg, jcfg = registry.get_arch(arch).config, jax_registry.get_arch(arch).config
    abs_params = jax.eval_shape(lambda: JaxLM.init(jax.random.PRNGKey(0), jcfg))
    for name, (shape, _) in _param_specs(cfg).items():
        path, layer, _ = jax_leaf(name)
        assert tuple(shape) == port_layout(_at(abs_params, path).shape, name), name
        assert (layer is not None) == name.startswith("layers.")


def test_tp_only_mixtral_train_state_is_zero1():
    """A tp_only LM's train state: moments ZeRO-1, as JAX's
    ``LMFamily.state_pspec`` makes them."""
    a = registry.get_arch("mixtral-8x7b")
    a = dataclasses.replace(a, config=dataclasses.replace(a.config, moe_weight_mode="tp_only"))
    ja = jax_registry.get_arch("mixtral-8x7b")
    ja = dataclasses.replace(ja, config=dataclasses.replace(ja.config, moe_weight_mode="tp_only"))
    port_mesh, jax_mesh = _meshes("16x16")
    got = a.family.state_pspec(a, "train_4k", port_mesh)
    want = ja.family.state_pspec(ja, "train_4k", jax_mesh)
    assert _compare(got, want, stacked=True) == _jax_paths(want)
    gate = got["opt"]["m"]["layers.0.moe.gate"]
    assert tuple(gate) == (None, ("data",), ("model",))


def test_local_shapes_and_kv_heads():
    mixtral = registry.get_arch("mixtral-8x7b").config
    mesh = make_mesh((1, 4), ("data", "model"))
    specs = sharding.lm_param_pspec(_param_specs(mixtral), mesh)
    assert sharding.local_shape((4096 * 1, 4096), specs["layers.0.wq.weight"], mesh) == (1024, 4096)
    assert sharding.local_shape((8, 4096, 14336), specs["layers.0.moe.gate"], mesh) == (8, 4096, 3584)
    assert sharding.kv_heads_of_rank(mixtral, mesh)[1] == 2
    reduced = registry.get_arch("mixtral-8x7b").reduced  # Hkv 2 < model 4
    assert sharding.kv_heads_of_rank(reduced, mesh)[1] == 1
    with pytest.raises(ValueError, match="does not divide"):
        sharding.local_shape((6,), sharding.P("model"), mesh)


def test_heads_that_do_not_divide_raise():
    qwen2 = registry.get_arch("qwen2-0.5b").config  # 14 heads
    with pytest.raises(ValueError, match=r"14 query heads do not divide the model axis of 4"):
        sharding.kv_heads_of_rank(qwen2, make_mesh((1, 4), ("data", "model")))
    from repro_torch.models import init_params

    with pytest.raises(ValueError, match="model axis"):
        init_params(qwen2, torch.Generator(), device="meta",
                    mesh=make_mesh((1, 4), ("data", "model")))
