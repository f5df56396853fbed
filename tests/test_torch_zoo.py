"""Port parity of the rest of the LM zoo on the CPU: qwen3-4b, yi-6b,
mixtral-8x7b (MoE, sliding window) and dbrx-132b (MoE) at their REDUCED
configs, ``repro_torch`` against ``repro`` with the JAX weights carried
across by ``params_from_jax``; and the arch registry against JAX's.

Configs, ``param_count`` and ``active_param_count`` equal; forward hidden,
logits and the MoE aux loss within 1e-4 (float32 sums in another order);
prefill and three decode steps with a float32 cache within 1e-4, and with
the default bf16 cache within 3e-2 abs on logits and on the cache (JAX
rounds the attention probabilities to bf16 before the product with v and
the port's flash path does not, as ``test_torch_transformer.py`` states;
behind a MoE layer such a difference reaches the next layer's k/v as one
or two bf16 ulps of values up to ~4, 2^-6 each); mixtral with prompts
of 40 and 72 tokens past its reduced window of 32; greedy tokens equal to
JAX's ``generate`` with a float32 cache; ``LMFamily.step_fn`` for prefill
and decode against JAX's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.families import LMFamily as JLMFamily
from repro.models.transformer import KVCache as JKVCache
from repro.models.transformer import TransformerLM as JLM
from repro.serving.generate import generate as jgenerate
from repro_torch.configs import dbrx_132b, mixtral_8x7b, qwen3_4b, registry, yi_6b
from repro_torch.configs.families import LMFamily
from repro_torch.models import KVCache, TransformerLM, params_from_jax
from repro_torch.serving import generate

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS_ATOL = 3e-2
MODULES = {"qwen3-4b": qwen3_4b, "yi-6b": yi_6b, "mixtral-8x7b": mixtral_8x7b, "dbrx-132b": dbrx_132b}
NAMES = list(MODULES)


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg, cfg = jreg.get_arch(name).reduced, MODULES[name].REDUCED
    params = JLM.init(jax.random.PRNGKey(3), jcfg)
    model = TransformerLM.from_params(
        cfg, params_from_jax(jax.tree.map(np.asarray, params), cfg, device="cpu")
    )
    return jcfg, params, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jforward(params, cfg, tokens):
    hidden, aux = JLM.forward(params, cfg, tokens)
    return hidden, aux, JLM.logits(params, cfg, hidden)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jprefill(params, cfg, tokens, cache):
    return JLM.prefill(params, cfg, tokens, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jdecode(params, cfg, tokens, cache):
    return JLM.decode_step(params, cfg, tokens, cache)


def _np(t):
    return t.detach().float().numpy().copy()  # the port's cache is updated in place


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax_field_by_field(name, which):
    jdef = jreg.get_arch(name)
    cfg = getattr(MODULES[name], which)
    jcfg = jdef.config if which == "CONFIG" else jdef.reduced
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


def test_registry_matches_jax_for_every_ported_arch():
    """Every arch of the JAX registry is ported, gin-tu included, in JAX's
    order, with its cells."""
    assert list(registry.ARCHS) == list(jreg.ARCHS)
    assert registry.ASSIGNED == jreg.ASSIGNED
    for name, a in registry.ARCHS.items():
        j = jreg.get_arch(name)
        assert (a.name, a.shapes, a.source, a.train_microbatches, a.notes) == (
            j.name, j.shapes, j.source, j.train_microbatches, j.notes
        ), name
        assert dataclasses.asdict(a.config) == dataclasses.asdict(j.config), name
        assert dataclasses.asdict(a.reduced) == dataclasses.asdict(j.reduced), name
        assert a.family.name == j.family.name
        for shape in a.shapes:
            assert dataclasses.asdict(a.cell(shape)) == dataclasses.asdict(j.cell(shape)), name
    assert registry.all_cells() == jreg.all_cells()
    assert registry.all_cells(include_warp=False) == jreg.all_cells(include_warp=False)
    assert registry.list_archs() == jreg.list_archs() == sorted(registry.ARCHS)
    assert registry.get_arch("gin-tu").family.name == "gnn"
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_and_aux_match_jax(name):
    jcfg, params, model = _models(name)
    toks = _tokens(30, 2, 40, jcfg.vocab)
    jh, jaux, want = _jforward(params, jcfg, jnp.asarray(toks))
    with torch.no_grad():  # the serving route (flash's plain version)
        hidden, aux = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(hidden), np.asarray(jh), **TOL)
    np.testing.assert_allclose(_np(model.logits(hidden)), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    if jcfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0
    hidden_t, aux_t = model(torch.from_numpy(toks).long())  # grad enabled: the training route
    np.testing.assert_allclose(_np(hidden_t), np.asarray(jh), **TOL)
    np.testing.assert_allclose(float(aux_t), float(jaux), **TOL)


def _prefill_decode(name, cache_dtype, toks, max_len, steps=3):
    jcfg, params, model = _models(name)
    b = toks.shape[0]
    jcache = JKVCache.empty(jcfg, b, max_len, getattr(jnp, cache_dtype))
    jl, jcache = _jprefill(params, jcfg, jnp.asarray(toks), jcache)
    cache = KVCache.empty(model.cfg, b, max_len, getattr(torch, cache_dtype), "cpu")
    tl, cache = model.prefill(torch.from_numpy(toks).long(), cache)
    out = [(np.asarray(jl), _np(tl))]
    caches = [(np.asarray(jcache.k, np.float32), _np(cache.k))]
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(steps):
        jl, jcache = _jdecode(params, jcfg, jnp.asarray(nxt), jcache)
        tl, cache = model.decode_step(torch.tensor(nxt).long(), cache)
        out.append((np.asarray(jl), _np(tl)))
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    caches.append((np.asarray(jcache.v, np.float32), _np(cache.v)))
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))
    return out, caches


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_jax(name, cache_dtype):
    toks = _tokens(31, 2, 40, 256)  # past mixtral's reduced window of 32
    out, caches = _prefill_decode(name, cache_dtype, toks, 48)
    f32 = cache_dtype == "float32"
    for want, got in out:
        np.testing.assert_allclose(got, want, **(TOL if f32 else dict(rtol=0, atol=BF16_LOGITS_ATOL)))
    for want, got in caches:
        np.testing.assert_allclose(got, want, **(TOL if f32 else dict(rtol=0, atol=BF16_LOGITS_ATOL)))


def test_mixtral_window_binds_in_prefill_and_decode():
    """A 72-token prompt, twice the reduced window: the window hides keys in
    prefill and in decode (the windowed logits differ from unwindowed ones),
    and the port follows JAX."""
    toks = _tokens(33, 2, 72, 256)
    out, _ = _prefill_decode("mixtral-8x7b", "float32", toks, 80, steps=4)
    for want, got in out:
        np.testing.assert_allclose(got, want, **TOL)
    jcfg, params, _ = _models("mixtral-8x7b")
    wide = dataclasses.replace(jcfg, sliding_window=None)
    jl, _ = _jprefill(params, wide, jnp.asarray(toks), JKVCache.empty(wide, 2, 80, jnp.float32))
    assert np.abs(np.asarray(jl) - out[0][0]).max() > 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_equal_jax_with_a_float32_cache(name):
    jcfg, params, model = _models(name)
    prompt = _tokens(40, 3, 36, jcfg.vocab)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=8,
                                cache_dtype=jnp.float32))
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=8, cache_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", ["qwen3-4b", "mixtral-8x7b"])
def test_family_step_fn_matches_jax(name, shape):
    jdef, tdef = jreg.get_arch(name), registry.get_arch(name)
    jcfg, params, model = _models(name)
    specs = LMFamily.input_specs(tdef, shape, reduced=True)
    jspecs = JLMFamily.input_specs(jdef, shape, reduced=True)
    assert specs["tokens"][0] == jspecs["tokens"].shape
    assert specs["cache"]["k"][0] == jspecs["cache"].k.shape
    b, s = 2, 16
    toks = _tokens(50, b, s, jcfg.vocab)
    jcache = JKVCache.empty(jcfg, b, 32, jnp.float32)
    cache = KVCache.empty(model.cfg, b, 32, torch.float32, "cpu")
    jstep = JLMFamily.step_fn(jdef, shape, reduced=True)
    step = LMFamily.step_fn(tdef, shape, reduced=True)
    if shape == "decode_32k":
        jl, jcache = _jprefill(params, jcfg, jnp.asarray(toks), jcache)
        _, cache = model.prefill(torch.from_numpy(toks).long(), cache)
        toks = np.asarray(jnp.argmax(jl, -1), np.int32)
    jl, jcache = jstep(params, {"tokens": jnp.asarray(toks), "cache": jcache})
    tl, cache = step(model, {"tokens": torch.from_numpy(toks).long(), "cache": cache})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(cache.k), np.asarray(jcache.k), **TOL)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_family_smoke_runs_the_reduced_config(shape):
    out = LMFamily.smoke(registry.get_arch("mixtral-8x7b"), shape, 0, device="cpu")
    (v,) = out.values()
    assert bool(torch.isfinite(v).all())
