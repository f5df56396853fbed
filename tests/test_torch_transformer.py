"""Port parity of the LM on the CPU: ``repro_torch.models`` against
``repro.models`` at qwen2-0.5b REDUCED (QKV bias, tied embeddings, GQA
7:1) and qwen3-4b REDUCED (qk-norm, untied head), with the JAX weights
carried across by ``params_from_jax``.

Layers one by one, then ``forward``, ``prefill`` and ``decode_step``
logits. Tolerances: 1e-4 with a float32 cache (float32 sums in another
order); 3e-2 abs on logits with the default bf16 cache, where JAX rounds
the attention probabilities to bf16 before the product with v and the
port's flash path does not (the bf16-vs-float32-cache gap of JAX alone is
about 0.025 on logits of magnitude ~4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_0_5b as jq2
from repro.configs import qwen3_4b as jq3
from repro.models import layers as JL
from repro.models.moe import MoEConfig
from repro.models.transformer import KVCache as JKVCache
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import qwen2_0_5b as tq2
from repro_torch.models import KVCache, TransformerConfig, TransformerLM, params_from_jax
from repro_torch.models import layers as TL

torch.set_num_threads(1)  # xdist runs one test process per core

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_LOGITS_ATOL = 3e-2


def _port_cfg(jcfg, **over):
    return TransformerConfig(**{**dataclasses.asdict(jcfg), **over})


CONFIGS = {
    "qwen2": jq2.REDUCED,
    "qwen3": jq3.REDUCED,
    "window": dataclasses.replace(jq2.REDUCED, sliding_window=16),
}


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg = CONFIGS[name]
    params = JLM.init(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, params)
    cfg = _port_cfg(jcfg)
    model = TransformerLM.from_params(cfg, params_from_jax(tree, cfg, device="cpu"))
    return jcfg, params, model


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jprefill(params, cfg, tokens, cache):
    return JLM.prefill(params, cfg, tokens, cache)


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jdecode(params, cfg, tokens, cache):
    return JLM.decode_step(params, cfg, tokens, cache)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_port_config_equals_jax_config_field_by_field(which):
    assert dataclasses.asdict(getattr(tq2, which)) == dataclasses.asdict(getattr(jq2, which))
    assert getattr(tq2, which).param_count() == getattr(jq2, which).param_count()


def test_moe_config_raises_a_directed_error():
    cfg = _port_cfg(jq2.REDUCED, moe=MoEConfig(n_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="MoE not yet ported"):
        TransformerLM(cfg)


# ---------------------------------------------------------------------------
# layers one by one
# ---------------------------------------------------------------------------


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rms_norm_rope_dense_swiglu_match_jax():
    x, scale = _rand(0, 2, 5, 16), _rand(1, 16)
    np.testing.assert_allclose(
        _np(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL,
    )
    xr, pos = _rand(2, 2, 5, 3, 8), np.arange(10).reshape(2, 5) * 7
    jf, tf = JL.rope_frequencies(8, 1e6), TL.rope_frequencies(8, 1e6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(
        _np(TL.apply_rope(torch.from_numpy(xr), torch.from_numpy(pos), tf)),
        np.asarray(JL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), jf)), **TOL,
    )
    w, b = _rand(3, 16, 12), _rand(4, 12)
    np.testing.assert_allclose(
        _np(TL.dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(b))),
        np.asarray(JL.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))), **TOL,
    )
    g, u, d = _rand(5, 16, 24), _rand(6, 16, 24), _rand(7, 24, 16)
    jp = {n: {"w": jnp.asarray(a)} for n, a in (("gate", g), ("up", u), ("down", d))}
    tw = [(torch.from_numpy(a.T.copy()), None) for a in (g, u, d)]
    np.testing.assert_allclose(
        _np(TL.swiglu(torch.from_numpy(x), *tw)),
        np.asarray(JL.swiglu(jp, jnp.asarray(x))), **TOL,
    )


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None)])
def test_chunked_and_gqa_attention_match_jax(causal, window):
    q, k, v = _rand(10, 2, 12, 6, 8), _rand(11, 2, 12, 2, 8), _rand(12, 2, 12, 2, 8)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(
        _np(TL.gqa_attention(tq, tk, tv, causal=causal, window=window, chunk_size=5)),
        np.asarray(JL.gqa_attention(jq, jk, jv, causal=causal, window=window, chunk_size=5)),
        **TOL,
    )
    qpos = np.array([[3, 4, 5] * 4, [9, 10, 11] * 4])
    kpos = np.where(np.arange(12) < 10, np.arange(12), -(10**9))[None].repeat(2, 0)
    kw = dict(causal=causal, window=window, chunk_size=4)
    np.testing.assert_allclose(
        _np(TL.chunked_attention(
            tq, tk, tv, q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos), **kw
        )),
        np.asarray(JL.chunked_attention(
            jq, jk, jv, q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos), **kw
        )),
        **TOL,
    )


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_matches_jax(cache_dtype, window):
    q, k, v = _rand(20, 3, 1, 6, 8), _rand(21, 3, 16, 2, 8), _rand(22, 3, 16, 2, 8)
    kv_len = np.array([1, 9, 16], np.int32)
    jd = getattr(jnp, cache_dtype)
    want = JL.decode_attention(
        jnp.asarray(q), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(kv_len), window=window
    )
    td = getattr(torch, cache_dtype)
    got = TL.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).to(td), torch.from_numpy(v).to(td),
        torch.from_numpy(kv_len), window=window,
    )
    assert got.dtype == td  # the product with v runs in the cache dtype, as in JAX
    tol = TOL if cache_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_logits_match_jax(name):
    jcfg, params, model = _models(name)
    toks = _tokens(30, 2, 24, jcfg.vocab)
    jh, _ = JLM.forward(params, jcfg, jnp.asarray(toks))
    want = JLM.logits(params, jcfg, jh)
    hidden, aux = model(torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(hidden), np.asarray(jh), **TOL)
    np.testing.assert_allclose(_np(model.logits(hidden)), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def _prefill_both(name, cache_dtype, toks, max_len):
    jcfg, params, model = _models(name)
    jcache = JKVCache.empty(jcfg, toks.shape[0], max_len, getattr(jnp, cache_dtype))
    jl, jcache = _jprefill(params, jcfg, jnp.asarray(toks), jcache)
    cache = KVCache.empty(model.cfg, toks.shape[0], max_len, getattr(torch, cache_dtype), "cpu")
    tl, cache = model.prefill(torch.from_numpy(toks).long(), cache)
    return (jl, jcache), (tl, cache)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_jax(name, cache_dtype):
    jcfg, params, model = _models(name)
    toks = _tokens(31, 2, 40, jcfg.vocab)
    (jl, jcache), (tl, cache) = _prefill_both(name, cache_dtype, toks, 48)
    if cache_dtype == "float32":
        tol = TOL
    else:
        tol = dict(rtol=0, atol=BF16_LOGITS_ATOL)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))
    cache_tol = TOL if cache_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(cache.k), np.asarray(jcache.k, np.float32), **cache_tol)
    nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    for _ in range(3):
        jl, jcache = _jdecode(params, jcfg, jnp.asarray(nxt), jcache)
        tl, cache = model.decode_step(torch.tensor(nxt).long(), cache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **tol)
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)
    np.testing.assert_array_equal(cache.length.numpy(), np.asarray(jcache.length))


@pytest.mark.parametrize("name", ["qwen2", "window"])
def test_prefill_onto_a_nonempty_cache_matches_jax(name):
    """Chunked prefill at an offset: the second chunk attends to the cache
    through the port's plain chunked attention."""
    jcfg, params, model = _models(name)
    toks = _tokens(32, 2, 40, jcfg.vocab)
    (jl, jcache), (tl, cache) = _prefill_both(name, "float32", toks[:, :24], 48)
    jl, jcache = _jprefill(params, jcfg, jnp.asarray(toks[:, 24:]), jcache)
    tl, cache = model.prefill(torch.from_numpy(toks[:, 24:]).long(), cache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **TOL)
    np.testing.assert_allclose(_np(cache.v), np.asarray(jcache.v), **TOL)
    assert cache.length.tolist() == [40, 40]
    # The same prompt in one prefill gives the same last logits.
    (jl1, _), (tl1, _) = _prefill_both(name, "float32", toks, 48)
    np.testing.assert_allclose(_np(tl1), _np(tl), **TOL)


def test_executor_resolves_by_device_and_kernel_refuses_the_cpu():
    _, _, model = _models("qwen2")
    assert model.executor == "reference"
    params = model.state_dict()
    with pytest.raises(ValueError, match="executor='kernel'"):
        TransformerLM.from_params(model.cfg, params, executor="kernel")
    with pytest.raises(ValueError, match="not in"):
        TransformerLM.from_params(model.cfg, params, executor="fast")
