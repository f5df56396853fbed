"""Port parity of LM generation on the CPU: ``repro_torch.serving.generate``
against ``repro.serving.generate`` at qwen2-0.5b and qwen3-4b REDUCED
(and qwen2 with a sliding window), weights carried across with
``params_from_jax``.

Greedy tokens are equal with a float32 cache. With the default bf16
cache they are equal too, or a row first differs at a step where JAX's
own top-2 logits lie within 3e-2 (a near-tie the two packages may break
either way: JAX rounds attention probabilities to bf16, the port's flash
path does not). Sampling at a temperature is reproducible per
``torch.Generator`` seed; it is not ``jax.random``'s stream, so it is not
compared with JAX.
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
from repro.models.transformer import KVCache as JKVCache
from repro.models.transformer import TransformerLM as JLM
from repro.serving.generate import generate as jgenerate
from repro_torch.configs import qwen2_0_5b as tq2
from repro_torch.models import TransformerConfig, TransformerLM, init_params, params_from_jax
from repro_torch.serving import generate

torch.set_num_threads(1)  # xdist runs one test process per core

NEAR_TIE = 3e-2
CONFIGS = {
    "qwen2": jq2.REDUCED,
    "qwen3": jq3.REDUCED,
    "window": dataclasses.replace(jq2.REDUCED, sliding_window=16),
}


@functools.lru_cache(maxsize=None)
def _models(name):
    jcfg = CONFIGS[name]
    params = JLM.init(jax.random.PRNGKey(2), jcfg)
    cfg = TransformerConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, TransformerLM.from_params(cfg, params_from_jax(tree, cfg, device="cpu"))


def _prompt(seed, vocab, b=3, s=24):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _jax_step_logits(params, jcfg, prompt, tokens, step, cache_dtype):
    """JAX's logits at decode ``step`` of its own greedy run ``tokens``."""
    cache = JKVCache.empty(jcfg, prompt.shape[0], prompt.shape[1] + tokens.shape[1], cache_dtype)
    logits, cache = JLM.prefill(params, jcfg, jnp.asarray(prompt), cache)
    for t in range(step):
        logits, cache = JLM.decode_step(params, jcfg, jnp.asarray(tokens[:, t]), cache)
    return np.asarray(logits, np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_equal_jax_with_a_float32_cache(name):
    jcfg, params, model = _models(name)
    prompt = _prompt(40, jcfg.vocab)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=10,
                                cache_dtype=jnp.float32))
    got = generate(model, torch.from_numpy(prompt), max_new_tokens=10, cache_dtype=torch.float32)
    assert got.dtype == torch.int32 and got.shape == (3, 10)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_tokens_with_a_bf16_cache_differ_only_at_near_ties(name):
    jcfg, params, model = _models(name)
    prompt = _prompt(41, jcfg.vocab)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt), max_new_tokens=10))
    got = generate(model, prompt, max_new_tokens=10).numpy()
    for row in range(prompt.shape[0]):
        diff = np.flatnonzero(got[row] != want[row])
        if diff.size == 0:
            continue
        step = int(diff[0])
        logits = _jax_step_logits(params, jcfg, prompt, want, step, jnp.bfloat16)[row]
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] <= NEAR_TIE, (
            f"row {row} first differs at step {step}, where JAX's top-2 logits "
            f"{top2.tolist()} are not within {NEAR_TIE}"
        )
        # The port's pick there is one of JAX's two near-tied tokens.
        assert logits[got[row, step]] >= top2[0]


def test_sampling_is_reproducible_per_generator_seed():
    _, _, model = _models("qwen2")
    prompt = _prompt(42, model.cfg.vocab)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(model, prompt, max_new_tokens=12, temperature=0.8, generator=g)

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < model.cfg.vocab


def test_max_len_leaves_room_and_greedy_ignores_the_generator():
    _, _, model = _models("qwen2")
    prompt = torch.from_numpy(_prompt(43, model.cfg.vocab))
    a = generate(model, prompt, max_new_tokens=6, max_len=64)
    b = generate(model, prompt, max_new_tokens=6, generator=torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(tq2.REDUCED)
    jcfg, params, model = _models("qwen2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(jax.tree.map(np.asarray, params), model.cfg)


def test_kernel_executor_on_the_cpu_raises():
    params = init_params(tq2.REDUCED, device="cpu")
    with pytest.raises(ValueError, match="executor='kernel'"):
        TransformerLM.from_params(tq2.REDUCED, params, executor="kernel")
    assert TransformerLM.from_params(tq2.REDUCED, params).executor == "reference"


def test_init_params_has_the_jax_distributions():
    cfg = dataclasses.replace(tq2.REDUCED, d_model=64, d_ff=256, vocab=4096)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert set(params) == set(TransformerLM.from_params(cfg, params).state_dict())
    std = {k: float(v.std()) for k, v in params.items()}
    np.testing.assert_allclose(std["embed"], 1 / 8, rtol=0.02)
    np.testing.assert_allclose(std["layers.0.ffn.gate.weight"], 1 / 8, rtol=0.02)
    np.testing.assert_allclose(std["layers.0.ffn.down.weight"], 1 / 16, rtol=0.02)
    assert float(params["layers.1.wq.bias"].abs().max()) == 0.0
    assert float(params["final_norm.scale"].min()) == 1.0
