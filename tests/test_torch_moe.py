"""Port parity of the MoE FFN on the CPU: ``repro_torch.models.moe`` against
``repro.models.moe`` from the same weights (JAX's ``moe_init``, carried
across by ``convert.params_from_jax``'s layout: the router transposed to
[E, D], the expert stacks as they are).

At mixtral-8x7b's and dbrx-132b's REDUCED MoE configs and T in {1, 4, 37,
256}, plus a case where every token's first choice is one expert, so it
overflows its capacity. Integers exactly: top_e, the stable sort order,
counts, cap, the slot tokens and the valid mask (JAX's are taken by the
lines of ``_moe_apply_global``). Outputs and aux within 1e-5 in float32.
In bf16 the routing is still exact (the router runs in float32 on the same
bf16 inputs) and the outputs agree within 2 bf16 ulps of the largest
output: the expert products round their bf16 results once, in another
order of float32 sums.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import set_mesh
from repro.configs import dbrx_132b as jdbrx
from repro.configs import mixtral_8x7b as jmix
from repro.models.moe import moe_apply as jmoe_apply
from repro.models.moe import moe_init as jmoe_init
from repro_torch.configs import dbrx_132b, mixtral_8x7b
from repro_torch.models.moe import MoEConfig, dispatch, moe_apply, route

torch.set_num_threads(1)  # xdist runs one test process per core

F32 = dict(rtol=1e-5, atol=1e-5)
ARCHS = {"mixtral": (jmix.REDUCED, mixtral_8x7b.REDUCED), "dbrx": (jdbrx.REDUCED, dbrx_132b.REDUCED)}


def _setup(name, t, *, overflow=False, seed=0):
    jcfg, cfg = ARCHS[name]
    d, f = jcfg.d_model, jcfg.d_ff
    p = jmoe_init(jax.random.PRNGKey(seed), jcfg.moe, d, f)
    x = np.random.default_rng(seed + t).standard_normal((t, d)).astype(np.float32)
    if overflow:  # every token's first choice is expert 0
        x = np.abs(x)
        w = np.array(p["router"]["w"])
        w[:, 0] = 1.0
        p = {**p, "router": {"w": jnp.asarray(w)}}
    tp = {
        "router": torch.from_numpy(np.asarray(p["router"]["w"]).T.copy()),
        **{k: torch.from_numpy(np.array(p[k])) for k in ("gate", "up", "down")},
    }
    return jcfg.moe, cfg.moe, p, tp, x


_jmoe = jax.jit(jmoe_apply, static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _jax_routing(p, cfg, x):
    """The integer intermediates of JAX's ``_moe_apply_global``, by its lines."""
    t = x.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    router_logits = (x.astype(jnp.float32) @ p["router"]["w"]).astype(jnp.float32)
    probs = jax.nn.softmax(router_logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(-1)
    flat_tok = jnp.broadcast_to(jnp.arange(t)[:, None], (t, k)).reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    stok = flat_tok[order]
    counts = jnp.bincount(flat_e, length=e)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)])[:-1]
    pos = offsets[:, None] + jnp.arange(cap)[None, :]
    valid = jnp.arange(cap)[None, :] < counts[:, None]
    pos = jnp.minimum(pos, t * k - 1)
    return {"top_e": top_e, "order": order, "counts": counts, "tok_idx": stok[pos], "valid": valid}


CASES = [(a, t, False) for a in ARCHS for t in (1, 4, 37, 256)] + [("mixtral", 64, True)]


@pytest.mark.parametrize("name,t,overflow", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_jax(name, t, overflow, dtype):
    jcfg, cfg, p, tp, x = _setup(name, t, overflow=overflow)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = {k: np.asarray(v) for k, v in _jax_routing(p, jcfg, jx).items()}
    _, top_p, top_e = route(tx, tp["router"], cfg)
    dsp = dispatch(top_e, top_p, cfg)
    assert dsp.cap == want["tok_idx"].shape[1] == cfg.capacity(t)
    np.testing.assert_array_equal(top_e.numpy(), want["top_e"])
    np.testing.assert_array_equal(dsp.order.numpy(), want["order"])
    np.testing.assert_array_equal(dsp.counts.numpy(), want["counts"])
    np.testing.assert_array_equal(dsp.tok_idx.numpy(), want["tok_idx"])
    np.testing.assert_array_equal(dsp.valid.numpy(), want["valid"])
    if overflow:
        assert int(dsp.counts[0]) == t > dsp.cap  # expert 0 drops pairs
        assert int((dsp.slot < 0).sum()) == int((dsp.counts - dsp.cap).clamp(min=0).sum())

    jy, jaux = _jmoe(p, jcfg, jx)
    ty, taux = moe_apply(tp, cfg, tx)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    jy = np.asarray(jy, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), jy, **F32)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(jy).max())) - 7)
        np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0, atol=2 * ulp)
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


@pytest.mark.parametrize("t", [4, 37])
def test_local_dispatch_is_the_global_path_on_one_device(t):
    """``local_dispatch`` on one device: JAX's ``shard_map`` body on a 1x1
    (data, model) mesh, the port's global path and its local path agree."""
    jcfg, cfg, p, tp, x = _setup("mixtral", t)
    local = dataclasses.replace(cfg, local_dispatch=True)
    with set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        jy, jaux = _jmoe(p, dataclasses.replace(jcfg, local_dispatch=True), jnp.asarray(x))
    gy, gaux = moe_apply(tp, cfg, torch.from_numpy(x))
    ly, laux = moe_apply(tp, local, torch.from_numpy(x))
    np.testing.assert_array_equal(ly.numpy(), gy.numpy())
    np.testing.assert_allclose(float(laux), float(gaux), rtol=1e-6)
    np.testing.assert_allclose(ly.numpy(), np.asarray(jy), **F32)
    np.testing.assert_allclose(float(laux), float(jaux), **F32)


def test_config_keeps_jax_fields_and_capacity_rule():
    from repro.models.moe import MoEConfig as JMoEConfig

    assert [f.name for f in dataclasses.fields(MoEConfig)] == [
        f.name for f in dataclasses.fields(JMoEConfig)
    ]
    assert dataclasses.asdict(MoEConfig(8, 2)) == dataclasses.asdict(JMoEConfig(8, 2))
    # decode at B 4 in mixtral: cap 1, most pairs dropped
    assert MoEConfig(8, 2).capacity(4) == 1 and MoEConfig(16, 4).capacity(16384) == 5120
