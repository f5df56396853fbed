"""The port's XTR token encoder against the JAX package's (CPU).

JAX ``TokenEncoder.encode`` and the port's ``TokenEncoder`` on the same
numpy-seeded token ids and masks (ragged lengths, one all-padding row),
with the JAX weights carried across by ``params_from_jax``: at a narrow
width (2 layers, d 64, 4 heads) and at full width with 2 layers. float32
within 1e-5 absolute (JAX's matmuls at "highest" precision; the sums run
in another order). bfloat16 within 2^-6 absolute: activations round to
bf16 at every layer in both packages, and the outputs (~0.09 per element,
unit rows of 128) then differ by a few bf16 ulps (about 4e-3 measured).
Padding rows are exactly 0 and valid rows have unit norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.encoder import EncoderConfig as JaxEncoderConfig
from repro.models.encoder import TokenEncoder as JaxEncoder
from repro_torch.models import EncoderConfig, TokenEncoder, init_params, params_from_jax

torch.set_num_threads(1)  # xdist runs one test process per core

WIDTHS = {
    "narrow": dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=500),
    "full_2_layers": dict(n_layers=2),
}
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
LENGTHS = (32, 17, 9, 1, 0, 24)  # ragged, one all-padding row


def _batch(vocab: int, seed: int = 0, s: int = 32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (len(LENGTHS), s)).astype(np.int32)
    mask = np.arange(s)[None] < np.asarray(LENGTHS)[:, None]
    return tokens, mask


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def weights(request):
    jcfg = JaxEncoderConfig(**WIDTHS[request.param])
    params = JaxEncoder.init(jax.random.PRNGKey(1), jcfg)
    return request.param, params, jax.tree.map(np.asarray, params)


def test_encoder_config_matches_jax():
    assert dataclasses.asdict(EncoderConfig()) == dataclasses.asdict(JaxEncoderConfig())
    assert EncoderConfig().query_maxlen == 32 and EncoderConfig().out_dim == 128


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_encode_matches_jax(weights, dtype):
    name, params, tree = weights
    jcfg = JaxEncoderConfig(**WIDTHS[name], compute_dtype=dtype)
    cfg = EncoderConfig(**WIDTHS[name], compute_dtype=dtype)
    tokens, mask = _batch(cfg.vocab)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxEncoder.encode(params, jcfg, jnp.asarray(tokens), jnp.asarray(mask)))
    model = TokenEncoder.from_params(cfg, params_from_jax(tree, cfg, device="cpu"))
    got = model.encode(torch.from_numpy(tokens), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (len(LENGTHS), 32, cfg.out_dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL[dtype])
    out = got.numpy()
    assert (out[~mask] == 0).all() and (want[~mask] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(out[mask], axis=-1), 1.0, atol=1e-5)


def test_state_dict_names_and_shapes(weights):
    name, _, tree = weights
    cfg = EncoderConfig(**WIDTHS[name])
    carried = params_from_jax(tree, cfg, device="cpu")
    drawn = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert carried.keys() == drawn.keys()
    assert all(carried[k].shape == drawn[k].shape for k in carried)
    model = TokenEncoder.from_params(cfg, drawn)
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert model.layers[1].wq.weight.data_ptr() == drawn["layers.1.wq.weight"].data_ptr()


def test_init_params_draws_jax_distributions_from_the_generator():
    cfg = EncoderConfig(**WIDTHS["narrow"])
    a = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert abs(float(a["embed"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(a["layers.0.ffn.down.weight"].std()) * cfg.d_ff ** 0.5 - 1.0) < 0.1
    assert (a["layers.0.attn_norm.scale"] == 1).all()
    tokens, mask = _batch(cfg.vocab, seed=5)
    out = TokenEncoder.from_params(cfg, a).encode(tokens, mask)  # numpy in
    np.testing.assert_allclose(out[torch.from_numpy(mask)].norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_encoder_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(EncoderConfig(**WIDTHS["narrow"]))
