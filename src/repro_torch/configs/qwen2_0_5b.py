"""qwen2-0.5b [arXiv:2407.10671; hf]: 24L d896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings.

The port's copy of ``repro/configs/qwen2_0_5b.py``: ``CONFIG`` is the full
model, ``REDUCED`` the small one the tests hold against the JAX package.
"""

from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, head_dim=64, qkv_bias=True, tie_embeddings=True,
    rope_theta=1e6, remat=True,
)
REDUCED = TransformerConfig(
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, d_ff=128, vocab=256,
    head_dim=8, qkv_bias=True, tie_embeddings=True, compute_dtype="float32",
)
SOURCE = "arXiv:2407.10671; hf"
