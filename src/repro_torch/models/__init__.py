"""Models of the PyTorch port: the dense decoder-only LM."""

from repro_torch.models.convert import init_params, params_from_jax
from repro_torch.models.transformer import KVCache, TransformerConfig, TransformerLM

__all__ = ["KVCache", "TransformerConfig", "TransformerLM", "init_params", "params_from_jax"]
