"""Models of the PyTorch port: the decoder-only LM (dense and MoE), the
XTR token encoder and the four recsys models (two-tower retrieval,
SASRec, xDeepFM, DIN)."""

from repro_torch.models.convert import init_params, params_from_jax
from repro_torch.models.encoder import EncoderConfig, TokenEncoder
from repro_torch.models.moe import MoEConfig, moe_apply
from repro_torch.models.recsys import (
    DIN,
    SASRec,
    TwoTower,
    XDeepFM,
    DINConfig,
    SASRecConfig,
    TwoTowerConfig,
    XDeepFMConfig,
    serve_step,
)
from repro_torch.models.transformer import KVCache, TransformerConfig, TransformerLM

__all__ = [
    "KVCache", "TransformerConfig", "TransformerLM", "init_params", "params_from_jax",
    "TwoTower", "TwoTowerConfig", "SASRec", "SASRecConfig", "XDeepFM", "XDeepFMConfig",
    "DIN", "DINConfig", "serve_step", "EncoderConfig", "TokenEncoder", "MoEConfig", "moe_apply",
]
