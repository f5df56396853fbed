"""qwen3-4b [hf:Qwen/Qwen3-8B family; hf]: 36L d2560 32H (GQA kv=8)
d_ff=9728 vocab=151936, qk_norm, head_dim=128.

The port's copy of ``repro/configs/qwen3_4b.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import LMFamily
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab=151936, head_dim=128, qk_norm=True, rope_theta=1e6, remat=True,
)
REDUCED = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, qk_norm=True, compute_dtype="float32",
)
SOURCE = "hf:Qwen/Qwen3-8B; hf"


def get_def() -> ArchDef:
    return ArchDef(
        name="qwen3-4b", family=LMFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"), source=SOURCE,
    )
