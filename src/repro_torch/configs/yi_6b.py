"""yi-6b [arXiv:2403.04652; hf]: llama-arch GQA, 32L d4096 32H (kv=4)
d_ff=11008 vocab=64000.

The port's copy of ``repro/configs/yi_6b.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import LMFamily
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, d_ff=11008,
    vocab=64000, head_dim=128, rope_theta=5e6, remat=True,
)
REDUCED = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, compute_dtype="float32",
)
SOURCE = "arXiv:2403.04652; hf"


def get_def() -> ArchDef:
    return ArchDef(
        name="yi-6b", family=LMFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"), source=SOURCE,
    )
