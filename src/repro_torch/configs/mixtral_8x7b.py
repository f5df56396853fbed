"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention (4096).

The port's copy of ``repro/configs/mixtral_8x7b.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import LMFamily
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2), remat=True,
)
REDUCED = TransformerConfig(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, sliding_window=32, moe=MoEConfig(n_experts=4, top_k=2),
    compute_dtype="float32",
)
SOURCE = "arXiv:2401.04088; hf"


def get_def() -> ArchDef:
    return ArchDef(
        name="mixtral-8x7b", family=LMFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source=SOURCE, train_microbatches=2,
        notes="MoE top-2; SWA bounds the effective KV window at 4096.",
    )
