"""dbrx-132b [hf:databricks/dbrx-base; unverified]: 40L d6144 48H (GQA kv=8)
d_ff=10752 vocab=100352, MoE 16 experts top-4 (fine-grained).

The port's copy of ``repro/configs/dbrx_132b.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import LMFamily
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, head_dim=128, moe=MoEConfig(n_experts=16, top_k=4),
    remat=True,
)
REDUCED = TransformerConfig(
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, moe=MoEConfig(n_experts=4, top_k=2), compute_dtype="float32",
)
SOURCE = "hf:databricks/dbrx-base; unverified"


def get_def() -> ArchDef:
    return ArchDef(
        name="dbrx-132b", family=LMFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        source=SOURCE, train_microbatches=4,
        notes="Largest assigned arch; train_4k uses 4 microbatches (DESIGN §5).",
    )
