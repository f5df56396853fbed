"""sasrec [arXiv:1808.09781; paper]: embed_dim=50, 2 blocks, 1 head,
seq_len=50, self-attentive sequential recommendation.

The port's copy of ``repro/configs/sasrec.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import RecsysFamily
from repro_torch.models.recsys import SASRecConfig

CONFIG = SASRecConfig(embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
                      item_vocab=500_000)
REDUCED = SASRecConfig(embed_dim=16, n_blocks=2, n_heads=1, seq_len=16,
                       item_vocab=1000)
SOURCE = "arXiv:1808.09781; paper"


def get_def() -> ArchDef:
    return ArchDef(
        name="sasrec", family=RecsysFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"), source=SOURCE,
    )
