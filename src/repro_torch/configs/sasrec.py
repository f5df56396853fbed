"""sasrec [arXiv:1808.09781; paper]: embed_dim=50, 2 blocks, 1 head,
seq_len=50, self-attentive sequential recommendation.

The port's copy of ``repro/configs/sasrec.py``.
"""

from repro_torch.models.recsys import SASRecConfig

CONFIG = SASRecConfig(embed_dim=50, n_blocks=2, n_heads=1, seq_len=50,
                      item_vocab=500_000)
REDUCED = SASRecConfig(embed_dim=16, n_blocks=2, n_heads=1, seq_len=16,
                       item_vocab=1000)
SOURCE = "arXiv:1808.09781; paper"
