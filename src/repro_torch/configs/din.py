"""din [arXiv:1706.06978; paper]: embed_dim=18, hist seq=100,
attention MLP 80-40, MLP 200-80, target attention.

The port's copy of ``repro/configs/din.py``.
"""

from repro_torch.models.recsys import DINConfig

CONFIG = DINConfig(embed_dim=18, seq_len=100, attn_mlp=(80, 40),
                   mlp=(200, 80), item_vocab=1_000_000)
REDUCED = DINConfig(embed_dim=8, seq_len=20, attn_mlp=(16, 8),
                    mlp=(32, 16), item_vocab=2000)
SOURCE = "arXiv:1706.06978; paper"
