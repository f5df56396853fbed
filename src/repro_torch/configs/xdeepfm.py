"""xdeepfm [arXiv:1803.05170; paper]: 39 sparse fields, embed_dim=10,
CIN 200-200-200, DNN 400-400.

The port's copy of ``repro/configs/xdeepfm.py``.
"""

from repro_torch.models.recsys import XDeepFMConfig

CONFIG = XDeepFMConfig(n_fields=39, embed_dim=10, cin_layers=(200, 200, 200),
                       mlp=(400, 400), vocab=10_000_000)
REDUCED = XDeepFMConfig(n_fields=10, embed_dim=8, cin_layers=(16, 16),
                        mlp=(32, 32), vocab=2000)
SOURCE = "arXiv:1803.05170; paper"
