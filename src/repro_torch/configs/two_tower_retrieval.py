"""two-tower-retrieval [RecSys'19 (YouTube); unverified]: embed_dim=256,
tower MLP 1024-512-256, dot interaction, sampled softmax w/ logQ.

The port's copy of ``repro/configs/two_tower_retrieval.py``: ``CONFIG`` is
the full model (user table 5M x 256, item table 2M x 256), ``REDUCED`` the
small one the tests hold against the JAX package. ``retrieval_cand`` is the
WARP integration point.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import RecsysFamily
from repro_torch.models.recsys import TwoTowerConfig

CONFIG = TwoTowerConfig(
    embed_dim=256, tower_mlp=(1024, 512, 256),
    user_vocab=5_000_000, item_vocab=2_000_000,
)
REDUCED = TwoTowerConfig(
    embed_dim=32, tower_mlp=(64, 32), user_vocab=1000, item_vocab=1000,
)
SOURCE = "RecSys'19 (YouTube); unverified"


def get_def() -> ArchDef:
    return ArchDef(
        name="two-tower-retrieval", family=RecsysFamily, config=CONFIG, reduced=REDUCED,
        shapes=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"), source=SOURCE,
        notes="retrieval_cand is the WARP integration point "
              "(examples/serve_retrieval.py serves it through a WARP index).",
    )
