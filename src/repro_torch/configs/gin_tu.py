"""gin-tu [arXiv:1810.00826; paper]: GIN, 5 layers, d_hidden=64,
sum aggregator, learnable eps. Input dim / classes are per-shape
(Cora / Reddit-sampled / ogbn-products / molecule batches).

The port's copy of ``repro/configs/gin_tu.py``.
"""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.families import GNNFamily
from repro_torch.models.gnn import GINConfig

CONFIG = GINConfig(n_layers=5, d_hidden=64, learnable_eps=True)
REDUCED = GINConfig(n_layers=2, d_hidden=16, learnable_eps=True)
SOURCE = "arXiv:1810.00826; paper"


def get_def() -> ArchDef:
    return ArchDef(
        name="gin-tu", family=GNNFamily, config=CONFIG, reduced=REDUCED,
        shapes=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
        source=SOURCE,
        notes="WARP technique inapplicable (no embedding retrieval); shares "
              "segment-reduce substrate. See DESIGN §Arch-applicability.",
    )
