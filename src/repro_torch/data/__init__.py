from repro_torch.data.pipeline import ShardedBatcher, synthetic_lm_fetch
from repro_torch.data.synth import SynthCorpus, make_corpus, make_queries

__all__ = ["SynthCorpus", "make_corpus", "make_queries", "ShardedBatcher", "synthetic_lm_fetch"]
