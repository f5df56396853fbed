from repro_torch.data.synth import SynthCorpus, make_corpus, make_queries

__all__ = ["SynthCorpus", "make_corpus", "make_queries"]
