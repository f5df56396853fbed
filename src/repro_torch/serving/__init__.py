"""Serving layer of the PyTorch port: the one-tenant retrieval server and
LM generation."""

from repro_torch.serving.batcher import PENDING, ResultAlreadyTaken, RetrievalServer
from repro_torch.serving.generate import generate
from repro_torch.serving.scheduler import BatchPolicy, BucketScheduler

__all__ = [
    "PENDING",
    "BatchPolicy",
    "BucketScheduler",
    "ResultAlreadyTaken",
    "RetrievalServer",
    "generate",
]
