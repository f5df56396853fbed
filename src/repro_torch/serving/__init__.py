"""Serving layer of the PyTorch port (one tenant)."""

from repro_torch.serving.batcher import PENDING, ResultAlreadyTaken, RetrievalServer
from repro_torch.serving.scheduler import BatchPolicy, BucketScheduler

__all__ = [
    "PENDING",
    "BatchPolicy",
    "BucketScheduler",
    "ResultAlreadyTaken",
    "RetrievalServer",
]
