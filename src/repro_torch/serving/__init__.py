"""Serving layer of the PyTorch port: the retrieval server (tenants,
caches, admission, deadlines, reload, maintenance) and LM generation.
Exports mirror ``repro/serving/__init__.py``."""

from repro_torch.serving.admission import (
    AdmissionGate,
    AdmissionPolicy,
    CompactionPolicy,
    DeadlineExceeded,
    Overloaded,
)
from repro_torch.serving.batcher import (
    PENDING,
    BatchPolicy,
    ResultAlreadyTaken,
    RetrievalServer,
    follow,
)
from repro_torch.serving.cache import LRUCache, query_key
from repro_torch.serving.generate import generate
from repro_torch.serving.scheduler import BucketScheduler

__all__ = [
    "AdmissionGate",
    "AdmissionPolicy",
    "BatchPolicy",
    "BucketScheduler",
    "CompactionPolicy",
    "DeadlineExceeded",
    "LRUCache",
    "Overloaded",
    "PENDING",
    "ResultAlreadyTaken",
    "RetrievalServer",
    "follow",
    "generate",
    "query_key",
]
