"""Recsys serving and training shapes: the port's copy of
``RecsysShape``, ``RECSYS_SHAPES`` and ``RECSYS_SHAPES_REDUCED`` from
``repro/configs/families.py``. ``batch`` is users (or rows) per step;
``retrieval`` scores one user against ``n_candidates``."""

from __future__ import annotations

import dataclasses

__all__ = ["RecsysShape", "RECSYS_SHAPES", "RECSYS_SHAPES_REDUCED"]


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    kind: str
    batch: int
    n_candidates: int | None = None


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train", 65536),
    "serve_p99": RecsysShape("serve", 512),
    "serve_bulk": RecsysShape("serve", 262144),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=1_000_000),
}

RECSYS_SHAPES_REDUCED = {
    "train_batch": RecsysShape("train", 64),
    "serve_p99": RecsysShape("serve", 16),
    "serve_bulk": RecsysShape("serve", 128),
    "retrieval_cand": RecsysShape("retrieval", 1, n_candidates=512),
}
