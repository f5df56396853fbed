"""The tile autotune table of the fused gather–score kernels. Counterpart
of ``repro/kernels/autotune.py``.

``ops.resolve_tile_c`` picks the candidate tile analytically
(``min(layout default, next_pow2(cap))``). This module makes the winning
tile a measured, stored fact instead:

  - ``kernels/autotune_sweep.py`` times the ragged kernel at each tile
    (and the dense kernel once) through their ``probe`` carve-outs
    ("full" / "dma" / "compute", ``kernels/fused_gather_score.py``) on the
    card, splitting the staging of code rows from their scoring.
  - The winner per (index geometry bucket, layout) lands in an
    ``AutotuneTable``: a versioned JSON document in the JAX package's
    form (sorted keys, indent 2, a trailing newline), so a table both
    packages record is byte for byte the same file. Its default path is
    ``build/autotune_cuda.json`` in the repository, beside the kernels
    built for the card (override with ``REPRO_AUTOTUNE_TABLE``, the
    variable the JAX package reads); the port never reads or writes the
    JAX package's ``BENCH_autotune.json``.
  - Plan resolution (``core/engine.py``, ``core/retriever.py``,
    ``core/distributed.py``) consults the table through
    ``ops.resolve_tile_choice``: an explicit ``tile_c`` wins, then a
    matching entry, then the heuristic; ``SearchPlan.describe()`` says
    which (``tile_source``).

Geometry keys bucket ``cap`` and ``n_tokens`` to the next power of two;
``nbits`` / ``dim`` / ``layout`` are exact.

Backend matching: an entry applies only where ``measured_on`` equals the
kind of the planned index's device (``backend_kind``: "cuda" or "cpu").
Entries measured by the JAX package ("tpu", "interpret") load but never
apply to a plan of the port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import torch

from repro_torch.kernels.fused_gather_score import BUFFERINGS, validate_tile_c

__all__ = [
    "AUTOTUNE_TABLE_VERSION",
    "MEASURED_ON",
    "TunedTile",
    "AutotuneTable",
    "backend_kind",
    "geometry_key",
    "overlap_frac",
    "default_table_path",
    "get_default_table",
    "set_default_table",
]

AUTOTUNE_TABLE_VERSION = 1

TABLE_PATH_ENV = "REPRO_AUTOTUNE_TABLE"
DEFAULT_TABLE_PATH = Path(__file__).resolve().parents[3] / "build" / "autotune_cuda.json"

LAYOUTS = ("dense", "ragged")
# Where an entry may have been measured: the port's two device kinds and
# the JAX package's two (so a JAX table loads).
MEASURED_ON = ("cuda", "cpu", "tpu", "interpret")


def backend_kind(device) -> str:
    """The measurement domain of an index on ``device``: "cuda" for a
    CUDA device, "cpu" otherwise (None included)."""
    return "cuda" if device is not None and torch.device(device).type == "cuda" else "cpu"


def _pow2_bucket(x: int) -> int:
    """Next power of two >= x (>= 1)."""
    return 1 << max(0, int(x - 1).bit_length()) if x > 1 else 1


def geometry_key(layout: str, *, nbits: int, dim: int, cap: int, n_tokens: int) -> str:
    """Stable table key for one (index geometry bucket, layout)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r} not in {LAYOUTS}")
    return (
        f"layout={layout}|nbits={int(nbits)}|dim={int(dim)}"
        f"|cap_bucket={_pow2_bucket(int(cap))}"
        f"|ntok_bucket={_pow2_bucket(int(n_tokens))}"
    )


def overlap_frac(total: float, dma: float, compute: float) -> float:
    """Achieved staging/scoring overlap from the three probe times: 0 =
    serialized (total = dma + compute), 1 = perfect (total = max of the
    two), clamped to [0, 1]; 0 where either probe time is not positive."""
    denom = min(dma, compute)
    if denom <= 0.0:
        return 0.0
    return max(0.0, min(1.0, (dma + compute - total) / denom))


@dataclasses.dataclass(frozen=True)
class TunedTile:
    """One sweep winner and the measurements behind it. The field names
    are the JAX package's (``dma_us`` is the staging probe's time on the
    card)."""

    tile_c: int
    buffering: str  # "double" | "single"
    dma_us: float
    compute_us: float
    total_us: float
    measured_on: str  # one of MEASURED_ON

    def __post_init__(self):
        validate_tile_c(self.tile_c, where="TunedTile.tile_c")
        if self.buffering not in BUFFERINGS:
            raise ValueError(f"TunedTile.buffering={self.buffering!r} not in {BUFFERINGS}")
        if self.measured_on not in MEASURED_ON:
            raise ValueError(
                f"TunedTile.measured_on={self.measured_on!r} must be one of {MEASURED_ON}"
            )

    @property
    def overlap_frac(self) -> float:
        """``overlap_frac`` of this entry's times."""
        return overlap_frac(self.total_us, self.dma_us, self.compute_us)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TunedTile":
        return cls(
            tile_c=int(d["tile_c"]),
            buffering=str(d["buffering"]),
            dma_us=float(d["dma_us"]),
            compute_us=float(d["compute_us"]),
            total_us=float(d["total_us"]),
            measured_on=str(d["measured_on"]),
        )


class AutotuneTable:
    """Versioned (geometry key -> TunedTile) map with JSON persistence; a
    version mismatch loads as an empty table."""

    def __init__(self, entries: dict[str, TunedTile] | None = None):
        self.entries: dict[str, TunedTile] = dict(entries or {})

    def __len__(self) -> int:
        return len(self.entries)

    def record(self, layout: str, tuned: TunedTile, *, nbits: int, dim: int, cap: int,
               n_tokens: int) -> str:
        """Insert/overwrite the winner for one geometry bucket; returns
        the key written."""
        key = geometry_key(layout, nbits=nbits, dim=dim, cap=cap, n_tokens=n_tokens)
        self.entries[key] = tuned
        return key

    def lookup(self, layout: str, *, nbits: int, dim: int, cap: int, n_tokens: int,
               backend: str) -> TunedTile | None:
        """The winner for this geometry measured on ``backend``
        (``backend_kind`` of the planned index's device), or None (->
        heuristic)."""
        key = geometry_key(layout, nbits=nbits, dim=dim, cap=cap, n_tokens=n_tokens)
        tuned = self.entries.get(key)
        if tuned is None or tuned.measured_on != backend:
            return None
        return tuned

    def to_json(self) -> dict:
        return {
            "autotune_table_version": AUTOTUNE_TABLE_VERSION,
            "entries": {k: t.to_json() for k, t in sorted(self.entries.items())},
        }

    @classmethod
    def from_json(cls, doc: dict) -> "AutotuneTable":
        if doc.get("autotune_table_version") != AUTOTUNE_TABLE_VERSION:
            return cls()
        return cls({k: TunedTile.from_json(v) for k, v in doc.get("entries", {}).items()})

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "AutotuneTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


def default_table_path() -> str:
    """``REPRO_AUTOTUNE_TABLE``, else ``build/autotune_cuda.json`` in the
    repository."""
    return os.environ.get(TABLE_PATH_ENV) or str(DEFAULT_TABLE_PATH)


# Process-wide default table, loaded at first use; None = not loaded yet.
_default_table: AutotuneTable | None = None


def get_default_table() -> AutotuneTable:
    """The table plan resolution consults. A missing or corrupt file loads
    as an empty table: the table only advises, and without it the
    heuristic decides."""
    global _default_table
    if _default_table is None:
        try:
            _default_table = AutotuneTable.load(default_table_path())
        except (OSError, ValueError, KeyError, TypeError):
            _default_table = AutotuneTable()
    return _default_table


def set_default_table(table: AutotuneTable | None) -> None:
    """Install an in-process table; None goes back to loading the file at
    the next use."""
    global _default_table
    _default_table = table
