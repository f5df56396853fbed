"""Fault plans: scripted rules + seeded random schedules over named sites.

Counterpart of ``repro/fault/plan.py``, kept as a copy: the same sites,
rules and seeded schedules, so a plan fires at the same hits in both
packages. See the package docstring for the site catalogue. The plan is
dependency-free — ``repro_torch.fault`` imports nothing from the rest of
the port (the layering rule of ``repro_torch.obs``), so every layer can
consult it without cycles.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
from collections import Counter
from typing import Callable

__all__ = [
    "SITES",
    "InjectedFault",
    "FaultRule",
    "FaultPlan",
    "FAULTS",
    "check",
    "install",
    "uninstall",
    "active",
]

# The catalogue of injection points wired into the codebase. ``check``
# accepts any site name (a plan may script sites added later), but tests
# assert their schedules against this list to catch typos.
SITES = (
    "store.array_read",
    "store.manifest_parse",
    "store.segment_load",
    "store.compact_step",
    "engine.kernel_call",
    "server.reload",
)


class InjectedFault(RuntimeError):
    """Default exception raised by a firing injection point.

    Layers under test are expected to convert it (like any unexpected
    ``OSError``/``RuntimeError`` from the same spot) into their typed
    error or a graceful degradation — an ``InjectedFault`` escaping to a
    client is a resilience bug by definition.
    """


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scripted firing: at the ``at``-th hit of ``site`` (0-based,
    counted per site across the plan's lifetime), raise for ``times``
    consecutive hits. ``error`` is an exception instance, an exception
    class, or a zero-arg factory; None raises ``InjectedFault``."""

    site: str
    at: int = 0
    times: int = 1
    error: BaseException | type[BaseException] | Callable[[], BaseException] | None = None

    def covers(self, hit: int) -> bool:
        return self.at <= hit < self.at + self.times


class FaultPlan:
    """A deterministic schedule of fault firings.

    Two composable modes:

    - **scripted**: ``FaultRule`` entries pin firings to exact hit
      indices — the kill-point tests use this to interrupt the compact
      protocol at every checkpoint in turn.
    - **seeded**: ``rates`` maps a site to a firing probability, drawn
      from a private ``random.Random(seed)`` — the chaos test uses this
      to randomize schedules while staying replayable from the seed.

    ``hits`` / ``fired`` count per-site consults and firings, so tests
    can assert both that a schedule exercised a site and that a hardened
    layer survived every firing.
    """

    def __init__(
        self,
        rules: tuple[FaultRule, ...] | list[FaultRule] = (),
        *,
        seed: int | None = None,
        rates: dict[str, float] | None = None,
    ):
        self.rules = tuple(rules)
        self.rates = dict(rates or {})
        self.seed = seed
        self._rng = random.Random(seed)
        self.hits: Counter = Counter()
        self.fired: Counter = Counter()

    def check(self, site: str, **ctx) -> None:
        """Consult the plan at ``site``; raises when a rule or the seeded
        schedule says this hit fails. ``ctx`` is folded into the default
        error message (which file / which op), never into the decision."""
        hit = self.hits[site]
        self.hits[site] = hit + 1
        for rule in self.rules:
            if rule.site == site and rule.covers(hit):
                self._fire(site, hit, rule.error, ctx)
        rate = self.rates.get(site)
        if rate and self._rng.random() < rate:
            self._fire(site, hit, None, ctx)

    def _fire(self, site: str, hit: int, error, ctx) -> None:
        self.fired[site] += 1
        if error is None:
            detail = "".join(f" {k}={v!r}" for k, v in sorted(ctx.items()))
            raise InjectedFault(f"injected fault at {site} (hit {hit}){detail}")
        if isinstance(error, BaseException):
            raise error
        raise error()  # class or zero-arg factory


class _FaultState:
    """Process-wide switch: ``plan is None`` (the default) keeps every
    hook at a single attribute check — the same tri-state pattern as
    ``obs.STATE``."""

    __slots__ = ("plan",)

    def __init__(self):
        self.plan: FaultPlan | None = None


FAULTS = _FaultState()


def install(plan: FaultPlan) -> FaultPlan:
    FAULTS.plan = plan
    return plan


def uninstall() -> None:
    FAULTS.plan = None


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped installation: ``with fault.active(FaultPlan(...)):`` — the
    previous plan (usually None) is restored on exit, even on error."""
    prev = FAULTS.plan
    FAULTS.plan = plan
    try:
        yield plan
    finally:
        FAULTS.plan = prev


def check(site: str, **ctx) -> None:
    """Module-level convenience hook. Sparse call sites use this; hot
    paths inline ``if FAULTS.plan is not None: FAULTS.plan.check(...)``
    to keep the disabled cost at one attribute check."""
    p = FAULTS.plan
    if p is not None:
        p.check(site, **ctx)
