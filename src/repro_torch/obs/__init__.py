"""repro_torch.obs — tracing and metrics of the port. Counterpart of
``repro/obs/__init__.py``.

- ``obs.trace``: request-scoped span tracing (context-manager spans,
  injectable clock, bounded ring buffer, Chrome trace-event export for
  Perfetto).
- ``obs.metrics``: a process-wide registry of counters / gauges /
  fixed-bucket histograms with Prometheus text and JSON snapshot
  exposition, plus the port's one ``time_fn`` and ``percentiles``.

Runtime state is a three-level switch held in ``STATE``:

  disabled (default)   instrumented hot paths pay one attribute check
                       (``STATE.tracer is None`` / ``STATE.metrics is
                       None``).
  metrics              ``enable_metrics()``: counters/histograms record;
                       no spans; one ``torch.cuda.synchronize`` per
                       retrieve on the card (a latency over asynchronous
                       launches would time the enqueue).
  tracing              ``set_tracer(Tracer(...))``: per-stage spans with a
                       ``torch.cuda.synchronize(device)`` fence between
                       engine stages on the card (nothing to fence on the
                       CPU) — a span's duration means "this stage", so the
                       traced path gives up overlap for attribution.

``set_kernel_probes(True)`` arms a fourth switch, ``STATE.kernel_probes``:
every traced retrieve then re-times its fused scoring kernel at the
"full", "dma" and "compute" carve-outs
(``core/engine.py::kernel_dma_compute_split``) and records the split on
its ``gather_score`` span. Expensive: each traced retrieve launches the
kernel several more times. Untraced retrieves never read it.

Layering: ``repro_torch.obs`` imports nothing from the rest of the port —
core, serving, store and launch all import *it*. Sparse call sites use the
one-liners (``count``/``gauge``/``observe``/``span``), which no-op against
a disabled ``STATE``; hot loops hold metric object references directly.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS_S,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Stopwatch,
    percentiles,
    time_fn,
)
from repro_torch.obs.trace import (
    NULL_SPAN,
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    span_tree,
)

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS_S", "Stopwatch", "percentiles", "time_fn",
    # tracing
    "Span", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
    "span_tree",
    # runtime state
    "STATE", "enable_metrics", "disable_metrics", "set_tracer", "tracer",
    "set_kernel_probes", "disable_all",
    # convenience instrumentation
    "count", "gauge", "observe", "span",
]


class _ObsState:
    """Process-wide observability switch (see module docstring)."""

    __slots__ = ("metrics", "tracer", "kernel_probes")

    def __init__(self):
        self.metrics: MetricsRegistry | None = None
        self.tracer: Tracer | None = None
        self.kernel_probes: bool = False


STATE = _ObsState()


def enable_metrics(registry: MetricsRegistry | None = None) -> MetricsRegistry:
    """Turn on metrics recording (into ``registry`` or the process
    default ``REGISTRY``); returns the active registry."""
    STATE.metrics = registry if registry is not None else REGISTRY
    return STATE.metrics


def disable_metrics() -> None:
    STATE.metrics = None


def set_tracer(t: Tracer | None) -> Tracer | None:
    """Install (or with None, remove) the process tracer; returns it."""
    STATE.tracer = t
    return t


def tracer():
    """The active tracer, or ``NULL_TRACER`` — always safe to call
    ``.span()`` on the result."""
    t = STATE.tracer
    return t if t is not None else NULL_TRACER


def set_kernel_probes(on: bool) -> None:
    """Arm the staging/scoring split of the fused scoring kernel on traced
    retrieves (``core/engine.py::kernel_dma_compute_split``)."""
    STATE.kernel_probes = bool(on)


def disable_all() -> None:
    """Back to the zero-overhead default (tests reset through this)."""
    STATE.metrics = None
    STATE.tracer = None
    STATE.kernel_probes = False


# ---- sparse-call-site one-liners (no-ops when disabled) ----

def count(name: str, n: float = 1.0, help: str = "", **labels) -> None:
    reg = STATE.metrics
    if reg is not None:
        reg.counter(name, help, **labels).inc(n)


def gauge(name: str, value: float, help: str = "", **labels) -> None:
    reg = STATE.metrics
    if reg is not None:
        reg.gauge(name, help, **labels).set(value)


def observe(
    name: str, value: float, help: str = "", buckets=None, **labels
) -> None:
    reg = STATE.metrics
    if reg is not None:
        if buckets is None:
            buckets = DEFAULT_LATENCY_BUCKETS_S
        reg.histogram(name, help, buckets=buckets, **labels).observe(value)


def span(name: str, **args):
    """Context-manager span against the active tracer (``NULL_SPAN``
    when tracing is off)."""
    t = STATE.tracer
    return t.span(name, **args) if t is not None else NULL_SPAN
