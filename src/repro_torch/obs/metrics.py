"""Process-wide metrics: counters, gauges, fixed-bucket histograms.
Counterpart of ``repro/obs/metrics.py``: the same series names, label
sets, Prometheus text and snapshot for the same sequence of operations.

Deterministic by construction — histograms bin observations into a fixed
ascending bucket edge list (no reservoir sampling, no decay), so the same
observation stream always produces the same exposition, the same
quantile estimates, and the same golden-test output. Everything is
guarded by one registry lock; metric objects themselves mutate plain
Python ints/floats under the GIL (a single ``+=`` per observation — the
serving loop is single-owner, like the batcher it instruments).

Two export surfaces:

- ``MetricsRegistry.to_prometheus()`` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` headers, cumulative ``_bucket{le=...}``
  histogram series with ``_sum``/``_count``), scrapeable as-is.
- ``MetricsRegistry.snapshot()`` — a JSON-serializable dict, the shape
  ``launch/serve.py --metrics-dump`` writes and tests golden-match.

This module is also the port's **single definition of timing and
percentiles**: ``time_fn`` (median wall time of a callable, injectable
clock + sync hook) and ``percentiles`` (linear-interpolation p50/p95/p99,
numpy's default method), so a timed p99 and a served p99 mean the same
statistic. ``Histogram.quantile`` is the streaming counterpart:
linear interpolation *within* the containing bucket, clamped to the
observed min/max — deterministic, bounded error = bucket width.

No port imports here (``repro_torch.obs`` sits below core/serving/store
in the dependency order); numpy only, and only for ``percentiles``.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "DEFAULT_LATENCY_BUCKETS_S",
    "percentiles",
    "time_fn",
    "Stopwatch",
]

# Latency bucket edges in seconds: 100us .. 10s on a 1-2.5-5 ladder —
# wide enough for CPU-interpret kernels, fine enough that a serving p99
# lands inside a bucket ~2.5x its neighbor. Shared default; metric sites
# with different dynamic range pass their own edges.
DEFAULT_LATENCY_BUCKETS_S = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def percentiles(samples, qs=(50.0, 95.0, 99.0)) -> tuple[float, ...]:
    """THE p50/p95/p99 definition (linear interpolation between closest
    ranks — numpy's default ``np.percentile`` method), shared by the
    benchmark suites and the serving summary so the two report the same
    statistic. Empty input -> zeros (an idle server has no latency)."""
    import numpy as np

    a = np.asarray(samples, np.float64).reshape(-1)
    if a.size == 0:
        return tuple(0.0 for _ in qs)
    return tuple(float(v) for v in np.atleast_1d(np.percentile(a, list(qs))))


def time_fn(
    fn: Callable,
    *args,
    warmup: int = 2,
    iters: int = 5,
    clock: Callable[[], float] = time.perf_counter,
    sync: Callable | None = None,
    **kwargs,
) -> float:
    """Median wall time (seconds) of a callable, post-warmup.

    ``sync`` is called on the return value inside the timed region — pass
    one that calls ``torch.cuda.synchronize(device)`` for work queued on
    the card (nothing is needed on the CPU), so asynchronous launches
    don't fake a zero. ``clock`` is injectable for deterministic
    tests, like the tracer's.
    """
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        if sync is not None:
            sync(out)
    samples = []
    for _ in range(iters):
        t0 = clock()
        out = fn(*args, **kwargs)
        if sync is not None:
            sync(out)
        samples.append(clock() - t0)
    return percentiles(samples, (50.0,))[0]


class Stopwatch:
    """``with Stopwatch() as sw: ...`` -> ``sw.elapsed`` seconds; the
    shared inline-timing shape (replaces ad-hoc ``perf_counter`` pairs).
    Pass ``hist=`` to observe the elapsed time into a Histogram on exit."""

    __slots__ = ("clock", "hist", "t0", "elapsed")

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        hist: "Histogram | None" = None,
    ):
        self.clock = clock
        self.hist = hist
        self.t0 = 0.0
        self.elapsed = 0.0

    def __enter__(self) -> "Stopwatch":
        self.t0 = self.clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.elapsed = self.clock() - self.t0
        if self.hist is not None:
            self.hist.observe(self.elapsed)
        return False


def _fmt(v: float) -> str:
    """Prometheus sample value: integral floats render as ints."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple, extra: tuple = ()) -> str:
    items = (*labels, *extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class Counter:
    """Monotonically increasing count."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        self.value += n

    def _snap(self) -> dict:
        return {"value": self.value}

    def _expose(self, lines: list) -> None:
        lines.append(f"{self.name}{_fmt_labels(self.labels)} {_fmt(self.value)}")


class Gauge:
    """Point-in-time value (queue depth, delta fraction, epoch)."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "value")

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n

    def _snap(self) -> dict:
        return {"value": self.value}

    def _expose(self, lines: list) -> None:
        lines.append(f"{self.name}{_fmt_labels(self.labels)} {_fmt(self.value)}")


class Histogram:
    """Fixed-bucket latency histogram (deterministic; no sampling).

    ``buckets`` are ascending upper edges (``le`` semantics, an implicit
    +Inf bucket tops them); per-observation cost is one bisect + three
    adds. Tracks count/sum/min/max so ``quantile`` can clamp its
    interpolation to the observed range — the +Inf bucket interpolates
    toward the observed max instead of infinity.
    """

    kind = "histogram"
    __slots__ = (
        "name", "help", "labels", "buckets", "counts",
        "count", "sum", "min", "max",
    )

    def __init__(
        self,
        name: str,
        help: str = "",
        labels: tuple = (),
        buckets: tuple = DEFAULT_LATENCY_BUCKETS_S,
    ):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(b >= a for b, a in zip(edges, edges[1:])):
            raise ValueError(
                f"histogram {name}: bucket edges must be strictly "
                f"ascending and non-empty, got {buckets}"
            )
        self.name = name
        self.help = help
        self.labels = labels
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)  # per-bucket, +Inf last
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Deterministic streaming quantile, q in [0, 1]: find the bucket
        containing rank ``q * count``, linearly interpolate within it,
        clamp to [observed min, observed max]. 0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if cum + c >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else min(0.0, self.min)
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                frac = (target - cum) / c
                return min(max(lo + frac * (hi - lo), self.min), self.max)
            cum += c
        return self.max

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    def _snap(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "buckets": list(self.buckets),
            "counts": list(self.counts),
        }

    def _expose(self, lines: list) -> None:
        cum = 0
        for edge, c in zip(self.buckets, self.counts):
            cum += c
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels(self.labels, (('le', _fmt(edge)),))} {cum}"
            )
        lines.append(
            f"{self.name}_bucket"
            f"{_fmt_labels(self.labels, (('le', '+Inf'),))} {self.count}"
        )
        lines.append(
            f"{self.name}_sum{_fmt_labels(self.labels)} {_fmt(self.sum)}"
        )
        lines.append(
            f"{self.name}_count{_fmt_labels(self.labels)} {self.count}"
        )


class MetricsRegistry:
    """Get-or-create registry of metrics keyed on (name, sorted labels).

    ``counter``/``gauge``/``histogram`` return the live metric object —
    hot paths hold a direct reference and pay one attribute bump per
    event, no registry lookup. Re-requesting an existing (name, labels)
    pair returns the same object; requesting it as a different kind
    raises. A process-default instance lives at ``REGISTRY``; the serving
    server builds a private one per instance so test assertions don't
    bleed across servers.
    """

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, labels: dict, **extra):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(
                    name, help, tuple(sorted(labels.items())), **extra
                )
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested as {cls.kind}"
                )
            elif help and not m.help:
                m.help = help
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: tuple = DEFAULT_LATENCY_BUCKETS_S,
        **labels,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def series(self, name: str) -> list:
        """Every registered metric with this name (one per label set)."""
        with self._lock:
            return [m for (n, _), m in self._metrics.items() if n == name]

    def metrics(self) -> list:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-serializable dump: {name: {type, help, series: [...]}}."""
        out: dict = {}
        for m in self.metrics():
            entry = out.setdefault(
                m.name, {"type": m.kind, "help": m.help, "series": []}
            )
            entry["series"].append({"labels": dict(m.labels), **m._snap()})
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one HELP/TYPE header per name)."""
        lines: list[str] = []
        seen: set[str] = set()
        for m in self.metrics():
            if m.name not in seen:
                seen.add(m.name)
                if m.help:
                    lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            m._expose(lines)
        return "\n".join(lines) + ("\n" if lines else "")


# Process-default registry: `launch/serve.py --metrics-dump` and the
# store-layer convenience hooks write here when metrics are enabled.
REGISTRY = MetricsRegistry()
