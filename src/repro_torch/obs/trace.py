"""Lightweight span tracer: one trace per served request, Perfetto-ready.
Counterpart of ``repro/obs/trace.py``.

A ``Tracer`` records complete spans (``ph="X"`` duration events in
Chrome trace-event terms) into a thread-safe bounded ring buffer — when
the buffer is full the *oldest* spans fall off and ``dropped`` counts
them, so a long-running server keeps the most recent requests and never
grows without bound. The clock is injectable (default
``time.perf_counter``): tests drive span trees deterministically with a
fake clock, and ``launch/serve.py`` hands the tracer the *server's*
clock so request-queue spans and engine spans share one timeline.

Span shapes:

- ``with tracer.span("gather_score", tile_c=32) as sp: ...`` — the live
  context-manager span; ``sp.set(k=v)`` attaches arguments discovered
  mid-span (the chosen bucket, kernel probe timings). Recorded at exit.
- ``tracer.add_event(name, ts, dur, ...)`` — a retroactive span with
  explicit times, for intervals measured after the fact (a request's
  queue wait is only known at dispatch). ``tid=`` places it on its own
  track — the serving batcher uses ``tid=request id`` so Perfetto shows
  one row per request next to the engine's thread rows.
- ``tracer.instant(name, ...)`` — a zero-duration marker (``ph="i"``).

``to_chrome()``/``export(path)`` emit the Chrome trace-event JSON object
format (``{"traceEvents": [...]}``, timestamps in microseconds) that
https://ui.perfetto.dev loads directly. ``span_tree`` rebuilds the
nesting by interval containment for tests and programmatic analysis.

The disabled path is ``NULL_TRACER``/``NULL_SPAN``: shared singletons
whose ``span()`` allocates nothing — instrumented call sites pay one
attribute check when tracing is off (see ``repro_torch.obs.STATE``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "NULL_SPAN",
    "span_tree",
]


class Span:
    """One recorded trace event: name, start ``ts`` + ``dur`` seconds on
    the tracer's clock, track ids, free-form ``args``. ``dur=None`` marks
    an instant event."""

    __slots__ = ("name", "ts", "dur", "pid", "tid", "args")

    def __init__(self, name, ts, dur, pid, tid, args):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.pid = pid
        self.tid = tid
        self.args = args

    @property
    def end(self) -> float:
        return self.ts + (self.dur or 0.0)

    def to_event(self) -> dict:
        ev = {
            "name": self.name,
            "ph": "X" if self.dur is not None else "i",
            "ts": round(self.ts * 1e6, 3),  # trace-event ts are in us
            "pid": self.pid,
            "tid": self.tid,
        }
        if self.dur is not None:
            ev["dur"] = round(self.dur * 1e6, 3)
        else:
            ev["s"] = "t"  # instant scope: thread
        if self.args:
            ev["args"] = {k: v for k, v in self.args.items()}
        return ev

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, ts={self.ts:.6f}, dur={self.dur}, "
            f"tid={self.tid}, args={self.args})"
        )


class _LiveSpan:
    """Context-manager span; records itself into the tracer on exit."""

    __slots__ = ("_tracer", "name", "args", "t0", "dur")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0 = 0.0
        self.dur: float | None = None

    def set(self, **kw) -> "_LiveSpan":
        """Attach arguments discovered while the span is open."""
        self.args.update(kw)
        return self

    def __enter__(self) -> "_LiveSpan":
        self.t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        self.dur = self._tracer.clock() - self.t0
        self._tracer._record(
            Span(self.name, self.t0, self.dur, self._tracer.pid,
                 threading.get_ident(), self.args)
        )
        return False


class _NullSpan:
    """Shared no-op span: the disabled default's entire per-span cost."""

    __slots__ = ()
    dur = None

    def set(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every method no-ops, ``span`` returns the shared
    ``NULL_SPAN``. Call sites branch on ``enabled`` when they would do
    host-side work (building a rids list) just to feed a span."""

    enabled = False

    def span(self, name: str, **args) -> _NullSpan:
        return NULL_SPAN

    def add_event(self, name, ts, dur, *, tid=None, **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def events(self) -> list:
        return []


NULL_TRACER = NullTracer()


class Tracer:
    """Thread-safe bounded span recorder with an injectable clock.

    ``capacity`` bounds the ring buffer (oldest spans drop first;
    ``dropped`` counts evictions). ``pid`` defaults to the OS pid; the
    serving layer keeps engine spans on pid/tid tracks and request-scoped
    retroactive events on ``tid=request id`` rows.
    """

    enabled = True

    def __init__(
        self,
        clock: Callable[[], float] = time.perf_counter,
        capacity: int = 1 << 16,
        pid: int | None = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.clock = clock
        self.capacity = capacity
        self.pid = os.getpid() if pid is None else pid
        self.dropped = 0
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def span(self, name: str, **args) -> _LiveSpan:
        """Open a context-manager span; recorded when the block exits."""
        return _LiveSpan(self, name, args)

    def add_event(
        self, name: str, ts: float, dur: float, *, tid=None, **args
    ) -> None:
        """Record a span with explicit times (retroactive intervals —
        e.g. queue wait, known only at dispatch)."""
        self._record(
            Span(name, ts, dur, self.pid,
                 threading.get_ident() if tid is None else tid, args)
        )

    def instant(self, name: str, **args) -> None:
        self._record(
            Span(name, self.clock(), None, self.pid,
                 threading.get_ident(), args)
        )

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1  # deque evicts the oldest on append
            self._events.append(span)

    def events(self) -> list[Span]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto loads it directly)."""
        return {
            "traceEvents": [s.to_event() for s in self.events()],
            "displayTimeUnit": "ms",
        }

    def export(self, path: str) -> str:
        """Write ``to_chrome()`` to ``path``; returns the path."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


def span_tree(events: list[Span], tid=None) -> list[dict]:
    """Rebuild span nesting by interval containment.

    Complete spans on one track (``tid``, default: the only/every track
    merged) sorted by start time become ``{"span": Span, "children":
    [...]}`` nodes; a span is a child of the innermost span whose
    [ts, end] interval contains it. Deterministic given a deterministic
    clock — the shape tests assert on.
    """
    spans = [
        s for s in events
        if s.dur is not None and (tid is None or s.tid == tid)
    ]
    spans.sort(key=lambda s: (s.ts, -(s.dur or 0.0)))
    roots: list[dict] = []
    stack: list[dict] = []
    for s in spans:
        node = {"span": s, "children": []}
        while stack and s.ts >= stack[-1]["span"].end:
            stack.pop()
        if stack:
            stack[-1]["children"].append(node)
        else:
            roots.append(node)
        stack.append(node)
    return roots
