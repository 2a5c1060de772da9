# Copied from src/repro/obs/tracer.py; keep the two in step.
"""Low-overhead span tracer for the serve/runtime request lifecycle.

Design constraints, in order:

1. **Zero cost when disabled.**  Every instrumented call site holds a
   ``Tracer`` reference that is :data:`NULL_TRACER` by default — a
   no-op singleton whose methods do nothing and whose ``enabled`` /
   ``full`` flags are ``False`` so hot paths can skip even building the
   args dict.  No ``if tracer is not None`` branches at call sites.
2. **Low overhead when enabled.**  Events are plain tuples appended to
   a bounded ``collections.deque`` (``maxlen`` ring: old events fall
   off, tracing never OOMs a long run).  Timestamps come from
   ``time.monotonic_ns()`` relative to the tracer's epoch — monotonic,
   immune to wall-clock steps, cheap.  ``deque.append`` is atomic under
   the GIL, so runtime producer threads and the engine thread share one
   tracer without a lock on the hot path.
3. **Perfetto-shaped.**  Events carry the Chrome ``trace_event``
   phases directly: ``B``/``E`` sync spans nest per track, ``b``/``e``
   async spans (keyed by an id) model per-request lifecycle states
   that overlap arbitrarily across requests, ``i`` instants, ``C``
   counter samples.  ``obs.perfetto`` serializes them 1:1.

Tracks are ``(pid, tid)`` *string* pairs — e.g. ``("serve",
"slot0")``, ``("runtime", "producer")`` — mapped to integer ids at
export time, with metadata naming events emitted for Perfetto's UI.

Detail levels (``--trace-detail``):

* ``off``   — tracer disabled entirely (``NULL_TRACER`` semantics).
* ``spans`` — lifecycle spans, dispatch spans, instants, counters.
* ``full``  — adds per-token instant events (rid, version, lag): the
  provenance stream ``benchmarks/trace_report.py`` builds its
  lag-at-emission histogram from.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "NULL_TRACER",
    "Span",
    "TraceEvent",
    "Tracer",
    "make_tracer",
]

DETAIL_LEVELS = ("off", "spans", "full")


@dataclass(frozen=True)
class TraceEvent:
    """One trace event; field names follow Chrome ``trace_event``.

    ``ts`` is nanoseconds since the tracer epoch (exporters convert to
    the format's microseconds).  ``pid``/``tid`` are symbolic track
    names.  ``id`` is set only for async (``b``/``e``) events.
    """

    ph: str                      # B E b e i C
    name: str
    ts: int                      # ns since tracer epoch
    pid: str
    tid: str
    args: Optional[Dict[str, Any]] = None
    id: Optional[int] = None     # async-span correlation id


class Span:
    """Context manager closing a sync span on exit (exceptions too)."""

    __slots__ = ("_tracer", "_name", "_pid", "_tid")

    def __init__(self, tracer: "Tracer", name: str, pid: str,
                 tid: str) -> None:
        self._tracer = tracer
        self._name = name
        self._pid = pid
        self._tid = tid

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer.end(self._name, self._pid, self._tid)


class Tracer:
    """Ring-buffered host-side trace collector.

    One instance is shared by the serve engine, scheduler, allocator,
    runtime store/queue and trainer; they address disjoint tracks, so
    a single export shows the full end-to-end picture.
    """

    enabled: bool = True

    def __init__(self, capacity: int = 1 << 16,
                 detail: str = "spans") -> None:
        if detail not in DETAIL_LEVELS:
            raise ValueError(
                f"detail must be one of {DETAIL_LEVELS}, got {detail!r}")
        if detail == "off":
            raise ValueError(
                "detail='off' means no tracer: use NULL_TRACER")
        self.detail = detail
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._epoch_ns = time.monotonic_ns()
        self._dropped = 0
        self._lock = threading.Lock()   # only for clear()/drain races

    # -- clocks ---------------------------------------------------------------

    @property
    def full(self) -> bool:
        """True when per-token events should be emitted."""
        return self.detail == "full"

    def now(self) -> int:
        """ns since the tracer epoch (monotonic)."""
        return time.monotonic_ns() - self._epoch_ns

    def to_trace_ns(self, monotonic_s: float) -> int:
        """Convert a ``time.monotonic()`` stamp (seconds) into this
        tracer's timebase — lets pre-recorded stamps like
        ``Request.submit_time`` land on the same axis."""
        return int(monotonic_s * 1e9) - self._epoch_ns

    # -- emission -------------------------------------------------------------

    def _emit(self, ev: TraceEvent) -> None:
        if len(self._events) == self._events.maxlen:
            self._dropped += 1
        self._events.append(ev)

    def begin(self, name: str, pid: str = "serve", tid: str = "engine",
              ts: Optional[int] = None, **args: Any) -> None:
        """Open a sync span on track (pid, tid); must nest."""
        self._emit(TraceEvent("B", name, self.now() if ts is None else ts,
                              pid, tid, args or None))

    def end(self, name: str, pid: str = "serve", tid: str = "engine",
            ts: Optional[int] = None, **args: Any) -> None:
        self._emit(TraceEvent("E", name, self.now() if ts is None else ts,
                              pid, tid, args or None))

    def span(self, name: str, pid: str = "serve",
             tid: str = "engine", **args: Any) -> Span:
        """``with tracer.span("decode", tid="engine"): ...``"""
        self.begin(name, pid, tid, **args)
        return Span(self, name, pid, tid)

    def async_begin(self, name: str, aid: int, pid: str = "serve",
                    tid: str = "requests", ts: Optional[int] = None,
                    **args: Any) -> None:
        """Open an async span keyed by ``aid`` (request lifecycles:
        many requests overlap, so they can't nest on one track)."""
        self._emit(TraceEvent("b", name, self.now() if ts is None else ts,
                              pid, tid, args or None, id=aid))

    def async_end(self, name: str, aid: int, pid: str = "serve",
                  tid: str = "requests", ts: Optional[int] = None,
                  **args: Any) -> None:
        self._emit(TraceEvent("e", name, self.now() if ts is None else ts,
                              pid, tid, args or None, id=aid))

    def instant(self, name: str, pid: str = "serve",
                tid: str = "engine", ts: Optional[int] = None,
                **args: Any) -> None:
        self._emit(TraceEvent("i", name, self.now() if ts is None else ts,
                              pid, tid, args or None))

    def counter(self, name: str, pid: str = "serve",
                tid: str = "counters", ts: Optional[int] = None,
                **values: float) -> None:
        """Sample counter series (one Perfetto counter track per name,
        one series per kwarg)."""
        self._emit(TraceEvent("C", name, self.now() if ts is None else ts,
                              pid, tid, dict(values)))

    # -- access ---------------------------------------------------------------

    def events(self) -> List[TraceEvent]:
        """Snapshot of the ring (oldest first)."""
        with self._lock:
            return list(self._events)

    @property
    def dropped(self) -> int:
        """Events evicted from the ring since construction."""
        return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events())


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _NullTracer(Tracer):
    """Do-nothing tracer: the default at every instrumentation point.

    Methods are overridden to plain no-ops (no ring, no clock reads),
    so instrumented code pays one attribute lookup + an empty call when
    tracing is off — and call sites can skip even that by checking
    ``tracer.enabled`` before assembling args.
    """

    enabled = False

    def __init__(self) -> None:   # noqa: D401 - deliberately no super()
        self.detail = "off"
        self.capacity = 0
        self._events = deque(maxlen=0)
        self._dropped = 0
        self._epoch_ns = 0
        self._lock = threading.Lock()

    @property
    def full(self) -> bool:
        return False

    def begin(self, *a: Any, **k: Any) -> None:
        pass

    def end(self, *a: Any, **k: Any) -> None:
        pass

    def span(self, *a: Any, **k: Any) -> _NullSpan:  # type: ignore[override]
        return _NULL_SPAN

    def async_begin(self, *a: Any, **k: Any) -> None:
        pass

    def async_end(self, *a: Any, **k: Any) -> None:
        pass

    def instant(self, *a: Any, **k: Any) -> None:
        pass

    def counter(self, *a: Any, **k: Any) -> None:
        pass


NULL_TRACER = _NullTracer()


def make_tracer(detail: str = "spans",
                capacity: int = 1 << 16) -> Tracer:
    """``detail='off'`` returns :data:`NULL_TRACER`; anything else a
    live :class:`Tracer` — the one switch launchers need."""
    if detail not in DETAIL_LEVELS:
        raise ValueError(
            f"detail must be one of {DETAIL_LEVELS}, got {detail!r}")
    if detail == "off":
        return NULL_TRACER
    return Tracer(capacity=capacity, detail=detail)
