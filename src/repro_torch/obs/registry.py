# Copied from src/repro/obs/registry.py; keep the two in step.
"""Unified metrics registry for serve, runtime and training telemetry.

Before this module the repo had three ad-hoc snapshot dicts —
``ServeStats.as_dict()``, ``RuntimeQueueStats.as_dict()`` and the
trainers' per-phase metric dicts — each with its own keys, collection
time and export path.  ``MetricsRegistry`` replaces that with one
sink:

* **Instruments** — :class:`Counter` (monotone), :class:`Gauge` (last
  value) and :class:`Histogram` (bounded raw-sample reservoir with
  exact percentiles over the retained window), all label-aware:
  ``registry.counter("drops", reason="tv_gate").inc()``.
* **Producers** — components that already maintain their own state
  (the engine's ``ServeStats``, the queue's ``RuntimeQueueStats``, a
  trainer) register a ``name -> fn`` producer; ``snapshot()`` calls
  every producer and merges its dict under its name.  Telemetry and
  benchmarks read the *same* snapshot, so they can never disagree.
* **Export** — ``snapshot()`` is a plain JSON-serializable dict;
  :meth:`MetricsRegistry.export_jsonl` appends it atomically as one
  line (see ``metrics.logging.MetricLogger`` for the streaming sink).

Histograms retain raw samples in a bounded deque (default 65536) so
serve-time percentiles (TTFT, inter-token, queue-wait) are exact over
the retained window and benchmarks can take **windowed** readings:
``h.count`` before a run, ``h.percentiles(start=before)`` after —
per-run percentiles from a registry shared across repeats.
"""
from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(name: str, key: LabelKey) -> str:
    if not key:
        return name
    inner = ",".join(f"{k}={v}" for k, v in key)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        self.value += amount


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Bounded raw-sample histogram with exact window percentiles.

    ``count``/``total`` cover every observation ever made; percentile
    queries cover the retained window (the last ``max_samples``
    observations).  ``percentiles(start=n)`` restricts to observations
    made after the ``count`` stood at ``n`` — the benchmark's per-run
    delta read on a shared registry.  Raises no errors on empty
    windows; returns zeros.
    """

    __slots__ = ("samples", "count", "total", "min", "max")

    def __init__(self, max_samples: int = 1 << 16) -> None:
        self.samples: deque = deque(maxlen=max_samples)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.samples.append(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def _window(self, start: Optional[int]) -> List[float]:
        if start is None:
            return list(self.samples)
        fresh = self.count - start
        if fresh <= 0:
            return []
        if fresh >= len(self.samples):
            return list(self.samples)
        return list(self.samples)[-fresh:]

    def percentiles(self, qs: Iterable[float] = (50.0, 90.0, 99.0),
                    start: Optional[int] = None) -> Dict[str, float]:
        """Exact percentiles (nearest-rank) over the retained window,
        or over observations made after ``count == start``."""
        xs = sorted(self._window(start))
        out: Dict[str, float] = {}
        n = len(xs)
        for q in qs:
            label = f"p{q:g}".replace(".", "_")
            if n == 0:
                out[label] = 0.0
            else:
                idx = min(n - 1, max(0, math.ceil(q / 100.0 * n) - 1))
                out[label] = xs[idx]
        return out

    def summary(self, start: Optional[int] = None) -> Dict[str, float]:
        xs = self._window(start)
        n = len(xs)
        base = {
            "count": float(self.count if start is None
                           else max(0, self.count - start)),
            "mean": (sum(xs) / n) if n else 0.0,
            "min": min(xs) if n else 0.0,
            "max": max(xs) if n else 0.0,
        }
        base.update(self.percentiles(start=start))
        return base


class MetricsRegistry:
    """Process-wide (or per-run) metric namespace.

    Thread-safe for instrument creation; instrument mutation itself is
    GIL-atomic (float add / deque append), matching the tracer's
    lock-free hot path.
    """

    def __init__(self) -> None:
        self._counters: Dict[Tuple[str, LabelKey], Counter] = {}
        self._gauges: Dict[Tuple[str, LabelKey], Gauge] = {}
        self._hists: Dict[Tuple[str, LabelKey], Histogram] = {}
        self._producers: Dict[str, Callable[[], Dict[str, Any]]] = {}
        self._lock = threading.Lock()

    # -- instruments ----------------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str, max_samples: int = 1 << 16,
                  **labels: Any) -> Histogram:
        key = (name, _label_key(labels))
        h = self._hists.get(key)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(
                    key, Histogram(max_samples=max_samples))
        return h

    # -- producers ------------------------------------------------------------

    def register_producer(self, name: str,
                          fn: Callable[[], Dict[str, Any]]) -> None:
        """``snapshot()[name] = fn()`` — components that keep their own
        stats (ServeStats, RuntimeQueueStats, trainers) plug in here.
        Re-registering a name replaces the producer (engines are
        rebuilt across benchmark repeats)."""
        with self._lock:
            self._producers[name] = fn

    def unregister_producer(self, name: str) -> None:
        with self._lock:
            self._producers.pop(name, None)

    def counter_values(self, *names: str) -> Dict[str, float]:
        """Rendered ``{name{labels}: value}`` for counters whose metric
        name is in ``names`` (all counters when empty).  Unlike
        :meth:`snapshot` this never invokes producers, so stats
        producers may call it without recursing into themselves."""
        with self._lock:
            counters = list(self._counters.items())
        return {
            _render(n, k): c.value
            for (n, k), c in counters
            if not names or n in names
        }

    # -- export ---------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One merged dict: producer sections by name, then
        ``counters`` / ``gauges`` / ``histograms`` sections keyed by
        rendered metric name (labels inline, Prometheus-style)."""
        out: Dict[str, Any] = {}
        with self._lock:
            producers = list(self._producers.items())
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        for name, fn in producers:
            out[name] = fn()
        if counters:
            out["counters"] = {
                _render(n, k): c.value for (n, k), c in counters}
        if gauges:
            out["gauges"] = {
                _render(n, k): g.value for (n, k), g in gauges}
        if hists:
            out["histograms"] = {
                _render(n, k): h.summary() for (n, k), h in hists}
        return out

    def export_jsonl(self, path: str, **extra: Any) -> Dict[str, Any]:
        """Append one atomic JSONL line holding ``snapshot()`` (+extra).

        The full line is encoded first and handed to the kernel as a
        single unbuffered write, so a crash mid-export can't leave a
        truncated row."""
        snap = self.snapshot()
        snap.update(extra)
        data = (json.dumps(snap) + "\n").encode("utf-8")
        with open(path, "ab", buffering=0) as f:
            f.write(data)
        return snap
