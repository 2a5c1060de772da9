# Copied from src/repro/obs/perfetto.py; keep the two in step.
"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON + JSONL.

``export_perfetto`` writes the classic ``{"traceEvents": [...]}``
format that both ``chrome://tracing`` and https://ui.perfetto.dev load
directly: symbolic ``(pid, tid)`` track names become integer ids with
``M`` (metadata) naming events, sync ``B``/``E`` spans nest per track,
async ``b``/``e`` spans (one per request lifecycle state) correlate by
id + category, ``C`` events render as counter tracks (pool occupancy,
queue depth, live policy lag).

``export_trace_jsonl`` is the grep-able flat form (one event per
line); ``benchmarks/trace_report.py`` reads either.

``trace_annotation`` wraps ``torch.profiler.record_function``, so a
``torch.profiler`` capture taken around a serve run shows the engine's
dispatch names above the kernels they launched.
"""
from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.obs.tracer import TraceEvent, Tracer

__all__ = [
    "events_to_trace_json",
    "export_perfetto",
    "export_trace_jsonl",
    "load_trace_events",
    "trace_annotation",
]

# Async spans need a category for id-scoping in the trace_event spec.
_ASYNC_CAT = "request"


def _resolve(events_or_tracer: Union[Tracer, Sequence[TraceEvent]]
             ) -> List[TraceEvent]:
    if isinstance(events_or_tracer, Tracer):
        return events_or_tracer.events()
    return list(events_or_tracer)


def events_to_trace_json(
        events_or_tracer: Union[Tracer, Sequence[TraceEvent]],
        extra_metadata: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """Build the ``{"traceEvents": [...]}`` dict (pure; no I/O)."""
    events = _resolve(events_or_tracer)
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[Dict[str, Any]] = []

    def pid_of(name: str) -> int:
        pid = pids.get(name)
        if pid is None:
            pid = pids[name] = len(pids) + 1
            out.append({"ph": "M", "name": "process_name", "pid": pid,
                        "tid": 0, "args": {"name": name}})
        return pid

    def tid_of(pname: str, tname: str) -> int:
        key = (pname, tname)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name",
                        "pid": pid_of(pname), "tid": tid,
                        "args": {"name": tname}})
        return tid

    for ev in events:
        rec: Dict[str, Any] = {
            "ph": ev.ph,
            "name": ev.name,
            "ts": ev.ts / 1e3,            # ns -> trace_event µs
            "pid": pid_of(ev.pid),
            "tid": tid_of(ev.pid, ev.tid),
        }
        if ev.args:
            rec["args"] = ev.args
        if ev.ph in ("b", "e", "n"):
            rec["cat"] = _ASYNC_CAT
            rec["id"] = ev.id
        elif ev.ph == "i":
            rec["s"] = "t"                # thread-scoped instant
        out.append(rec)
    meta: Dict[str, Any] = {"displayTimeUnit": "ms"}
    if extra_metadata:
        meta["metadata"] = extra_metadata
    meta["traceEvents"] = out
    return meta


def export_perfetto(
        events_or_tracer: Union[Tracer, Sequence[TraceEvent]],
        path: str,
        extra_metadata: Optional[Dict[str, Any]] = None) -> int:
    """Write Perfetto-loadable JSON; returns the event count."""
    doc = events_to_trace_json(events_or_tracer, extra_metadata)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")


def export_trace_jsonl(
        events_or_tracer: Union[Tracer, Sequence[TraceEvent]],
        path: str) -> int:
    """One raw event per line (symbolic tracks kept; ts stays ns)."""
    events = _resolve(events_or_tracer)
    lines = []
    for ev in events:
        rec: Dict[str, Any] = {"ph": ev.ph, "name": ev.name,
                               "ts": ev.ts, "pid": ev.pid, "tid": ev.tid}
        if ev.args:
            rec["args"] = ev.args
        if ev.id is not None:
            rec["id"] = ev.id
        lines.append(json.dumps(rec))
    data = ("\n".join(lines) + "\n") if lines else ""
    with open(path, "w", encoding="utf-8") as f:
        f.write(data)
    return len(events)


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Load either export format back into a flat list of event dicts
    with ``ts`` in microseconds (metadata events dropped).

    Perfetto JSON keeps its integer pid/tid; JSONL keeps symbolic
    names and converts ns -> µs, so a report reads both identically.
    """
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None                    # multi-line JSONL (or garbage)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return [e for e in doc["traceEvents"] if e.get("ph") != "M"]
    events = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        rec["ts"] = rec["ts"] / 1e3
        events.append(rec)
    return events


@contextlib.contextmanager
def trace_annotation(name: str):
    """``torch.profiler.record_function``: the name shows on the host
    timeline of a ``torch.profiler`` capture, above the kernels it
    launched."""
    import torch

    with torch.profiler.record_function(name):
        yield
