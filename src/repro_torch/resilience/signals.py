# Copied from src/repro/resilience/signals.py; keep the two in step.
"""SIGINT/SIGTERM -> flush telemetry, then exit.

Launchers register one flush callback (producer shutdown, trace
export, metrics JSONL) so an interrupted run still leaves its
observability artifacts on disk — a chaos run that gets killed is
exactly the run whose trace you want.

The handlers are one-shot: the previous handlers are restored before
the flush runs, so a second signal during a wedged flush falls through
to the default disposition (hard kill stays available).
"""
from __future__ import annotations

import signal
from typing import Callable, Dict, Iterable


def install_flush_handlers(
    flush: Callable[[int], None],
    signals: Iterable[int] = (signal.SIGINT, signal.SIGTERM),
) -> Dict[int, object]:
    """Run ``flush(signum)`` once on the first of ``signals``, then exit
    with the conventional ``128 + signum`` code.  Returns the previous
    handlers (callers may restore them after a clean finish)."""
    previous: Dict[int, object] = {}

    def _handler(signum, frame):
        for sig, prev in previous.items():
            signal.signal(sig, prev)
        try:
            flush(signum)
        finally:
            raise SystemExit(128 + signum)

    for sig in signals:
        previous[sig] = signal.signal(sig, _handler)
    return previous
