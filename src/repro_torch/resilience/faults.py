# Copied from src/repro/resilience/faults.py; keep the two in step.
"""Deterministic, seed-driven fault injection for the async runtime.

The runtime so far only ever exercises the happy path.  Real
deployments see producer crashes, straggler slots, hung queues and
poisoned weight pushes — all of which are *lag generators*: a
restarted actor resumes against a moved-on learner, a stalled slot
holds pages while the store advances.  This module gives the repo a
first-class way to rehearse those failures deterministically so the
supervision layer (see :mod:`repro_torch.resilience.supervision`) and the
admission controllers can be tested against them.

Fault plans are spec strings in the same ``name:key=val,...`` grammar
as controller specs, with multiple events joined by ``;``::

    "producer_crash:at_step=2;stall:slot=0,ms=200;nan_publish:at_publish=3"

Supported kinds and their trigger sites:

===============  ==============  =========================================
kind             site            match keys (all optional unless noted)
===============  ==============  =========================================
producer_crash   producer        ``at_step`` (Nth produced item, 0-based)
stall            engine_step     ``at_step``, ``slot``; ``ms`` (duration)
queue_stall      queue_put /     ``at_call``; ``ms`` (duration);
                 queue_get       ``site`` (restrict to one side)
nan_publish      publish         ``at_publish`` (Nth publish, 1-based) or
                                 ``version`` (absolute store version)
learner_nan      learner_step    ``at_step``
===============  ==============  =========================================

Every event also accepts ``count`` (max number of firings, default 1)
and ``p`` (firing probability per matching call, default 1.0 — drawn
from the injector's seeded RNG, so a given ``(plan, seed)`` pair
replays bit-identically).  Stall durations jitter by ``jitter`` (a
fraction of ``ms``, default 0) from the same RNG.

The injector is a null object when the plan is empty: every hook is a
cheap early-out, so production paths can call it unconditionally.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves_with_path, tree_map_with_path

__all__ = [
    "FaultEvent",
    "FaultInjector",
    "InjectedFault",
    "NULL_INJECTOR",
    "parse_fault_plan",
]

# kind -> site(s) where it can fire
FAULT_SITES: Dict[str, Tuple[str, ...]] = {
    "producer_crash": ("producer",),
    "stall": ("engine_step",),
    "queue_stall": ("queue_put", "queue_get"),
    "nan_publish": ("publish",),
    "learner_nan": ("learner_step",),
}

# keys every kind accepts on top of its own match keys
_COMMON_KEYS = ("count", "p", "jitter")
_KIND_KEYS: Dict[str, Tuple[str, ...]] = {
    "producer_crash": ("at_step", "producer"),
    "stall": ("at_step", "slot", "ms"),
    "queue_stall": ("at_call", "ms", "site"),
    "nan_publish": ("at_publish", "version"),
    "learner_nan": ("at_step",),
}


def _parse_value(text: str) -> Any:
    low = text.strip().lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            continue
    return text


@dataclasses.dataclass
class FaultEvent:
    """One parsed fault: a kind, match keys, and firing bookkeeping."""

    kind: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    count: int = 1
    p: float = 1.0
    fires: int = 0

    @property
    def exhausted(self) -> bool:
        return self.fires >= self.count

    def canonical(self) -> str:
        body = ",".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        return f"{self.kind}:{body}" if body else self.kind

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        """An event matches when every match key it names agrees with
        the call context.  A key the caller did not supply is a
        non-match (never a wildcard) so e.g. ``slot=3`` cannot fire
        from a site that does not report slots."""
        if self.exhausted or site not in FAULT_SITES[self.kind]:
            return False
        want_site = self.params.get("site")
        if want_site is not None and want_site != site:
            return False
        for key, want in self.params.items():
            if key in ("ms", "site"):
                continue
            if key not in ctx or ctx[key] != want:
                return False
        return True


def parse_fault_plan(text: Union[str, List[str], None]) -> List[FaultEvent]:
    """Parse ``"kind:k=v,...;kind:k=v"`` (or a list of such chunks)
    into :class:`FaultEvent` s.  An empty/None plan parses to ``[]``."""
    if text is None:
        return []
    chunks: List[str] = []
    if isinstance(text, str):
        chunks = [c for c in text.split(";") if c.strip()]
    else:
        for part in text:
            chunks.extend(c for c in str(part).split(";") if c.strip())
    events: List[FaultEvent] = []
    for chunk in chunks:
        chunk = chunk.strip()
        kind, _, body = chunk.partition(":")
        kind = kind.strip()
        if kind not in FAULT_SITES:
            raise ValueError(
                f"unknown fault kind {kind!r}; available: "
                f"{', '.join(sorted(FAULT_SITES))}")
        params: Dict[str, Any] = {}
        count, p = 1, 1.0
        if body.strip():
            for item in body.split(","):
                key, eq, val = item.partition("=")
                key = key.strip()
                if not key or not eq:
                    raise ValueError(
                        f"bad fault option {item!r} in {chunk!r} "
                        "(expected key=value)")
                value = _parse_value(val)
                if key == "count":
                    count = int(value)
                elif key == "p":
                    p = float(value)
                elif key in _KIND_KEYS[kind] or key in _COMMON_KEYS:
                    params[key] = value
                else:
                    raise ValueError(
                        f"unknown option {key!r} for fault {kind!r}; "
                        f"accepted: {sorted(_KIND_KEYS[kind] + _COMMON_KEYS)}")
        events.append(FaultEvent(kind=kind, params=params, count=count, p=p))
    return events


class InjectedFault(RuntimeError):
    """Raised by crash-type faults; carries the event that fired."""

    def __init__(self, event: FaultEvent, site: str) -> None:
        super().__init__(f"injected fault {event.canonical()} at {site}")
        self.event = event
        self.site = site


class FaultInjector:
    """Deterministic fault plan executor.

    One injector instance is shared across the components of a run
    (store, queue, regimes, engine, trainer); each component calls the
    hook for its site unconditionally.  All mutable state (fire
    counts, the RNG) is guarded by a lock because producer threads and
    the learner thread hit the same plan concurrently.
    """

    def __init__(
        self,
        plan: Union[str, List[str], None] = "",
        *,
        seed: int = 0,
        registry: Optional[Any] = None,
        tracer: Optional[Any] = None,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.events = parse_fault_plan(plan)
        self.seed = int(seed)
        self.registry = registry
        self.tracer = tracer
        self._sleep = sleep
        self._rng = np.random.RandomState(self.seed)
        self._lock = threading.Lock()
        self.fired: List[Tuple[str, str]] = []  # (kind, site) log

    @property
    def active(self) -> bool:
        return bool(self.events)

    def fired_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for kind, _site in self.fired:
                out[kind] = out.get(kind, 0) + 1
            return out

    # -- internal ----------------------------------------------------

    def _fire(self, site: str, ctx: Dict[str, Any]) -> List[FaultEvent]:
        """Return the events firing at this call, updating counters."""
        if not self.events:
            return []
        hits: List[FaultEvent] = []
        with self._lock:
            for ev in self.events:
                if not ev.matches(site, ctx):
                    continue
                if ev.p < 1.0 and self._rng.random_sample() >= ev.p:
                    continue
                ev.fires += 1
                self.fired.append((ev.kind, site))
                hits.append(ev)
        for ev in hits:
            if self.registry is not None:
                self.registry.counter(
                    "fault_injected_total", kind=ev.kind, site=site).inc()
            if self.tracer is not None:
                info = {"kind": ev.kind, "site": site,
                        "spec": ev.canonical()}
                info.update(ctx)
                self.tracer.instant(
                    "fault", pid="resilience", tid="injector", **info)
        return hits

    def _jittered_ms(self, ev: FaultEvent) -> float:
        ms = float(ev.params.get("ms", 0.0))
        jitter = float(ev.params.get("jitter", 0.0))
        if jitter > 0.0:
            with self._lock:
                ms *= 1.0 + jitter * (2.0 * self._rng.random_sample() - 1.0)
        return ms

    # -- hooks (call sites use exactly one of these per site) --------

    def crash_if(self, site: str, **ctx: Any) -> None:
        """Raise :class:`InjectedFault` if a crash fault matches."""
        hits = self._fire(site, ctx)
        for ev in hits:
            if ev.kind in ("producer_crash",):
                raise InjectedFault(ev, site)

    def stall(self, site: str, **ctx: Any) -> float:
        """Sleep out any matching stall faults; returns seconds slept."""
        hits = self._fire(site, ctx)
        total_ms = sum(self._jittered_ms(ev) for ev in hits
                       if ev.kind in ("stall", "queue_stall"))
        if total_ms > 0.0:
            self._sleep(total_ms / 1e3)
        return total_ms / 1e3

    def poison(self, site: str, params: Any, **ctx: Any) -> Tuple[Any, bool]:
        """Replace the first leaf, in ``jax.tree_util`` flatten order (dict
        keys sorted), with NaNs if a poison fault matches; returns
        ``(params, poisoned)``.  The tree is rebuilt, never written."""
        hits = [ev for ev in self._fire(site, ctx)
                if ev.kind in ("nan_publish", "learner_nan")]
        if not hits:
            return params, False
        leaves = tree_leaves_with_path(params)
        if not leaves:
            return params, True
        first = leaves[0][0]
        return tree_map_with_path(
            lambda path, x: (torch.full_like(x, float("nan"))
                             if path == first else x), params), True


NULL_INJECTOR = FaultInjector("")
