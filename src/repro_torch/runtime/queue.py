# Copied from src/repro/runtime/queue.py; keep the two in step.
"""Staleness-tagged trajectory queue between actors and the learner.

Every item carries its behavior policy version (stamped by the producer)
and the learner version at both enqueue and consume time, so the item's
*lag* — the quantity every loss in the paper conditions on — is an
observable of the queue rather than something trainers reconstruct.

The queue is thread-safe (the ``threaded`` regime runs a real producer
thread against a consuming learner) and applies its admission policy at
the consume boundary: ``get`` keeps popping until a policy-admitted item
surfaces, counting drops/downweights and recording the lag histogram for
``metrics.runtime_metrics``.  A bounded ``maxsize`` gives natural
backpressure on the producer.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.metrics.runtime_metrics import LagHistogram, RuntimeQueueStats
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.resilience import FaultInjector, NULL_INJECTOR
from repro_torch.runtime.admission import AdmissionPolicy, PassThrough


@dataclass
class TrajectoryItem:
    payload: Any
    behavior_version: int
    enqueue_learner_version: int
    learner_version_at_consume: Optional[int] = None
    weight: float = 1.0
    tv: Optional[float] = None
    meta: Dict[str, Any] = field(default_factory=dict)
    # Mixture items (backward_mixture, mid-swap served trajectories) span
    # a range of behavior versions; `behavior_version` is the oldest (the
    # conservative representative), `behavior_version_newest` the newest.
    # None means a single-version item (newest == oldest).
    behavior_version_newest: Optional[int] = None

    @property
    def _ref_version(self) -> int:
        return (
            self.learner_version_at_consume
            if self.learner_version_at_consume is not None
            else self.enqueue_learner_version
        )

    @property
    def lag(self) -> int:
        """Learner updates between the *oldest* behavior policy any token
        was sampled from and (consume) use."""
        return self._ref_version - self.behavior_version

    @property
    def lag_oldest(self) -> int:
        """Alias of :attr:`lag`: the item's worst-case staleness."""
        return self.lag

    @property
    def lag_newest(self) -> int:
        """Staleness of the freshest behavior version in the item."""
        newest = (
            self.behavior_version_newest
            if self.behavior_version_newest is not None
            else self.behavior_version
        )
        return self._ref_version - newest


class QueueClosed(RuntimeError):
    """put() after close() — the learner has shut the run down."""


class TrajectoryQueue:
    """FIFO of :class:`TrajectoryItem` with consume-time admission."""

    def __init__(
        self,
        maxsize: int = 0,
        admission: Optional[AdmissionPolicy] = None,
        tracer: Tracer = NULL_TRACER,
        registry: Any = None,
        injector: FaultInjector = NULL_INJECTOR,
        fallback_admission: Optional[AdmissionPolicy] = None,
        fallback_max_lag: int = 4,
    ) -> None:
        """``tracer`` gets put/pop/drop instants (with the TV verdict
        and lag at decision time) plus a queue-depth counter track;
        ``registry`` (an ``obs.MetricsRegistry``) gets this queue's
        stats as the ``"queue"`` producer so one ``snapshot()`` covers
        serve and runtime alike."""
        self.maxsize = maxsize
        self.admission = admission or PassThrough()
        self.tracer = tracer
        if registry is None:
            from repro_torch.obs.registry import MetricsRegistry

            registry = MetricsRegistry()
        else:
            registry.register_producer(
                "queue", lambda: self.stats().as_dict())
        self.registry = registry
        self._dq: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        # counters (guarded by _cond's lock)
        self._puts = 0
        self._admitted = 0
        self._dropped = 0
        self._downweighted = 0
        # Labelled registry counters, keyed (outcome, reason).  The
        # per-reason dicts in stats() are derived views of these — one
        # source of truth, visible in registry.snapshot() as
        # queue_admission_total{controller=...,outcome=...,reason=...}.
        self._decision_counters: Dict[tuple, Any] = {}
        self._lag_histogram = LagHistogram()
        # Resilience: fault hooks + the max_lag fallback admission used
        # when the configured controller raises mid-run (graceful
        # degradation — a buggy controller must not kill the trainer).
        self.injector = injector
        self._gets = 0
        self._fallback_max_lag = int(fallback_max_lag)
        self._fallback = fallback_admission
        self._fallback_active = False

    def _fallback_admission(self) -> AdmissionPolicy:
        if self._fallback is None:
            from repro_torch.runtime.admission import MaxLagEviction

            self._fallback = MaxLagEviction(max_lag=self._fallback_max_lag)
        return self._fallback

    def _count_decision(self, outcome: str, reason: str) -> None:
        """Bump queue_admission_total{controller,outcome,reason} (must be
        called with ``_cond`` held)."""
        key = (outcome, reason)
        counter = self._decision_counters.get(key)
        if counter is None:
            counter = self.registry.counter(
                "queue_admission_total",
                controller=self.admission.name,
                outcome=outcome, reason=reason)
            self._decision_counters[key] = counter
        counter.inc()

    def _by_reason(self, outcome: str) -> Dict[str, int]:
        return {
            reason: int(c.value)
            for (o, reason), c in self._decision_counters.items()
            if o == outcome
        }

    def admission_counters(self) -> Dict[str, int]:
        """The labelled-counter view, rendered Prometheus-style — the
        same strings ``registry.snapshot()['counters']`` shows, readable
        without re-entering the registry's snapshot producers."""
        name = self.admission.name
        with self._cond:
            return {
                f"queue_admission_total{{controller={name},"
                f"outcome={o},reason={r}}}": int(c.value)
                for (o, r), c in self._decision_counters.items()
            }

    # -- producer side -------------------------------------------------------

    def put(
        self,
        payload: Any,
        *,
        behavior_version: int,
        learner_version: int,
        behavior_version_newest: Optional[int] = None,
        **meta: Any,
    ) -> TrajectoryItem:
        """Enqueue; blocks when bounded and full (producer backpressure)."""
        item = TrajectoryItem(
            payload=payload,
            behavior_version=int(behavior_version),
            enqueue_learner_version=int(learner_version),
            behavior_version_newest=(
                None if behavior_version_newest is None
                else int(behavior_version_newest)),
            meta=dict(meta),
        )
        if self.injector.active:
            with self._cond:
                call = self._puts + 1
            self.injector.stall("queue_put", at_call=call)
        with self._cond:
            while (
                self.maxsize > 0
                and len(self._dq) >= self.maxsize
                and not self._closed
            ):
                self._cond.wait()
            if self._closed:
                raise QueueClosed("put() on a closed TrajectoryQueue")
            self._dq.append(item)
            self._puts += 1
            depth = len(self._dq)
            self._cond.notify_all()
        tr = self.tracer
        if tr.enabled:
            tr.instant("queue_put", pid="runtime", tid="queue",
                       behavior_version=item.behavior_version,
                       lag=item.lag)
            tr.counter("queue_depth", pid="runtime", depth=float(depth))
        return item

    def close(self) -> None:
        """Wake all waiters; further puts raise, gets drain then None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # -- consumer side -------------------------------------------------------

    def get(
        self,
        *,
        learner_version: int,
        timeout: Optional[float] = None,
    ) -> Optional[TrajectoryItem]:
        """Next admitted item, stamped with the learner's version.

        Pops until the admission policy accepts an item; rejected items are
        counted as drops.  Returns None when the queue is closed and
        drained, or when `timeout` elapses with nothing available.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        if self.injector.active:
            with self._cond:
                self._gets += 1
                call = self._gets
            self.injector.stall("queue_get", at_call=call)
        while True:
            with self._cond:
                while not self._dq and not self._closed:
                    if deadline is None:
                        self._cond.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not self._cond.wait(remaining):
                            if not self._dq:
                                return None
                if not self._dq:
                    return None  # closed and drained
                item = self._dq.popleft()
                self._cond.notify_all()
            # Admission runs outside the lock: tv_fn may dispatch a jitted
            # forward pass and must not stall the producer.
            item.learner_version_at_consume = int(learner_version)
            try:
                decision = self.admission.admit(item)
            except Exception as exc:
                # Graceful degradation: a raising controller downgrades
                # the run to plain max_lag admission instead of killing
                # the learner.  Counted + traced so the fallback is a
                # measured event, not a silent behavior change.
                self.registry.counter(
                    "admission_fallback_total",
                    controller=self.admission.name).inc()
                if self.tracer.enabled:
                    self.tracer.instant(
                        "admission_fallback", pid="runtime", tid="queue",
                        controller=self.admission.name, error=repr(exc))
                if not self._fallback_active:
                    self._fallback_active = True
                    import warnings

                    warnings.warn(
                        f"admission controller {self.admission.name!r} "
                        f"raised ({exc!r}); falling back to "
                        f"max_lag:{self._fallback_max_lag}",
                        RuntimeWarning, stacklevel=2)
                decision = self._fallback_admission().admit(item)
            # A decision must say *why* — reasons label the registry
            # counters, so an empty one would silently merge outcomes.
            reason = decision.reason
            if not reason:
                raise ValueError(
                    f"{type(self.admission).__name__} "
                    f"({self.admission.name!r}) returned an "
                    "AdmissionDecision with an empty reason; reasons "
                    "are mandatory (use e.g. 'admit')")
            tr = self.tracer
            with self._cond:
                if not decision.admit:
                    self._dropped += 1
                    self._count_decision("drop", reason)
                    depth = len(self._dq)
                    if tr.enabled:
                        tr.instant(
                            "queue_drop", pid="runtime", tid="queue",
                            reason=reason, lag=item.lag,
                            tv=item.tv if item.tv is not None
                            else decision.tv)
                        tr.counter("queue_depth", pid="runtime",
                                   depth=float(depth))
                    continue
                item.weight = float(decision.weight)
                item.tv = decision.tv
                if decision.weight != 1.0:
                    self._downweighted += 1
                    self._count_decision("downweight", reason)
                else:
                    self._count_decision("admit", reason)
                self._admitted += 1
                self._lag_histogram.record(item.lag)
                depth = len(self._dq)
            if item.meta.get("restart"):
                # First admitted batch from a restarted producer: the
                # recovery lag spike, measured at the gate.
                self.registry.counter("restart_admitted_total").inc()
                if tr.enabled:
                    tr.instant("restart_admitted", pid="runtime",
                               tid="queue", lag=item.lag,
                               lag_oldest=item.lag_oldest,
                               lag_newest=item.lag_newest)
            if tr.enabled:
                tr.instant("queue_pop", pid="runtime", tid="queue",
                           lag=item.lag, weight=item.weight,
                           tv=item.tv)
                tr.counter("queue_depth", pid="runtime",
                           depth=float(depth))
            return item

    # -- introspection -------------------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return len(self._dq)

    def stats(self) -> RuntimeQueueStats:
        with self._cond:
            consumed = self._admitted + self._dropped
            return RuntimeQueueStats(
                depth=len(self._dq),
                puts=self._puts,
                admitted=self._admitted,
                dropped=self._dropped,
                downweighted=self._downweighted,
                admission_drop_rate=(
                    self._dropped / consumed if consumed else 0.0
                ),
                drops_by_reason=self._by_reason("drop"),
                lag_histogram=self._lag_histogram.snapshot(),
                controller=self.admission.name,
                downweights_by_reason=self._by_reason("downweight"),
            )
