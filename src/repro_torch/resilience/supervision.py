# Copied from src/repro/resilience/supervision.py; keep the two in step.
"""Supervision for producer threads: heartbeat, bounded restart,
seeded backoff, and finiteness guards.

A producer thread that dies silently starves the queue — the trainer
just blocks on ``get`` until its timeout.  :func:`supervise` wraps the
producer loop body so a crash becomes a *measured* event instead: the
watchdog logs it, sleeps a deterministic exponential-backoff delay
(with seeded jitter so CI replays exactly), and restarts the loop up
to ``max_restarts`` times.  Restart context is handed to the loop via
:class:`RestartContext` so the producer can re-pin the *current* store
version and stamp a ``restart`` provenance flag on its first batches —
the recovery then hits admission as a measured lag spike rather than
bypassing the gate.

Finiteness guards (:func:`tree_all_finite`) back the quarantine path:
a non-finite publish or learner step is caught before it can poison
every actor at the next weight swap.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves

__all__ = [
    "BackoffPolicy",
    "Heartbeat",
    "RestartContext",
    "SupervisionError",
    "supervise",
    "tree_all_finite",
]


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff with deterministic seeded jitter.

    ``delay_s(attempt)`` is a pure function of ``(policy, attempt)``:
    the jitter for attempt *i* is drawn from ``RandomState(seed)``
    advanced exactly *i* steps, so two policies with equal fields
    produce bit-identical schedules (the determinism contract tested
    in ``tests/test_resilience.py``, which ``tests/test_torch_resilience.py``
    holds the port to).
    """

    base_ms: float = 50.0
    factor: float = 2.0
    max_ms: float = 2000.0
    jitter: float = 0.25
    max_restarts: int = 3
    seed: int = 0

    def delay_s(self, attempt: int) -> float:
        if attempt < 0:
            raise ValueError("attempt must be >= 0")
        ms = min(self.max_ms, self.base_ms * self.factor ** attempt)
        if self.jitter > 0.0:
            rng = np.random.RandomState(self.seed)
            u = rng.random_sample(attempt + 1)[-1]  # i-th draw, reproducible
            ms *= 1.0 + self.jitter * u
        return float(ms) / 1e3

    def schedule(self) -> List[float]:
        """The full restart-delay schedule in seconds."""
        return [self.delay_s(i) for i in range(self.max_restarts)]


@dataclasses.dataclass
class RestartContext:
    """Handed to a supervised loop body on (re)entry.

    ``attempt`` is 0 on the first run and *n* after the *n*-th
    restart.  ``last_error`` is the exception that killed the previous
    incarnation.  The loop body should treat ``attempt > 0`` as "I am
    a restarted producer": re-pin the current store version and stamp
    ``restart=True`` provenance on the first item it publishes.
    """

    attempt: int = 0
    last_error: Optional[BaseException] = None


class SupervisionError(RuntimeError):
    """Producer exceeded its restart budget; carries the final error."""

    def __init__(self, name: str, restarts: int,
                 last_error: BaseException) -> None:
        super().__init__(
            f"supervised producer {name!r} exceeded restart budget "
            f"({restarts} restarts); last error: {last_error!r}")
        self.restarts = restarts
        self.last_error = last_error


def supervise(
    run: Callable[[RestartContext], None],
    *,
    policy: BackoffPolicy,
    name: str = "producer",
    should_stop: Callable[[], bool] = lambda: False,
    clean_exits: tuple = (),
    registry: Optional[Any] = None,
    tracer: Optional[Any] = None,
    sleep: Callable[[float], None] = time.sleep,
    heartbeat: Optional["Heartbeat"] = None,
) -> int:
    """Run ``run(ctx)`` under watchdog supervision; returns the number
    of restarts consumed.

    ``run`` returning normally — or raising one of ``clean_exits``
    (e.g. ``QueueClosed``) — ends supervision.  Any other exception
    consumes one restart: the watchdog emits a ``watchdog_restart``
    trace instant + ``watchdog_restart_total`` counter, sleeps the
    seeded backoff delay (checking ``should_stop`` so shutdown is not
    held hostage to a long backoff), and re-enters the loop with an
    incremented :class:`RestartContext`.  Exceeding ``max_restarts``
    raises :class:`SupervisionError`.
    """
    attempt = 0
    last_error: Optional[BaseException] = None
    while not should_stop():
        ctx = RestartContext(attempt=attempt, last_error=last_error)
        try:
            if heartbeat is not None:
                heartbeat.beat()
            run(ctx)
            return attempt
        except clean_exits:
            return attempt
        except BaseException as exc:  # noqa: BLE001 - supervision boundary
            last_error = exc
            if attempt >= policy.max_restarts:
                raise SupervisionError(name, attempt, exc) from exc
            delay = policy.delay_s(attempt)
            attempt += 1
            if registry is not None:
                registry.counter(
                    "watchdog_restart_total", producer=name).inc()
            if tracer is not None:
                tracer.instant(
                    "watchdog_restart", pid="resilience", tid=name,
                    attempt=attempt, delay_s=round(delay, 6),
                    error=repr(exc))
            # interruptible backoff: never outlive a stop request
            deadline = time.monotonic() + delay
            while not should_stop():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                sleep(min(remaining, 0.05))
    return attempt


class Heartbeat:
    """A timestamped liveness marker a watchdog thread can poll.

    Producers call :meth:`beat` each loop iteration; anyone holding a
    reference can ask :meth:`stale` whether the producer has been
    silent for longer than ``timeout_s`` (a straggler detector — used
    by the chaos bench to prove stalls are *visible*, not fatal).
    """

    def __init__(self, timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.timeout_s = float(timeout_s)
        self._clock = clock
        self._last = clock()
        self._beats = 0
        self._lock = threading.Lock()

    def beat(self) -> None:
        with self._lock:
            self._last = self._clock()
            self._beats += 1

    @property
    def beats(self) -> int:
        with self._lock:
            return self._beats

    def age_s(self) -> float:
        with self._lock:
            return self._clock() - self._last

    def stale(self) -> bool:
        return self.age_s() > self.timeout_s


def tree_all_finite(tree: Any) -> bool:
    """True iff every floating-point leaf of the tree is fully finite
    (one host sync for the whole tree)."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(tree)
             if torch.is_tensor(x) and x.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack(flags).all())
