"""Lag regimes (port of ``repro.runtime.regimes`` for the RLVR learner).

``forward_n`` (§5.2): each ``fill()`` freezes ``store.latest()`` and
produces N items from it; the learner then takes N updates, so item k is
consumed with forward lag k (generate-N/train-N).  The threaded,
backward-mixture and engine regimes are not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.runtime.policy_store import PolicyStore
from repro_torch.runtime.queue import TrajectoryQueue


def _stamp_versions(payload: Any, version: int) -> Any:
    """Overwrite a payload's per-token ``versions`` record with the
    version paired with the params the regime handed its producer (the
    regime holds the authoritative ``(params, version)`` pair from one
    ``store.latest()`` call).  Payloads without the field pass through."""
    versions = getattr(payload, "versions", None)
    if versions is not None and hasattr(payload, "_replace"):
        return payload._replace(
            versions=np.full_like(np.asarray(versions), version))
    return payload


class LagRegime:
    """Driver protocol: start() once, next_item() per consume, stop()."""

    name = "base"
    phase_locked = True   # production driven by the consumer, not a thread

    def __init__(self, store: PolicyStore, queue: TrajectoryQueue) -> None:
        self.store = store
        self.queue = queue

    @property
    def tracer(self):
        """The queue's tracer: one trace covers production, queueing and
        consumption."""
        return self.queue.tracer

    def start(self) -> None:
        pass

    def fill(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def next_item(self, learner_version: int, *,
                  timeout: Optional[float] = None, max_refills: int = 50):
        """Next admitted item for the learner.

        Phase-locked regimes produce lazily: when the queue runs dry
        (including after admission drops), ``fill()`` runs again, bounded
        by ``max_refills`` consecutive all-drop rounds.  Returns None when
        starved."""
        if not self.phase_locked:
            return self.queue.get(
                learner_version=learner_version, timeout=timeout)
        for _ in range(max_refills):
            if self.queue.qsize() == 0:
                self.fill()
            item = self.queue.get(
                learner_version=learner_version, timeout=0.001)
            if item is not None:
                return item
        warnings.warn(
            f"{self.name}: admission policy rejected every item across "
            f"{max_refills} production rounds; the learner is starved and "
            "the run will truncate (check the queue's drops_by_reason "
            "stats).", RuntimeWarning, stacklevel=2)
        return None


class ForwardNRegime(LagRegime):
    name = "forward_n"

    def __init__(self, store: PolicyStore, queue: TrajectoryQueue,
                 producer: Callable[[Any], Any], *, n_items: int) -> None:
        super().__init__(store, queue)
        self.producer = producer
        self.n_items = n_items

    def fill(self) -> None:
        params, version = self.store.latest()
        for _ in range(self.n_items):
            with self.tracer.span("produce", pid="runtime",
                                  tid="producer", version=version):
                payload = _stamp_versions(self.producer(params), version)
            self.queue.put(payload, behavior_version=version,
                           learner_version=version)


def make_regime(name: str, store: PolicyStore, queue: TrajectoryQueue,
                producer: Callable, *, forward_n: int = 4) -> LagRegime:
    """Factory used by the trainer (``--runtime``)."""
    if name == "forward_n":
        return ForwardNRegime(store, queue, producer, n_items=forward_n)
    if name in REGIMES:
        raise NotImplementedError(
            f"lag regime {name!r} is not ported to the PyTorch runtime yet")
    raise ValueError(f"unknown lag regime {name!r}")


REGIMES = ("backward_mixture", "forward_n", "threaded", "threaded_engine")
