"""Fault injection + supervision for the async runtime (port of
``repro.resilience``).

``faults`` — deterministic, seed-driven :class:`FaultInjector` driven
by ``"kind:key=val,...;kind:..."`` plan strings, with hooks threaded
through the producer regimes, ``PolicyStore.publish``,
``TrajectoryQueue`` and the ``ServeEngine`` decode loop.

``supervision`` — watchdog/restart for producer threads (bounded
retries, seeded exponential backoff with jitter, restart provenance),
plus the finiteness guard backing publish/learner-step quarantine.
"""
from repro_torch.resilience.faults import (
    FaultEvent,
    FaultInjector,
    InjectedFault,
    NULL_INJECTOR,
    parse_fault_plan,
)
from repro_torch.resilience.signals import install_flush_handlers
from repro_torch.resilience.supervision import (
    BackoffPolicy,
    Heartbeat,
    RestartContext,
    SupervisionError,
    supervise,
    tree_all_finite,
)

__all__ = [
    "BackoffPolicy",
    "FaultEvent",
    "FaultInjector",
    "Heartbeat",
    "InjectedFault",
    "NULL_INJECTOR",
    "install_flush_handlers",
    "RestartContext",
    "SupervisionError",
    "parse_fault_plan",
    "supervise",
    "tree_all_finite",
]
