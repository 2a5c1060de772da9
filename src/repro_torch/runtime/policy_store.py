"""Versioned policy store, the publication side of the runtime (port of
``repro.runtime.policy_store`` for the forward-lag learner).

A bounded ring of snapshots (``core.policy_lag``) with a monotonic
version counter and per-version metadata.  ``publish`` **copies** the
snapshot into its ring slot, so the learner's later updates never reach
a published version.  Reads hand back views into the ring: a view stays
valid until ``capacity`` further publishes overwrite its slot.

Ported: publish (with the finiteness quarantine), quarantine, latest,
get, retained versions and metadata.  Pinning and lagged resolution
(speculative drafts, the serve producer) and sharded placement come with
a later slice.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.policy_lag import (PolicyBuffer, buffer_init,
                                         buffer_latest, buffer_push,
                                         buffer_slot)
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.resilience import (NULL_INJECTOR, FaultInjector,
                                    tree_all_finite)


@dataclass(frozen=True)
class SnapshotMeta:
    """Per-version bookkeeping (kept even after the params are evicted)."""

    version: int
    wall_time: float
    meta: Dict[str, Any] = field(default_factory=dict)


class StaleVersionError(KeyError):
    """Requested a version whose parameters were evicted from the ring."""


class QuarantinedVersionError(KeyError):
    """Requested a version that was quarantined (non-finite publish)."""


class PolicyStore:
    """Bounded ring of policy snapshots with monotonic versioning."""

    def __init__(
        self,
        init_params: Any,
        capacity: int,
        meta: Optional[Dict[str, Any]] = None,
        tracer: Tracer = NULL_TRACER,
        injector: FaultInjector = NULL_INJECTOR,
        guard_finite: bool = False,
        registry: Any = None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.tracer = tracer
        self._lock = threading.Lock()
        self._buffer: PolicyBuffer = buffer_init(init_params, capacity)
        self._version = 0
        # buffer_init marks the initial policy valid at slot capacity-1
        # (head=0, count=1 => age-order slot (head-count)%cap).
        self._slot_versions = np.zeros(capacity, dtype=np.int64)
        self._history: Dict[int, SnapshotMeta] = {
            0: SnapshotMeta(0, time.time(), dict(meta or {}))
        }
        self.injector = injector
        self.guard_finite = bool(guard_finite)
        self.registry = registry
        self._quarantined: set = set()
        self._publish_calls = 0

    # -- publication ---------------------------------------------------------

    def publish(self, params: Any, **meta: Any) -> int:
        """Copy a new snapshot into the ring; returns its version.

        With ``guard_finite`` on, a snapshot with any non-finite leaf is
        quarantined instead: it takes a version number and a history
        entry (``quarantined=True``) but never enters the ring."""
        with self._lock:
            self._publish_calls += 1
            calls, provisional = self._publish_calls, self._version + 1
        params, poisoned = self.injector.poison(
            "publish", params, at_publish=calls, version=provisional)
        quarantine = self.guard_finite and not tree_all_finite(params)
        with self._lock:
            self._version += 1
            version = self._version
            if quarantine:
                self._quarantined.add(version)
                meta = dict(meta, quarantined=True, poisoned=poisoned)
            else:
                slot = self._buffer.head
                self._buffer = buffer_push(self._buffer, params)
                self._slot_versions[slot] = self._version
            self._history[version] = SnapshotMeta(
                version, time.time(), dict(meta))
        tr = self.tracer
        if quarantine:
            if self.registry is not None:
                self.registry.counter("publish_quarantined_total").inc()
            if tr.enabled:
                tr.instant("publish_quarantine", pid="runtime", tid="store",
                           version=version, poisoned=poisoned)
            return version
        if tr.enabled:
            tr.instant("publish", pid="runtime", tid="store",
                       version=version)
            tr.counter("policy_version", pid="runtime",
                       version=float(version))
        return version

    # -- quarantine ----------------------------------------------------------

    def quarantine(self, version: int) -> None:
        """Mark ``version`` unserveable: excluded from ``latest()``, and
        ``get()`` raises."""
        with self._lock:
            if version not in self._history:
                raise KeyError(f"version {version} was never published")
            self._quarantined.add(version)
        if self.registry is not None:
            self.registry.counter("publish_quarantined_total").inc()
        if self.tracer.enabled:
            self.tracer.instant("publish_quarantine", pid="runtime",
                                tid="store", version=version)

    def is_quarantined(self, version: int) -> bool:
        with self._lock:
            return version in self._quarantined

    def quarantined_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._quarantined)

    # -- reads ---------------------------------------------------------------

    @property
    def version(self) -> int:
        """Latest published version (0 is the init policy)."""
        return self._version

    @property
    def capacity(self) -> int:
        return self._buffer.capacity

    @property
    def buffer(self) -> PolicyBuffer:
        return self._buffer

    def latest(self) -> Tuple[Any, int]:
        """Newest serveable snapshot: when the newest published version
        is quarantined, the newest good one."""
        with self._lock:
            version = self._version
            while version in self._quarantined and version > 0:
                version -= 1
            if version == self._version:
                return buffer_latest(self._buffer), version
            params = self._resident_locked(version)
            if params is None:
                raise QuarantinedVersionError(
                    f"no serveable snapshot: latest good version "
                    f"{version} is no longer resident")
            return params, version

    def _resident_slots_locked(self) -> List[int]:
        cap, head, count = (self._buffer.capacity, self._buffer.head,
                            self._buffer.count)
        return [(head - count + j) % cap for j in range(count)]

    def retained_versions(self) -> List[int]:
        """Versions whose parameters are still resident, oldest first."""
        with self._lock:
            return [int(self._slot_versions[s])
                    for s in self._resident_slots_locked()]

    def get(self, version: int) -> Any:
        """Parameters of ``version``; StaleVersionError once evicted."""
        with self._lock:
            if version in self._quarantined:
                raise QuarantinedVersionError(
                    f"version {version} is quarantined (non-finite "
                    "publish); it cannot be served")
            params = self._resident_locked(version)
            if params is not None:
                return params
        if version in self._history:
            raise StaleVersionError(
                f"version {version} was evicted from the ring "
                f"(capacity {self.capacity}, latest {self._version})")
        raise KeyError(f"version {version} was never published")

    def _resident_locked(self, version: int) -> Optional[Any]:
        for slot in self._resident_slots_locked():
            if int(self._slot_versions[slot]) == version:
                return buffer_slot(self._buffer, slot)
        return None

    def meta(self, version: int) -> SnapshotMeta:
        return self._history[version]
