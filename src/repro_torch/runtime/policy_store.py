"""Versioned policy store, the publication side of the runtime (port of
``repro.runtime.policy_store``).

A bounded ring of snapshots (``core.policy_lag``) with a monotonic
version counter and per-version metadata.  ``publish`` **copies** the
snapshot into its ring slot, so the learner's later updates never reach
a published version.  Reads hand back views into the ring: a view stays
valid until ``capacity`` further publishes overwrite its slot.

Long-lived readers keep a version's params past that point: a **pin**
(speculative drafts, refcounted) keeps the version readable by ``get``
and resolvable by ``resolve_lagged``, as in the JAX store; a **hold**
(the serve engine's weights) keeps only the params, and is seen by no
other read.  JAX arrays are immutable, so there a reference is enough.
Here ``publish`` copies a pinned or held version out of its slot before
it overwrites the slot, and re-points the tree it handed out at the
copy in place: one params copy, only while a pin or hold outlives its
slot.  That is safe for readers on the publisher's thread only: a
reader on another thread may have taken a leaf's tensor before the
re-point and launch on it after the overwrite (torn weights: some
layers of one version, the rest of the next).

**Readers on another thread** (the threaded regimes' producers) take a
:meth:`snapshot` instead: a private copy of one version, made under the
store's lock, so no publish lands between its first leaf and its last.
A publish never waits on the host.  On CUDA the copy and the ring's
writes may run on different streams, and their order is kept on the
device: each publish records an event on its stream after writing the
slot, and a snapshot's stream waits on the last such event before
copying; each snapshot records an event on its stream after copying,
and a publish's stream waits on the last such event of every reader
stream before it overwrites a slot.  That wait covers the copy (a
params-sized read, ~1.3 ms for qwen2.5-0.5b float32) and the work the
reader queued before it, never the produce step that follows it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.policy_lag import (PolicyBuffer, buffer_init,
                                         buffer_latest, buffer_push,
                                         buffer_sample, buffer_slot)
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.resilience import (NULL_INJECTOR, FaultInjector,
                                    tree_all_finite)
from repro_torch.utils.tree import tree_leaves, tree_map


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
        # version -> [params, refcount].  Pins keep a snapshot readable
        # and resolvable past ring eviction (speculative-decode drafts);
        # holds keep only its params (a serve engine's weights: the JAX
        # engine takes no pin, so a hold changes no read or resolution).
        self._pinned: Dict[int, List[Any]] = {}
        self._held: Dict[int, List[Any]] = {}
        self.injector = injector
        self.guard_finite = bool(guard_finite)
        self.registry = registry
        self._quarantined: set = set()
        self._publish_calls = 0
        # CUDA: the last ring write of each publisher stream and the last
        # snapshot copy of each reader stream, by stream handle.
        self.device = tree_leaves(self._buffer.stacked)[0].device
        self._writes: Dict[int, Any] = {}
        self._reads: Dict[int, Any] = {}
        self._record_locked(self._writes)

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
                self._wait_locked(self._reads)
                if self._buffer.count == self._buffer.capacity:
                    # The ring is full: ``slot`` holds the oldest version.
                    self._keep_evicted_locked(
                        int(self._slot_versions[slot]), slot)
                self._buffer = buffer_push(self._buffer, params)
                self._slot_versions[slot] = self._version
                self._record_locked(self._writes)
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

    def snapshot_state(self) -> Tuple[PolicyBuffer, np.ndarray, int]:
        """Consistent (buffer, slot_versions, latest_version) triple."""
        with self._lock:
            return self._buffer, self._slot_versions.copy(), self._version

    def latest(self) -> Tuple[Any, int]:
        """Newest serveable snapshot: when the newest published version
        is quarantined, the newest good one."""
        with self._lock:
            version = self._latest_serveable_locked()
            if version == self._version:
                return buffer_latest(self._buffer), version
            params = self._resident_locked(version)
            if params is None:
                raise QuarantinedVersionError(
                    f"no serveable snapshot: latest good version "
                    f"{version} is no longer resident")
            return params, version

    def _latest_serveable_locked(self) -> int:
        version = self._version
        while version in self._quarantined and version > 0:
            version -= 1
        return version

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
        """Parameters of ``version``; StaleVersionError once evicted
        (a pinned version stays readable)."""
        with self._lock:
            return self._get_locked(version)

    def _get_locked(self, version: int) -> Any:
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
        """Params of ``version`` if resident (ring or pin); None
        otherwise."""
        if version in self._pinned:
            return self._pinned[version][0]
        for slot in self._resident_slots_locked():
            if int(self._slot_versions[slot]) == version:
                return buffer_slot(self._buffer, slot)
        return None

    @torch.no_grad()
    def _keep_evicted_locked(self, version: int, slot: int) -> None:
        """Before ``slot`` is overwritten: copy it out once when its
        ``version`` is pinned or held, and re-point every tree handed out
        for it at the copy (in place, so their holders see it)."""
        trees = {id(e[0]): e[0] for e in (self._pinned.get(version),
                                          self._held.get(version)) if e}
        if not trees:
            return
        own = tree_map(torch.clone, buffer_slot(self._buffer, slot))
        for tree in trees.values():
            _repoint(tree, own)

    # -- private copies (readers on another thread) ---------------------------

    @torch.no_grad()
    def snapshot(self, version: Optional[int] = None,
                 out: Any = None) -> Tuple[Any, int]:
        """A private copy of ``version``'s params (None: the newest
        serveable one) and that version, for a reader on another thread
        than the publisher: no later publish reaches it.  Copied under
        the store's lock, into ``out`` in place when given (a tree of
        the params' shapes that only the caller reads), else into new
        tensors.  A held version is found too (the serve engine's
        weights, when it leaves its hold)."""
        with self._lock:
            if version is None:
                version = self._latest_serveable_locked()
            held = self._held.get(version)
            src = held[0] if held else self._get_locked(version)
            self._wait_locked(self._writes)
            if out is None:
                out = tree_map(torch.clone, src)
            else:
                tree_map(lambda o, s: o.copy_(s), out, src)
            self._record_locked(self._reads)
        return out, version

    def latest_version(self) -> int:
        """The newest serveable version (what :meth:`latest` would
        return), without touching any params."""
        with self._lock:
            return self._latest_serveable_locked()

    def _record_locked(self, table: Dict[int, Any]) -> None:
        """CUDA: mark the current stream's work so far in ``table``."""
        if self.device.type != "cuda":
            return
        stream = torch.cuda.current_stream(self.device)
        event = torch.cuda.Event()
        event.record(stream)
        table[stream.cuda_stream] = event

    def _wait_locked(self, table: Dict[int, Any]) -> None:
        """CUDA: order the current stream after the other streams' work
        marked in ``table`` (a device-side wait; the host goes on)."""
        if self.device.type != "cuda" or not table:
            return
        stream = torch.cuda.current_stream(self.device)
        for handle, event in table.items():
            if handle != stream.cuda_stream:
                stream.wait_event(event)

    # -- pinning (long-lived readers, e.g. speculative-decode drafts) --------

    def pin(self, version: int) -> Any:
        """Keep ``version``'s parameters readable past ring eviction.

        Refcounted: pin twice, release twice.  The version must be
        resident (ring or an existing pin) when first pinned; the pin
        then keeps it readable by :meth:`get` and resolvable by
        :meth:`resolve_lagged` however many publishes follow.  Returns
        the params."""
        with self._lock:
            params = self._pin_locked(version)
            # Not resident: get()'s error.
            return params if params is not None else self._get_locked(
                version)

    def _pin_locked(self, version: int) -> Optional[Any]:
        entry = self._pinned.get(version)
        if entry is not None:
            entry[1] += 1
        else:
            params = self._resident_locked(version)
            if params is None:
                return None
            held = self._held.get(version)
            # Share a hold's tree, so an eviction copies the slot once.
            entry = self._pinned[version] = [
                held[0] if held else params, 1]
        self._trace_pin(version)
        return entry[0]

    def _trace_pin(self, version: int) -> None:
        tr = self.tracer
        if tr.enabled:
            tr.instant("pin", pid="runtime", tid="store",
                       version=version, lag=self._version - version)

    def release(self, version: int) -> None:
        """Drop one pin on ``version``; its params go once the refcount
        reaches 0 (ring residency is unaffected)."""
        with self._lock:
            _decref(self._pinned, version, "pinned")

    def pinned_versions(self) -> List[int]:
        with self._lock:
            return sorted(self._pinned)

    def _resolve_lagged_locked(self, offset: int) -> int:
        target = self._version + offset
        resident = {int(self._slot_versions[s])
                    for s in self._resident_slots_locked()}
        resident.update(self._pinned)
        resident -= self._quarantined
        if not resident:
            raise QuarantinedVersionError(
                "no serveable snapshot: every resident version is "
                "quarantined")
        older = [v for v in resident if v <= target]
        return max(older) if older else min(resident)

    def resolve_lagged(self, offset: int) -> int:
        """Resident version closest to ``latest + offset`` (offset <= 0):
        the nearest *older* resident one when that exact version was
        evicted, else the oldest resident.  Resident = in the ring or
        pinned.  Callers that go on to pin use :meth:`pin_lagged`."""
        if offset > 0:
            raise ValueError(f"offset must be <= 0, got {offset}")
        with self._lock:
            return self._resolve_lagged_locked(offset)

    def pin_lagged(self, offset: int) -> Tuple[Any, int]:
        """Resolve ``latest + offset`` and pin it in ONE lock hold (a
        publish between the two could evict the resolved version).
        Returns ``(params, version)``."""
        if offset > 0:
            raise ValueError(f"offset must be <= 0, got {offset}")
        with self._lock:
            version = self._resolve_lagged_locked(offset)
            # Resolution returns resident versions only, under this lock.
            return self._pin_locked(version), version

    # -- holds (a serve engine's weights) ------------------------------------

    def hold(self, version: Optional[int] = None) -> Tuple[Any, int]:
        """Keep ``version``'s params (None: the newest serveable one) as
        they are for as long as the hold lasts; returns ``(params,
        version)``.  Refcounted, released by :meth:`unhold`.  Unlike a
        pin, a hold leaves :meth:`get`, :meth:`pinned_versions` and
        lagged resolution as they were."""
        with self._lock:
            if version is None:
                version = self._latest_serveable_locked()
            entry = self._held.get(version)
            if entry is None:
                # Raises get()'s error for a version it cannot serve.
                entry = self._held[version] = [self._get_locked(version), 0]
            entry[1] += 1
            return entry[0], version

    def unhold(self, version: int) -> None:
        with self._lock:
            _decref(self._held, version, "held")

    def meta(self, version: int) -> SnapshotMeta:
        return self._history[version]

    def sample(self, draws: Any, n: int) -> Tuple[Any, np.ndarray]:
        """Uniformly sample ``n`` resident snapshots; returns
        ``(params_batched, versions)``.  ``draws`` supplies the slot
        indices (``rollout.env_rollout.Draws``)."""
        buffer, slot_versions, _ = self.snapshot_state()
        params_b, slots = buffer_sample(buffer, draws, n)
        return params_b, slot_versions[slots.cpu().numpy()]

    def versions_of_slots(self, slots: Any) -> np.ndarray:
        """Map ring slots (as ``buffer_sample`` returns them) to policy
        versions."""
        if isinstance(slots, torch.Tensor):
            slots = slots.cpu().numpy()
        with self._lock:
            return self._slot_versions[np.asarray(slots)]


def _repoint(tree: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Point ``tree``'s leaves at ``src``'s, in place (same structure)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _repoint(v, src[k])
        else:
            tree[k] = src[k]


def _decref(table: Dict[int, List[Any]], version: int, what: str) -> None:
    entry = table.get(version)
    if entry is None:
        raise KeyError(f"version {version} is not {what}")
    entry[1] -= 1
    if entry[1] <= 0:
        del table[version]
