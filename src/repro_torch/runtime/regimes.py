"""Lag regimes (port of ``repro.runtime.regimes``): four drivers of one
``PolicyStore``/``TrajectoryQueue`` runtime.

* ``backward_mixture`` (§5.1 / Fig. 1 left): each ``fill()`` samples one
  stale snapshot per actor from the store's ring and produces a single
  mixture rollout (the episodic mixture behavior policy of Eq. 1).
* ``forward_n`` (§5.2): each ``fill()`` freezes ``store.latest()`` and
  produces N items from it; the learner then takes N updates, so item k
  is consumed with forward lag k (generate-N/train-N).
* ``threaded``: a producer thread generates from the newest snapshot
  while the learner consumes; lag comes from timing, not a schedule.
  The bounded queue gives backpressure.
* ``threaded_engine``: the producer thread drives a ``ServeEngine``
  whose in-flight swaps let one trajectory span learner publishes.

Producers are plain callables, so the same regimes drive classic-RL env
rollouts and RLVR generation.  ``MixtureRolloutProducer`` is the legacy
``SimulatedAsyncActors``'s collect; ``FrozenRolloutProducer`` is its
single-policy counterpart for ``forward_n`` and ``threaded``.  Each runs
on ``cuda`` unless the caller passes ``device="cpu"``.

**The producer thread and the device.**  The store's ring is written in
place, so the threaded producers never read it directly: each produced
item (and each engine swap) starts from ``PolicyStore.snapshot``, a
private copy of one version taken under the store's lock, which no later
publish reaches (no torn weights).  On CUDA the thread runs on a stream
of its own, so its kernels overlap the learner's on the card:

* the thread's stream first waits on the stream that called ``start``
  (whatever was built there, an engine's KV pool, is ready); an env
  producer makes its env states at its first call, on the thread, so
  the thread's stream owns them;
* the snapshot and the publishes order themselves by events
  (``PolicyStore``), on the device, without a host wait;
* an item crosses the queue complete: the thread waits for its own
  stream before ``put``, and marks every tensor of the item as used by
  the consumer's stream (``record_stream``), so the caching allocator
  does not hand the memory back to the producer while the learner still
  reads it;
* ``stop`` joins the thread and waits for its stream, so anything the
  thread used may be freed after it.

Random draws: the producer's chain (``Draws``, the engine's generator)
is used by the producer thread alone, and the learner keeps its own.

Producer supervision (``supervisor=``) is not ported yet (Queue A 6);
``_restart_meta`` and the restart floor, which only supervision
triggers, are.
"""
from __future__ import annotations

import threading
import warnings
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.policy_lag import PolicyBuffer, buffer_sample
from repro_torch.envs.base import Env
from repro_torch.resilience import (NULL_INJECTOR, FaultInjector,
                                    RestartContext)
from repro_torch.rollout.env_rollout import (Draws, collect_rollout,
                                             default_draws, init_env_states)
from repro_torch.runtime.policy_store import PolicyStore
from repro_torch.runtime.queue import QueueClosed, TrajectoryQueue
from repro_torch.serve.engine import resolve_device
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Producers (classic RL).  The RLVR producer is ForwardLagGenerator.
# ---------------------------------------------------------------------------


class _RolloutProducer:
    """Shared scaffolding for env-rollout producers: one chain of draws
    (whose first split seeds the env states, as the JAX producer's first
    key does) and persistent env states.

    ``device`` is ``cuda`` unless the caller asks for the CPU; ``draws``
    replaces the default ``torch.Generator`` chain seeded with ``seed``
    on it (tests replay the JAX key chain through it).  The env states
    are made at the first call, on the thread that produces.
    Subclasses define ``_collect(policy_source, env_states, draws) ->
    (env_states, *outputs)``."""

    def __init__(
        self,
        env: Env,
        policy_apply: Callable,
        *,
        n_actors: int,
        rollout_steps: int,
        seed: int = 0,
        device: Any = None,
        draws: Optional[Draws] = None,
    ) -> None:
        self.env = env
        self.policy_apply = policy_apply
        self.n_actors = n_actors
        self.rollout_steps = rollout_steps
        self.device = resolve_device(device)
        self._draws = draws if draws is not None else default_draws(
            seed, self.device)
        self._env_states = None

    def _collect(self, policy_source: Any, env_states: Any, draws: Draws):
        raise NotImplementedError

    def _next_draws(self) -> Draws:
        self._draws, d = self._draws.split(2)
        return d

    def __call__(self, policy_source: Any):
        if self._env_states is None:
            # The chain's first split, as the JAX producer's first key.
            self._env_states = init_env_states(
                self.env, self._next_draws(), self.n_actors)
        self._env_states, *outputs = self._collect(
            policy_source, self._env_states, self._next_draws())
        return outputs[0] if len(outputs) == 1 else tuple(outputs)


class MixtureRolloutProducer(_RolloutProducer):
    """Vectorized env rollout with per-actor policies from a snapshot ring.

    ``producer(buffer) -> (RolloutBatch, slots)``.  The per-actor params
    are gathered (a copy) before the rollout starts, so a publish after
    it cannot reach them."""

    def _collect(self, buffer: PolicyBuffer, env_states, draws):
        d_sample, d_roll = draws.split(2)
        actor_params, slots = buffer_sample(buffer, d_sample, self.n_actors)
        env_states, batch = collect_rollout(
            self.env, self.policy_apply, actor_params, env_states, d_roll,
            self.rollout_steps)
        return env_states, batch, slots


class FrozenRolloutProducer(_RolloutProducer):
    """Env rollout where every actor runs one frozen policy.

    ``producer(params) -> RolloutBatch``, for the forward_n and threaded
    regimes, where lag comes from the schedule or the timing rather than
    a snapshot mixture."""

    def _collect(self, params, env_states, draws):
        n = self.n_actors
        stacked = tree_map(lambda x: x[None].expand(n, *x.shape), params)
        return collect_rollout(self.env, self.policy_apply, stacked,
                               env_states, draws, self.rollout_steps)


# ---------------------------------------------------------------------------
# Regimes
# ---------------------------------------------------------------------------


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


class BackwardMixtureRegime(LagRegime):
    name = "backward_mixture"

    def __init__(self, store: PolicyStore, queue: TrajectoryQueue,
                 producer: Callable[[PolicyBuffer], Any]) -> None:
        super().__init__(store, queue)
        self.producer = producer

    def fill(self) -> None:
        buffer, slot_versions, learner_version = self.store.snapshot_state()
        with self.tracer.span("produce", pid="runtime", tid="producer"):
            payload, slots = self.producer(buffer)
            # The host read waits for the rollout on the device.
            versions = slot_versions[slots.cpu().numpy()]
        # A mixture item's representative version is its *oldest* policy
        # (conservative for max-lag admission); the full per-actor version
        # vector rides along for lag diagnostics.
        self.queue.put(
            payload,
            behavior_version=int(versions.min()),
            learner_version=learner_version,
            behavior_version_newest=int(versions.max()),
            behavior_versions=versions.tolist(),
        )


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


# ---------------------------------------------------------------------------
# Threaded regimes
# ---------------------------------------------------------------------------


def _refuse_supervisor(supervisor: Any) -> None:
    if supervisor is not None:
        raise NotImplementedError(
            "producer supervision is not ported to the PyTorch runtime yet "
            "(Queue A 6)")


def _record_stream(payload: Any, stream: Any) -> None:
    """Mark every tensor in ``payload`` (nested tuples, lists, dicts) as
    used by ``stream``."""
    if isinstance(payload, torch.Tensor):
        if payload.is_cuda:
            payload.record_stream(stream)
    elif isinstance(payload, dict):
        for v in payload.values():
            _record_stream(v, stream)
    elif isinstance(payload, (tuple, list)):
        for v in payload:
            _record_stream(v, stream)


class ThreadedProduction:
    """A producer thread for a regime: ``start``/``stop``, the queue
    closed when production ends, a crash kept and re-raised by
    ``next_item``, and the thread's CUDA stream (module docstring).
    Subclasses define ``_run(ctx)``; ``_hand_over`` finishes an item
    before it is put."""

    thread_name = "runtime-producer"

    def _init_thread(self, max_items: Optional[int]) -> None:
        self.max_items = max_items
        self.produced = 0
        self.restarts = 0
        self.error: Optional[BaseException] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stream = self._consumer = None
        self._version_at_crash: Optional[int] = None
        self._restart_floor: Optional[int] = None

    def start(self) -> None:
        device = self.store.device
        if device.type == "cuda":
            self._consumer = torch.cuda.current_stream(device)
            self._stream = torch.cuda.Stream(device)
            self._stream.wait_stream(self._consumer)
        self._thread = threading.Thread(
            target=self._loop, name=self.thread_name, daemon=True)
        self._thread.start()

    def _before_run(self) -> None:
        """On the thread, on its stream, before the first item."""

    def _hand_over(self, payload: Any) -> Any:
        """An item, complete on the device and usable by the consumer's
        stream."""
        if self._stream is not None:
            self._stream.synchronize()
            _record_stream(payload, self._consumer)
        return payload

    def _loop(self) -> None:
        try:
            with torch.cuda.stream(self._stream):
                self._before_run()
                self._run(RestartContext())
        except BaseException as e:   # surface producer crashes, don't hang
            self.error = e
        finally:
            # End of production (finite run, stop, or crash): the learner
            # drains what is left, then get() returns None at once.
            self.queue.close()

    def next_item(self, learner_version, *, timeout=None, max_refills=50):
        item = LagRegime.next_item(self, learner_version, timeout=timeout,
                                   max_refills=max_refills)
        if item is None and self.error is not None:
            raise RuntimeError(
                f"{self.name} producer crashed") from self.error
        return item

    def stop(self, join_timeout: float = 30.0) -> None:
        self._stop_event.set()
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
        if self._stream is not None:
            self._stream.synchronize()

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


class ThreadedRegime(ThreadedProduction, LagRegime):
    """Real producer thread: generate from the newest snapshot while the
    learner consumes.  ``fill()`` is a no-op: production is continuous.
    Each item is produced from ``store.snapshot()``, a private copy of
    the newest version, and stamped with that version."""

    name = "threaded"
    phase_locked = False

    def __init__(
        self,
        store: PolicyStore,
        queue: TrajectoryQueue,
        producer: Callable[[Any], Any],
        *,
        max_items: Optional[int] = None,
        injector: FaultInjector = NULL_INJECTOR,
        supervisor: Any = None,
    ) -> None:
        _refuse_supervisor(supervisor)
        super().__init__(store, queue)
        self.producer = producer
        self.injector = injector
        self._init_thread(max_items)

    def _restart_meta(self, ctx: RestartContext, version: int) -> tuple:
        """(behavior_version_oldest, meta) for the first item a restarted
        incarnation publishes: conservative provenance spanning the
        outage, so span-aware admission sees the true worst case."""
        oldest = version
        meta = {}
        if ctx.attempt > 0:
            meta = {"restart": True, "restart_attempt": ctx.attempt}
            if self._restart_floor is not None:
                oldest = min(self._restart_floor, version)
                self._restart_floor = None
        return oldest, meta

    def _run(self, ctx: RestartContext) -> None:
        restart_pending = ctx.attempt > 0
        if restart_pending:
            # The crash-time version, before the loop overwrites it.
            self._restart_floor = self._version_at_crash
        while not self._stop_event.is_set() and (
            self.max_items is None or self.produced < self.max_items
        ):
            # A restarted incarnation takes whatever is newest *now*.
            params, version = self.store.snapshot()
            self._version_at_crash = version
            self.injector.crash_if(
                "producer", at_step=self.produced, producer=self.name)
            with self.tracer.span("produce", pid="runtime",
                                  tid="producer", version=version):
                payload = self._hand_over(_stamp_versions(
                    self.producer(params), version))
            del params
            oldest, meta = (
                self._restart_meta(ctx, version)
                if restart_pending else (version, {}))
            try:
                self.queue.put(
                    payload,
                    behavior_version=oldest,
                    learner_version=self.store.version,
                    behavior_version_newest=(
                        version if oldest != version else None),
                    **meta,
                )
            except QueueClosed:
                break
            restart_pending = False
            self.produced += 1


class EngineThreadedRegime(ThreadedRegime):
    """Producer thread driving a continuous-batching ServeEngine.

    The plain :class:`ThreadedRegime` takes one snapshot per produced
    item, so a trajectory is homogeneous in its behavior policy.  Here
    the *engine* swaps weights between rounds, so one trajectory can
    span learner publishes: the intra-trajectory lag the tokenwise TV
    gate is built for.  Each queue item is one ``ServedTrajectory``; its
    ``behavior_version`` is the trajectory's *oldest* token version and
    the per-token versions ride in ``meta``.  The engine generates from
    private copies (``ServeEngine.use_private_weights``).

    ``request_fn() -> (prompt, max_new_tokens) | None`` feeds the engine;
    None means the request stream is exhausted.  The thread keeps ~2
    batches of requests in flight so a freed slot always has a
    candidate."""

    name = "threaded_engine"
    phase_locked = False
    thread_name = "engine-producer"

    def __init__(
        self,
        store: PolicyStore,
        queue: TrajectoryQueue,
        engine: Any,              # serve.ServeEngine bound to `store`
        *,
        request_fn: Callable[[], Optional[tuple]],
        max_items: Optional[int] = None,
        injector: FaultInjector = NULL_INJECTOR,
        supervisor: Any = None,
    ) -> None:
        if engine.store is not store:
            raise ValueError(
                "engine must share the regime's PolicyStore (its "
                "in-flight swaps are how learner publishes reach the "
                "actor)")
        super().__init__(store, queue, producer=None, max_items=max_items,
                         injector=injector, supervisor=supervisor)
        self.engine = engine
        self.request_fn = request_fn
        self._source_dry = False

    def _backlog(self) -> int:
        sched = self.engine.scheduler
        return len(sched.waiting) + len(sched.running)

    def _feed(self) -> None:
        target = 2 * self.engine.max_batch
        while not self._source_dry and self._backlog() < target:
            item = self.request_fn()
            if item is None:
                self._source_dry = True
                return
            prompt, max_new_tokens = item
            self.engine.submit(prompt, max_new_tokens)

    def _before_run(self) -> None:
        self.engine.use_private_weights()

    def _run(self, ctx: RestartContext) -> None:
        restart_pending = ctx.attempt > 0
        if restart_pending:
            # The current store version for new tokens; the in-flight
            # requests keep their stale provenance (the recovery spike).
            self.engine.set_version(self.store.latest_version())
        while not self._stop_event.is_set() and (
            self.max_items is None or self.produced < self.max_items
        ):
            self.injector.crash_if(
                "producer", at_step=self.produced, producer=self.name)
            self._feed()
            if not self.engine.has_work:
                break    # stream dry and everything drained
            for traj in self.engine.step():
                self._version_at_crash = int(traj.behavior_version)
                meta = {}
                if restart_pending:
                    meta = {"restart": True,
                            "restart_attempt": ctx.attempt}
                try:
                    self.queue.put(
                        traj,
                        behavior_version=traj.behavior_version,
                        learner_version=self.store.version,
                        behavior_version_newest=int(
                            traj.versions.max()
                        ) if traj.versions.size else None,
                        versions=traj.versions.tolist(),
                        request_id=traj.request_id,
                        finish_reason=traj.finish_reason,
                        **meta,
                    )
                except QueueClosed:
                    return
                restart_pending = False
                self.produced += 1


def make_regime(
    name: str,
    store: PolicyStore,
    queue: TrajectoryQueue,
    producer: Callable,
    *,
    forward_n: int = 4,
    max_items: Optional[int] = None,
    engine: Any = None,
    injector: FaultInjector = NULL_INJECTOR,
    supervisor: Any = None,
) -> LagRegime:
    """Factory used by the trainers, runners and launchers (``--runtime``).

    For ``threaded_engine``, ``producer`` is the request source
    (``request_fn``) and ``engine`` the ServeEngine bound to ``store``.
    ``max_items``, ``injector`` and ``supervisor`` apply to the threaded
    regimes only; ``supervisor`` is not ported yet and raises."""
    if name == "backward_mixture":
        return BackwardMixtureRegime(store, queue, producer)
    if name == "forward_n":
        return ForwardNRegime(store, queue, producer, n_items=forward_n)
    if name == "threaded":
        return ThreadedRegime(store, queue, producer, max_items=max_items,
                              injector=injector, supervisor=supervisor)
    if name == "threaded_engine":
        if engine is None:
            raise ValueError("threaded_engine regime requires engine=")
        return EngineThreadedRegime(
            store, queue, engine, request_fn=producer, max_items=max_items,
            injector=injector, supervisor=supervisor)
    raise ValueError(f"unknown lag regime {name!r}")


REGIMES = ("backward_mixture", "forward_n", "threaded", "threaded_engine")
