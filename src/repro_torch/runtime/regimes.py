"""Lag regimes (port of ``repro.runtime.regimes``): schedules of one
``PolicyStore``/``TrajectoryQueue`` runtime.

* ``backward_mixture`` (§5.1 / Fig. 1 left): each ``fill()`` samples one
  stale snapshot per actor from the store's ring and produces a single
  mixture rollout (the episodic mixture behavior policy of Eq. 1).
* ``forward_n`` (§5.2): each ``fill()`` freezes ``store.latest()`` and
  produces N items from it; the learner then takes N updates, so item k
  is consumed with forward lag k (generate-N/train-N).

Producers are plain callables, so the same regimes drive classic-RL env
rollouts and RLVR generation.  ``MixtureRolloutProducer`` is the legacy
``SimulatedAsyncActors``'s collect; ``FrozenRolloutProducer`` is its
single-policy counterpart for ``forward_n``.  The threaded and engine
regimes are not ported yet.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.policy_lag import PolicyBuffer, buffer_sample
from repro_torch.envs.base import Env
from repro_torch.rollout.env_rollout import (Draws, collect_rollout,
                                             default_draws, init_env_states)
from repro_torch.runtime.policy_store import PolicyStore
from repro_torch.runtime.queue import TrajectoryQueue
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# Producers (classic RL).  The RLVR producer is ForwardLagGenerator.
# ---------------------------------------------------------------------------


class _RolloutProducer:
    """Shared scaffolding for env-rollout producers: one chain of draws
    (whose first split seeds the env states, as the JAX producer's first
    key does) and persistent env states.

    ``draws`` replaces the default ``torch.Generator`` chain seeded with
    ``seed`` on ``device`` (tests replay the JAX key chain through it).
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
        device: Any = "cpu",
        draws: Optional[Draws] = None,
    ) -> None:
        self.env = env
        self.policy_apply = policy_apply
        self.n_actors = n_actors
        self.rollout_steps = rollout_steps
        self._draws = draws if draws is not None else default_draws(
            seed, device)
        self._env_states = init_env_states(env, self._next_draws(), n_actors)

    def _collect(self, policy_source: Any, env_states: Any, draws: Draws):
        raise NotImplementedError

    def _next_draws(self) -> Draws:
        self._draws, d = self._draws.split(2)
        return d

    def __call__(self, policy_source: Any):
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

    ``producer(params) -> RolloutBatch``, for the forward_n regime, where
    lag comes from the schedule rather than a snapshot mixture."""

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


def make_regime(name: str, store: PolicyStore, queue: TrajectoryQueue,
                producer: Callable, *, forward_n: int = 4) -> LagRegime:
    """Factory used by the trainers and runners (``--runtime``)."""
    if name == "backward_mixture":
        return BackwardMixtureRegime(store, queue, producer)
    if name == "forward_n":
        return ForwardNRegime(store, queue, producer, n_items=forward_n)
    if name in REGIMES:
        raise NotImplementedError(
            f"lag regime {name!r} is not ported to the PyTorch runtime yet")
    raise ValueError(f"unknown lag regime {name!r}")


REGIMES = ("backward_mixture", "forward_n", "threaded", "threaded_engine")
