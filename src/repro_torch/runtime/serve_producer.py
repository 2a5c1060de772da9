"""ServeRolloutProducer: the ServeEngine as the RLVR trainer's producer
(port of ``repro.runtime.serve_producer``, the phase-locked mode).

Instead of the static ``ForwardLagGenerator``, rollout generation goes
through the serve path (continuous batching over a paged KV cache and
in-flight weight swaps), and the engine's exact per-token ``{version,
log_beta}`` provenance flows straight into the trajectory queue, where
the lag controllers consume it.

One produced item is one ``RLVRMinibatch`` (the legacy generator's
payload, so the trainer and controllers do not care which produced it):
``prompts_per_minibatch`` problems are sampled, each submitted
``completions_per_prompt`` times (contiguous GRPO groups), the engine is
stepped until every request retires, and the retired trajectories are
reassembled into the fixed-shape ``[B, P+N]`` batch the update consumes.

**Padding discipline (correctness-critical):** the engine is handed the
*full left-padded* prompt row, exactly as ``sampler.generate`` sees it:
pad tokens are attended in the causal mask, so stripping them would make
the engine's ``log_beta`` disagree with ``score_tokens``'s ``log_pi`` on
the same weights.  With the padded prompt the realignment ratio is 1 for
fresh data, which the TV gate's calibration assumes.

Two modes:

* **phase-locked** (default): ``fill()`` produces one minibatch
  synchronously, deterministic at a fixed seed.  ``version_offset=k``
  makes the engine generate from the learner's ``k``-back snapshot
  (clamped to what the store still holds), an exact, scripted lag with
  real engine provenance.
* **threaded**: a producer thread keeps generating while the learner
  consumes, from the freshest weights the engine swaps in (or, with
  ``version_offset``, the k-back version taken before each minibatch);
  lag comes from real timing.  The engine generates from private copies
  of the store's versions and the thread runs on a CUDA stream of its
  own (``runtime.regimes``, "The producer thread and the device").

Producer supervision (``supervisor=``, Queue A 6) is not ported yet.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.data.mathgen import verify
from repro_torch.data.tokenizer import PAD
from repro_torch.resilience import (NULL_INJECTOR, FaultInjector,
                                    RestartContext)
from repro_torch.runtime.policy_store import PolicyStore
from repro_torch.runtime.queue import QueueClosed, TrajectoryQueue
from repro_torch.runtime.regimes import (LagRegime, ThreadedProduction,
                                         _refuse_supervisor)


class ServeRolloutProducer(ThreadedProduction, LagRegime):
    """Drive RLVR generation through a continuous-batching ServeEngine."""

    name = "serve"
    thread_name = "serve-producer"

    def __init__(
        self,
        store: PolicyStore,
        queue: TrajectoryQueue,
        engine: Any,              # serve.ServeEngine bound to `store`
        dataset: Any,             # data.mathgen.MathTaskDataset
        *,
        prompts_per_minibatch: int,
        completions_per_prompt: int,
        max_new_tokens: int,
        version_offset: Optional[int] = None,
        threaded: bool = False,
        max_items: Optional[int] = None,
        injector: FaultInjector = NULL_INJECTOR,
        supervisor: Any = None,
    ) -> None:
        _refuse_supervisor(supervisor)
        if engine.store is not store:
            raise ValueError(
                "engine must share the producer's PolicyStore (weight "
                "swaps are how learner publishes reach generation)")
        super().__init__(store, queue)
        self.engine = engine
        self.dataset = dataset
        self.prompts_per_minibatch = prompts_per_minibatch
        self.group_size = completions_per_prompt
        self.max_new_tokens = max_new_tokens
        self.version_offset = version_offset
        self.phase_locked = not threaded
        self.injector = injector
        self._init_thread(max_items)
        self._last_timeouts = 0
        if version_offset is not None:
            if version_offset < 0:
                raise ValueError(
                    f"version_offset must be >= 0, got {version_offset}")
            # Forced lag owns the engine's weights: the engine's own
            # store polling must never override them (0 disables
            # _maybe_swap; any interval would still fire at step 0).
            self.engine.swap_interval = 0

    def _apply_forced_lag(self) -> None:
        if self.version_offset is None:
            return
        # Nearest resident version at (or older than) latest - offset.
        target = self.store.resolve_lagged(-self.version_offset)
        if target != self.engine.version:
            self.engine.set_version(target)

    def _produce_minibatch(self):
        # Imported here: rollout.async_engine imports runtime modules.
        from repro_torch.rollout.async_engine import RLVRMinibatch
        from repro_torch.rollout.sampler import GenerationResult

        self.injector.crash_if(
            "producer", at_step=self.produced, producer=self.name)
        self._apply_forced_lag()
        self._version_at_crash = int(self.engine.version)
        tok = self.dataset.tok
        prompt_len = self.dataset.prompt_len
        n_new = self.max_new_tokens
        toks_np, _, answers = self.dataset.sample_batch(
            self.prompts_per_minibatch)
        toks_np = np.repeat(toks_np, self.group_size, axis=0)
        answers = [a for a in answers for _ in range(self.group_size)]
        batch = toks_np.shape[0]

        with self.tracer.span("produce", pid="runtime", tid="producer",
                              version=self.engine.version):
            pending = {}
            for i in range(batch):
                req = self.engine.submit(toks_np[i], n_new)
                pending[req.request_id] = i
            done: dict = {}
            self._last_timeouts = 0
            while len(done) < batch:
                if not self.engine.has_work:
                    raise RuntimeError(
                        "serve producer: engine drained with "
                        f"{batch - len(done)} requests outstanding")
                for traj in self.engine.step():
                    idx = pending.pop(traj.request_id, None)
                    if idx is not None:
                        done[idx] = traj
                        if traj.finish_reason == "timeout":
                            # The row stays in the fixed-shape batch with
                            # what it emitted (perhaps nothing: masked).
                            self._last_timeouts += 1

        tokens = np.full((batch, prompt_len + n_new), PAD, np.int32)
        tokens[:, :prompt_len] = toks_np
        log_beta = np.zeros((batch, n_new), np.float32)
        mask = np.zeros((batch, n_new), np.float32)
        versions = np.zeros((batch, n_new), np.int64)
        for i, traj in done.items():
            n = traj.num_tokens
            tokens[i, prompt_len:prompt_len + n] = traj.tokens
            log_beta[i, :n] = traj.log_beta
            mask[i, :n] = traj.mask
            versions[i, :n] = traj.versions
            # Pad with the row's last real version, so segmenting gates
            # see no phantom boundary at the tail.
            versions[i, n:] = (traj.versions[-1] if n
                               else self.engine.version)

        completion = tokens[:, prompt_len:]
        dev = self.engine.device
        rewards = torch.tensor(
            [verify(tok.decode(row), ans)
             for row, ans in zip(completion, answers)],
            dtype=torch.float32, device=dev)
        tokens_d = torch.from_numpy(tokens).to(dev)
        gen = GenerationResult(
            tokens=tokens_d, completion=tokens_d[:, prompt_len:],
            log_beta=torch.from_numpy(log_beta).to(dev),
            mask=torch.from_numpy(mask).to(dev),
            values=None)
        return RLVRMinibatch(gen=gen, rewards=rewards, answers=answers,
                             versions=versions)

    def _put(self, mb: Any, **meta: Any) -> None:
        versions = np.asarray(mb.versions)
        oldest = int(versions.min())
        if meta.get("restart") and self._restart_floor is not None:
            # A restarted producer's first batch spans the outage, so
            # admission measures the worst-case staleness.
            oldest = min(oldest, self._restart_floor)
            self._restart_floor = None
        self.queue.put(
            mb,
            behavior_version=oldest,
            learner_version=self.store.version,
            behavior_version_newest=int(versions.max()),
            producer="serve",
            timeouts=self._last_timeouts,
            **meta,
        )

    # -- phase-locked mode ---------------------------------------------------

    def fill(self) -> None:
        self._put(self._produce_minibatch())

    # -- threaded mode -------------------------------------------------------

    def start(self) -> None:
        if not self.phase_locked:
            super().start()

    def _before_run(self) -> None:
        self.engine.use_private_weights()

    def _run(self, ctx: RestartContext) -> None:
        restart_pending = ctx.attempt > 0
        if restart_pending:
            # The version generation ran at when the crash hit: the
            # floor of the first recovered batch's span.
            self._restart_floor = self._version_at_crash
            if self.version_offset is None:
                # Forced lag takes its version per minibatch anyway.
                self.engine.set_version(self.store.latest_version())
        while not self._stop_event.is_set() and (
            self.max_items is None or self.produced < self.max_items
        ):
            mb = self._hand_over(self._produce_minibatch())
            meta = ({"restart": True, "restart_attempt": ctx.attempt}
                    if restart_pending else {})
            try:
                self._put(mb, **meta)
            except QueueClosed:
                break
            restart_pending = False
            self.produced += 1

    def stop(self, join_timeout: float = 30.0) -> None:
        if not self.phase_locked:
            super().stop(join_timeout)
