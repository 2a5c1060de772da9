"""RLVR trainer (§5.2): GRPO with PPO-clip vs GRPO with VACO filtering
(port of ``repro.train.trainer_rlvr``).

Protocol (paper App. C.2): each phase freezes the policy as beta,
generates N minibatches of grouped completions, labels them with the
binary verifier, then takes N updates; minibatch k is consumed with
forward lag k.  A supervised warm-start on synthetic chain traces first
creates the base model.  The loop runs on the port's runtime: the
``forward_n`` regime produces into a staleness-tagged ``TrajectoryQueue``
and every update publishes a new version to the ``PolicyStore``.

Gradients come from ``torch.autograd.grad`` of the loss w.r.t. the
parameter tree; the learner's ``log_pi`` and its gradient go through the
fused log-prob kernels on the card (``kernels.ops``).  The update is
functional, as in JAX: each step builds new parameter and optimizer
tensors and never writes the old ones, so the finiteness guard keeps the
previous state by reference, and the store copies what it publishes.

Two producers feed the queue: the legacy ``ForwardLagGenerator`` and
(``producer="serve"``) the continuous-batching ``ServeEngine`` over the
trainer's ``PolicyStore`` through the ``ServeRolloutProducer``, whose
items carry the engine's per-token ``{version, log_beta}``;
``forced_lag=k`` makes it generate from the learner's k-back snapshot,
and ``engine_prefix_cache`` / ``engine_speculate_k`` turn on the
engine's prefix cache (each prompt's GRPO group shares its prefill) and
self-speculation from the store.  Either runs phase-locked (``runtime="forward_n"``) or on a producer
thread (``runtime="threaded"``, a bounded queue of ``queue_maxsize``),
where lag comes from timing; there the producer thread and the
learner's eval draw from separate generator chains, and :meth:`close`
(which :meth:`train` calls) joins the thread.

Every controller of ``runtime.controllers`` runs: one with
``needs_log_pi`` (``stable_async``) gets the learner's own ``log_pi``,
scored with no gradient under ``state.params`` before the step; one with
``needs_gradients`` (``gac``) sees the raw gradient tree between the
split step's two halves (``make_split_update_step``).  One
``FaultInjector`` (``fault_plan``) threads through the store, queue,
producer, engine and the learner step; ``watchdog_restarts > 0``
supervises a producer thread; the finiteness guard restores the newest
checkpoint under ``guard_checkpoint_dir`` (written after every finite
step) or else the last finite state kept in memory.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
from repro_torch.core.losses import (GRPOConfig, group_advantages,
                                     grpo_token_loss)
from repro_torch.core.tv_filter import tv_estimate
from repro_torch.metrics.runtime_metrics import collect_runtime_stats
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, global_norm_clip_scale)
from repro_torch.resilience import (NULL_INJECTOR, BackoffPolicy,
                                    FaultInjector, tree_all_finite)
from repro_torch.rollout.async_engine import (ForwardLagGenerator,
                                              RLVRMinibatch)
from repro_torch.rollout.sampler import score_tokens
from repro_torch.runtime import (PolicyStore, ServeRolloutProducer,
                                 TrajectoryQueue, make_controller,
                                 make_regime, parse_controller_spec,
                                 spec_from_legacy)
from repro_torch.serve.engine import ServeEngine, resolve_device
from repro_torch.utils.tree import tree_grads, tree_to, tree_trainable


@dataclass(frozen=True)
class RLVRHyperparams:
    algorithm: str = "grpo"       # grpo (ppo-clip) | grpo_vaco
    clip_low: float = 0.2
    clip_high: float = 0.272      # DAPO clip-higher
    delta: float = 0.05           # VACO TV threshold (Table 2)
    entropy_coef: float = 0.0
    lr: float = 1e-4              # paper: 1e-6 on a 0.5B; scaled for ~1M
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    n_minibatches: int = 4        # N, the forward-lag knob
    prompts_per_minibatch: int = 16   # paper: 32
    completions_per_prompt: int = 4   # paper: 8
    max_new_tokens: int = 8
    temperature: float = 1.0
    warmup_steps: int = 300       # supervised base-model creation
    warmup_lr: float = 3e-3
    warmup_batch: int = 64
    # --- runtime ---
    runtime: str = "forward_n"    # forward_n | threaded
    store_capacity: int = 4       # policy snapshot ring size
    queue_maxsize: int = 4        # producer backpressure (threaded)
    # Lag controller: a "name:key=val,..." spec (see runtime.controllers).
    # None falls back to the legacy admission triple below.
    controller: Optional[str] = None
    admission: str = "pass_through"
    max_lag: int = 8
    admission_mode: str = "drop"
    get_timeout: float = 300.0
    max_refills: int = 50
    # --- producer ---
    producer: str = "legacy"      # legacy (ForwardLagGenerator) | serve
    # serve producer: force generation from the learner's k-back
    # snapshot (None = track the freshest swapped-in weights).
    forced_lag: Optional[int] = None
    engine_num_blocks: int = 64   # serve producer: paged-pool size
    engine_block_size: int = 8
    engine_max_batch: int = 8
    engine_swap_interval: int = 1
    engine_prefix_cache: bool = False
    engine_speculate_k: int = 0
    # --- resilience (see repro_torch.resilience) ---
    # Fault plan spec: ";"-joined "kind:key=val,..." chunks, e.g.
    # "producer_crash:at_step=40;nan_publish:at_publish=7".  Empty = no
    # injection (NULL_INJECTOR, an early-out on every hook).
    fault_plan: str = ""
    fault_seed: int = 0
    # Watchdog: >0 supervises threaded producers with bounded-retry
    # restarts under seeded exponential backoff; 0 = crash-fast.
    watchdog_restarts: int = 0
    watchdog_backoff_ms: float = 50.0
    # Serve producer: per-request wall-clock budget; timed-out requests
    # retire with finish_reason="timeout" and release their pages.
    request_deadline_s: Optional[float] = None
    # Quarantine non-finite publishes and skip+restore non-finite
    # learner steps (restores the last finite state, or the newest
    # checkpoint under `guard_checkpoint_dir` when set).
    finiteness_guard: bool = True
    guard_checkpoint_dir: Optional[str] = None


class RLVRTrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    updates: int


def make_split_update_step(bundle, hp: RLVRHyperparams, prompt_len: int):
    """The learner's update split at the gradient boundary, where a
    controller with ``needs_gradients`` (GAC) transforms the gradients:
    ``grad_step(state, tokens, log_beta, mask, advantages) -> (grads,
    aux)`` returns the raw gradient tree, and
    ``apply_step(state, grads) -> (state, grad_norm)`` clips it and runs
    AdamW.  ``aux`` values are 0-d tensors."""
    grpo_cfg = GRPOConfig(
        clip_low=hp.clip_low, clip_high=hp.clip_high,
        use_vaco=(hp.algorithm == "grpo_vaco"), delta=hp.delta,
        entropy_coef=hp.entropy_coef)
    opt_cfg = AdamWConfig(lr=hp.lr, weight_decay=hp.weight_decay, eps=1e-8)

    def grad_step(state: RLVRTrainState, tokens, log_beta, mask,
                  advantages):
        params = tree_trainable(state.params)
        with torch.enable_grad():
            log_pi, entropy, _ = score_tokens(bundle, params, tokens,
                                              prompt_len)
            loss, aux = grpo_token_loss(
                log_pi=log_pi, log_beta=log_beta, advantages=advantages,
                token_mask=mask, cfg=grpo_cfg)
            grads = tree_grads(loss, params)
        aux["token_entropy"] = torch.sum(entropy * mask) / torch.clamp(
            torch.sum(mask), min=1.0)
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach())
        return grads, aux

    def apply_step(state: RLVRTrainState, grads):
        # The clip's scale is applied as AdamW reads each gradient: the
        # caller still holds the raw tree, and a clipped copy beside it
        # would not fit beside full-width hymba's state on an 80 GB card.
        scale, gnorm = global_norm_clip_scale(grads, hp.max_grad_norm)
        new_params, opt_state = adamw_update(grads, state.opt_state,
                                             state.params, opt_cfg,
                                             grad_scale=scale)
        return RLVRTrainState(new_params, opt_state, state.updates + 1), gnorm

    return grad_step, apply_step


def make_update_step(bundle, hp: RLVRHyperparams, prompt_len: int):
    """``update(state, tokens, log_beta, mask, advantages) -> (state,
    aux)``: one GRPO/VACO learner step (score, loss, gradient, clip,
    AdamW), the two halves of :func:`make_split_update_step` in one
    call.  ``aux`` values are 0-d tensors."""
    grad_step, apply_step = make_split_update_step(bundle, hp, prompt_len)

    def update(state: RLVRTrainState, tokens, log_beta, mask, advantages):
        grads, aux = grad_step(state, tokens, log_beta, mask, advantages)
        state, gnorm = apply_step(state, grads)
        aux.update(grad_norm=gnorm)
        return state, aux

    return update


def make_warmup_step(bundle, hp: RLVRHyperparams):
    """Supervised next-token warm-start (creates the 'base model')."""
    opt_cfg = AdamWConfig(lr=hp.warmup_lr, eps=1e-8)

    def step(state: RLVRTrainState, tokens, mask):
        params = tree_trainable(state.params)
        with torch.enable_grad():
            logits = bundle.forward(params, tokens).logits[:, :-1]
            lp = torch.log_softmax(logits.float(), dim=-1)
            targets = tokens[:, 1:].long()[..., None]
            nll = -torch.gather(lp, -1, targets)[..., 0]
            m = mask[:, 1:]
            loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
            grads = tree_grads(loss, params)
        scale, _ = global_norm_clip_scale(grads, hp.max_grad_norm)
        new_params, opt_state = adamw_update(grads, state.opt_state,
                                             state.params, opt_cfg,
                                             grad_scale=scale)
        return (RLVRTrainState(new_params, opt_state, state.updates),
                loss.detach())

    return step


@dataclass
class RLVRPhaseLog:
    mean_reward: float
    tv: float
    frac_filtered: float      # VACO filter rate / PPO clip rate
    filter_active: float
    staleness: int            # queue-observed lag at consume time
    weight: float = 1.0       # admission downweight (1.0 = full)


@dataclass
class RLVRResult:
    eval_accuracy: List[float]
    phase_logs: List[RLVRPhaseLog]
    runtime_stats: Dict[str, Any] = field(default_factory=dict)


class RLVRTrainer:
    """Drives warmup + the queue-fed forward-lag RL loop.

    ``params`` (a tree from ``bundle.init`` or ``utils.bridge``) replaces
    the seeded init; ``device`` is ``cuda`` unless the caller asks for
    the CPU."""

    def __init__(
        self,
        bundle,
        dataset,
        hp: RLVRHyperparams,
        seed: int = 0,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        params: Any = None,
        device: Any = None,
    ) -> None:
        self.bundle = bundle
        self.dataset = dataset
        self.hp = hp
        self.device = resolve_device(device)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._h_step = self.metrics.histogram("train_step_s")
        # Pre-clip gradient norm of every learner step (the JAX trainer
        # reports it only in the step's aux).
        self._h_gnorm = self.metrics.histogram("train_grad_norm")
        self.metrics.register_producer(
            "train", lambda: collect_runtime_stats(self.store, self.queue))
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = bundle.init(gen, device=self.device)
        else:
            params = tree_to(params, self.device)
        self.state = RLVRTrainState(params=params,
                                    opt_state=adamw_init(params), updates=0)
        self.generator = ForwardLagGenerator(
            bundle, dataset,
            prompts_per_minibatch=hp.prompts_per_minibatch,
            completions_per_prompt=hp.completions_per_prompt,
            max_new_tokens=hp.max_new_tokens,
            temperature=hp.temperature,
            seed=seed + 1,
            version_fn=lambda: self.store.version,
            device=self.device,
            eval_seed=(seed + 3 if hp.runtime == "threaded"
                       and hp.producer == "legacy" else None))
        # The update at the gradient boundary: a controller with
        # ``needs_gradients`` (GAC) transforms the gradients between the
        # halves, every other step runs them back to back.
        self._grad_step, self._apply_step = make_split_update_step(
            bundle, hp, dataset.prompt_len)
        self._warmup = make_warmup_step(bundle, hp)
        # One shared injector threads through every fault site (store,
        # queue, producer, engine, learner); the supervisor policy
        # restarts a crashed producer thread with seeded backoff.  Both
        # are inert by default.
        self.injector = (
            FaultInjector(hp.fault_plan, seed=hp.fault_seed,
                          registry=self.metrics, tracer=self.tracer)
            if hp.fault_plan else NULL_INJECTOR)
        self.supervisor = (
            BackoffPolicy(base_ms=hp.watchdog_backoff_ms,
                          max_restarts=hp.watchdog_restarts, seed=seed)
            if hp.watchdog_restarts > 0 else None)
        self._last_good: Optional[RLVRTrainState] = None
        self._learner_steps = 0
        self.nonfinite_skipped = 0
        self.store = PolicyStore(params, capacity=hp.store_capacity,
                                 tracer=self.tracer, injector=self.injector,
                                 guard_finite=hp.finiteness_guard,
                                 registry=self.metrics)
        spec = (parse_controller_spec(hp.controller) if hp.controller
                else spec_from_legacy(
                    hp.admission, max_lag=hp.max_lag, delta=hp.delta,
                    mode=hp.admission_mode))
        tv_fn = token_tv_fn = None
        if spec.name == "tv_gate":
            tv_fn = self._make_tv_fn()
        elif spec.name == "tv_gate_tokenwise":
            token_tv_fn = self._make_token_tv_fn()
        self.controller = make_controller(
            spec, tv_fn=tv_fn, token_tv_fn=token_tv_fn)
        self.controller_spec = spec
        self.queue = TrajectoryQueue(
            maxsize=hp.queue_maxsize if hp.runtime == "threaded" else 0,
            admission=self.controller, tracer=self.tracer,
            registry=self.metrics, injector=self.injector,
            fallback_max_lag=hp.max_lag)
        self.engine = None
        if hp.producer == "serve":
            self.engine = ServeEngine(
                bundle, store=self.store,
                num_blocks=hp.engine_num_blocks,
                block_size=hp.engine_block_size,
                max_batch=hp.engine_max_batch,
                max_seq_len=dataset.prompt_len + hp.max_new_tokens,
                swap_interval=hp.engine_swap_interval,
                temperature=hp.temperature, seed=seed + 2,
                prefix_cache=hp.engine_prefix_cache,
                speculate_k=hp.engine_speculate_k,
                tracer=self.tracer, metrics=self.metrics,
                injector=self.injector,
                request_deadline_s=hp.request_deadline_s,
                device=self.device)
            self.regime = ServeRolloutProducer(
                self.store, self.queue, self.engine, dataset,
                prompts_per_minibatch=hp.prompts_per_minibatch,
                completions_per_prompt=hp.completions_per_prompt,
                max_new_tokens=hp.max_new_tokens,
                version_offset=hp.forced_lag,
                threaded=(hp.runtime == "threaded"),
                injector=self.injector, supervisor=self.supervisor)
        elif hp.producer == "legacy":
            self.regime = make_regime(
                hp.runtime, self.store, self.queue,
                self.generator.generate_minibatch,
                forward_n=hp.n_minibatches, max_items=None,
                injector=self.injector, supervisor=self.supervisor)
        else:
            raise ValueError(
                f"unknown producer {hp.producer!r} (legacy|serve)")
        self._regime_started = False

    def _score_latest(self, payload: RLVRMinibatch) -> torch.Tensor:
        """``log_pi`` of a minibatch's tokens under the store's latest
        policy (no gradient)."""
        params, _ = self.store.latest()
        with torch.no_grad():
            log_pi, _, _ = score_tokens(self.bundle, params,
                                        payload.gen.tokens,
                                        self.dataset.prompt_len)
        return log_pi

    def _score_log_pi(self, tokens: torch.Tensor) -> torch.Tensor:
        """The learner's own ``log_pi`` of ``tokens`` under
        ``state.params`` (no gradient), for ``needs_log_pi``
        controllers."""
        with torch.no_grad():
            log_pi, _, _ = score_tokens(self.bundle, self.state.params,
                                        tokens, self.dataset.prompt_len)
        return log_pi

    def _make_tv_fn(self):
        """Sequence-level TV of a generated minibatch vs the current
        policy."""
        def tv_fn(payload: RLVRMinibatch) -> float:
            log_pi = self._score_latest(payload)
            return float(tv_estimate(log_pi - payload.gen.log_beta,
                                     payload.gen.mask))

        return tv_fn

    def _make_token_tv_fn(self):
        """Per-token TV terms + producing versions for the tokenwise gate,
        flattened over the mask-valid completion tokens, row-major."""
        def tv_fn(payload: RLVRMinibatch):
            log_pi = self._score_latest(payload)
            tv = (0.5 * torch.abs(torch.exp(log_pi - payload.gen.log_beta)
                                  - 1.0)).cpu().numpy()
            valid = payload.gen.mask.cpu().numpy() > 0
            versions = (payload.versions if payload.versions is not None
                        else np.zeros(tv.shape, np.int64))
            return tv[valid], np.asarray(versions)[valid]

        return tv_fn

    def warmup(self, steps: Optional[int] = None) -> float:
        steps = steps if steps is not None else self.hp.warmup_steps
        loss = float("nan")
        for _ in range(steps):
            toks, mask = self.dataset.supervised_batch(
                self.hp.warmup_batch, self.hp.max_new_tokens)
            self.state, loss_t = self._warmup(
                self.state, torch.as_tensor(toks, device=self.device),
                torch.as_tensor(mask, device=self.device))
            loss = float(loss_t)
        # Fresh optimizer state for RL (new zero tensors, nothing shared).
        self.state = RLVRTrainState(
            params=self.state.params,
            opt_state=adamw_init(self.state.params), updates=0)
        # The warm-started model is the RL base policy.
        self.store.publish(self.state.params, event="warmup_done")
        return loss

    def close(self) -> None:
        """Stop the producer (threaded regime: join its thread) and close
        the queue."""
        self.regime.stop()

    # -- finiteness guard ----------------------------------------------------

    def _step_finite(self, aux: Dict[str, Any]) -> bool:
        loss = aux.get("loss")
        if loss is not None and not np.all(np.isfinite(loss)):
            return False
        return tree_all_finite(self.state.params)

    def _restore_last_good(self) -> str:
        """Roll the train state back to the newest known-finite point;
        returns where it came from ("checkpoint" | "memory" | "none").
        The in-memory state is kept by reference: updates never write a
        state's tensors."""
        hp = self.hp
        if hp.guard_checkpoint_dir:
            path = latest_checkpoint(hp.guard_checkpoint_dir)
            if path is not None:
                like = {"params": self.state.params,
                        "opt_state": self.state.opt_state}
                tree, _, _ = load_checkpoint(path, like)
                self.state = RLVRTrainState(
                    params=tree["params"], opt_state=tree["opt_state"],
                    updates=self.state.updates)
                return "checkpoint"
        if self._last_good is not None:
            self.state = self._last_good
            return "memory"
        return "none"

    def _skip_nonfinite(self, item: Any) -> None:
        self.nonfinite_skipped += 1
        restored = self._restore_last_good()
        self.metrics.counter(
            "learner_nonfinite_total", restored=restored).inc()
        if self.tracer.enabled:
            self.tracer.instant(
                "learner_nonfinite", pid="train", tid="learner",
                lag=item.lag, restored=restored, step=self._learner_steps)

    def train_phase(self) -> List[RLVRPhaseLog]:
        """One train phase: consume N queue items, publish after each."""
        hp = self.hp
        if not self._regime_started:
            self.regime.start()
            self._regime_started = True
        if hp.finiteness_guard and self._last_good is None:
            self._last_good = self.state
        logs: List[RLVRPhaseLog] = []
        ctrl = self.controller
        self._phase_consumed = 0
        for _ in range(hp.n_minibatches):
            item = self.regime.next_item(
                self.store.version, timeout=hp.get_timeout,
                max_refills=hp.max_refills)
            if item is None:
                break
            self._phase_consumed += 1
            mb: RLVRMinibatch = item.payload
            adv = group_advantages(mb.rewards, hp.completions_per_prompt)
            adv = adv * float(item.weight)
            # Controller loss hook: an optional [B, S] per-token multiplier
            # on the advantage.
            log_pi = None
            if ctrl.needs_log_pi:
                log_pi = self._score_log_pi(mb.gen.tokens).cpu().numpy()
            token_w = ctrl.loss_weights(
                item, advantages=adv.cpu().numpy(),
                log_beta=mb.gen.log_beta.cpu().numpy(),
                mask=mb.gen.mask.cpu().numpy(), log_pi=log_pi)
            adv_in = (adv if token_w is None else adv[:, None]
                      * torch.as_tensor(token_w, device=adv.device))
            t0 = time.monotonic()
            with self.tracer.span("learner_step", pid="train", tid="learner",
                                  lag=item.lag, weight=float(item.weight)):
                grads, aux = self._grad_step(
                    self.state, mb.gen.tokens, mb.gen.log_beta, mb.gen.mask,
                    adv_in)
                grad_info = {}
                if ctrl.needs_gradients:
                    grads, grad_info = ctrl.transform_gradients(item, grads)
                self.state, aux["grad_norm"] = self._apply_step(
                    self.state, grads)
                # Not kept into the next step's backward: one params'
                # worth of memory at full-width hymba's peak.
                del grads
                names = list(aux)
                values = torch.stack([aux[k].float() for k in names]).tolist()
                aux = dict(zip(names, values), **grad_info)
            self._h_step.observe(time.monotonic() - t0)
            self._h_gnorm.observe(aux["grad_norm"])
            self._learner_steps += 1
            if self.injector.active:
                poisoned_params, poisoned = self.injector.poison(
                    "learner_step", self.state.params,
                    at_step=self._learner_steps)
                if poisoned:
                    self.state = self.state._replace(params=poisoned_params)
            if hp.finiteness_guard and not self._step_finite(aux):
                # Divergence firewall: drop this update, restore the last
                # finite state and keep training; the bad step is never
                # published, so generation cannot see it.
                self._skip_nonfinite(item)
                continue
            self._last_good = self.state
            if hp.guard_checkpoint_dir:
                save_checkpoint(
                    hp.guard_checkpoint_dir, self.state.updates,
                    {"params": self.state.params,
                     "opt_state": self.state.opt_state},
                    meta={"source": "finiteness_guard"})
            ctrl.on_learner_step(item, aux)
            self.store.publish(self.state.params)
            frac = aux.get("frac_filtered", aux.get("clip_frac", 0.0))
            logs.append(RLVRPhaseLog(
                mean_reward=float(torch.mean(mb.rewards)),
                tv=float(aux["tv"]),
                frac_filtered=float(frac),
                filter_active=float(aux.get("filter_active", 1.0)),
                staleness=item.lag,
                weight=float(item.weight)))
        return logs

    def evaluate(self, n: Optional[int] = 256) -> float:
        return self.generator.eval_accuracy(self.state.params, n)

    def train(self, phases: int, eval_every: int = 5) -> RLVRResult:
        accs: List[float] = []
        logs: List[RLVRPhaseLog] = []
        try:
            for i in range(phases):
                phase_logs = self.train_phase()
                logs.extend(phase_logs)
                if not phase_logs:
                    break
                if (i + 1) % eval_every == 0 or i == phases - 1:
                    accs.append(self.evaluate())
                if self._phase_consumed < self.hp.n_minibatches:
                    break
        finally:
            if not self.regime.phase_locked:
                self.close()
        return RLVRResult(
            eval_accuracy=accs, phase_logs=logs,
            runtime_stats=collect_runtime_stats(self.store, self.queue))
