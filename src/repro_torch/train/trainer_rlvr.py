"""RLVR trainer (§5.2): GRPO with PPO-clip vs GRPO with VACO filtering
(port of ``repro.train.trainer_rlvr`` for the default producer and
runtime).

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

Two producers feed the queue: the legacy ``ForwardLagGenerator`` under
the ``forward_n`` runtime, and (``producer="serve"``) the continuous-
batching ``ServeEngine`` over the trainer's ``PolicyStore`` through the
phase-locked ``ServeRolloutProducer``, whose items carry the engine's
per-token ``{version, log_beta}``; ``forced_lag=k`` makes it generate
from the learner's k-back snapshot.  The controllers are
``pass_through``/``max_lag``/``tv_gate``/``tv_gate_tokenwise``.  The
threaded regime, fault injection, the watchdog and checkpoints are not
ported yet: their hyperparameters are absent, and ``make_regime`` and
the serve producer raise for another runtime.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.losses import (GRPOConfig, group_advantages,
                                     grpo_token_loss)
from repro_torch.core.tv_filter import tv_estimate
from repro_torch.metrics.runtime_metrics import collect_runtime_stats
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               adamw_update, clip_by_global_norm)
from repro_torch.resilience import NULL_INJECTOR, tree_all_finite
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
    runtime: str = "forward_n"    # forward_n (threaded: not ported yet)
    store_capacity: int = 4       # policy snapshot ring size
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
    # Serve producer: per-request wall-clock budget; timed-out requests
    # retire with finish_reason="timeout" and release their pages.
    request_deadline_s: Optional[float] = None
    # Quarantine non-finite publishes and skip+restore non-finite
    # learner steps (restores the last finite state).
    finiteness_guard: bool = True


class RLVRTrainState(NamedTuple):
    params: Any
    opt_state: AdamWState
    updates: int


def make_update_step(bundle, hp: RLVRHyperparams, prompt_len: int):
    """``update(state, tokens, log_beta, mask, advantages) -> (state,
    aux)``: one GRPO/VACO learner step (score, loss, gradient, clip,
    AdamW).  ``aux`` values are 0-d tensors."""
    grpo_cfg = GRPOConfig(
        clip_low=hp.clip_low, clip_high=hp.clip_high,
        use_vaco=(hp.algorithm == "grpo_vaco"), delta=hp.delta,
        entropy_coef=hp.entropy_coef)
    opt_cfg = AdamWConfig(lr=hp.lr, weight_decay=hp.weight_decay, eps=1e-8)

    def update(state: RLVRTrainState, tokens, log_beta, mask, advantages):
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
        grads, gnorm = clip_by_global_norm(grads, hp.max_grad_norm)
        new_params, opt_state = adamw_update(grads, state.opt_state,
                                             state.params, opt_cfg)
        aux = {k: v.detach() for k, v in aux.items()}
        aux.update(loss=loss.detach(), grad_norm=gnorm)
        return RLVRTrainState(new_params, opt_state, state.updates + 1), aux

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
        grads, _ = clip_by_global_norm(grads, hp.max_grad_norm)
        new_params, opt_state = adamw_update(grads, state.opt_state,
                                             state.params, opt_cfg)
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
            device=self.device)
        self._update = make_update_step(bundle, hp, dataset.prompt_len)
        self._warmup = make_warmup_step(bundle, hp)
        self.injector = NULL_INJECTOR
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
            maxsize=0, admission=self.controller, tracer=self.tracer,
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
                injector=self.injector)
        elif hp.producer == "legacy":
            self.regime = make_regime(
                hp.runtime, self.store, self.queue,
                self.generator.generate_minibatch,
                forward_n=hp.n_minibatches)
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
        self.regime.stop()

    # -- finiteness guard ----------------------------------------------------

    def _step_finite(self, aux: Dict[str, Any]) -> bool:
        loss = aux.get("loss")
        if loss is not None and not np.all(np.isfinite(loss)):
            return False
        return tree_all_finite(self.state.params)

    def _skip_nonfinite(self, item: Any) -> None:
        """Drop the step and restore the last finite state (kept by
        reference: updates never write a state's tensors)."""
        self.nonfinite_skipped += 1
        restored = "none"
        if self._last_good is not None:
            self.state = self._last_good
            restored = "memory"
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
            # on the advantage (None for every ported controller).
            token_w = ctrl.loss_weights(
                item, advantages=adv.cpu().numpy(),
                log_beta=mb.gen.log_beta.cpu().numpy(),
                mask=mb.gen.mask.cpu().numpy(), log_pi=None)
            adv_in = (adv if token_w is None else adv[:, None]
                      * torch.as_tensor(token_w, device=adv.device))
            t0 = time.monotonic()
            with self.tracer.span("learner_step", pid="train", tid="learner",
                                  lag=item.lag, weight=float(item.weight)):
                self.state, aux = self._update(
                    self.state, mb.gen.tokens, mb.gen.log_beta, mb.gen.mask,
                    adv_in)
                names = list(aux)
                values = torch.stack([aux[k].float() for k in names]).tolist()
                aux = dict(zip(names, values))
            self._h_step.observe(time.monotonic() - t0)
            self._h_gnorm.observe(aux["grad_norm"])
            self._learner_steps += 1
            if hp.finiteness_guard and not self._step_finite(aux):
                self._skip_nonfinite(item)
                continue
            self._last_good = self.state
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
