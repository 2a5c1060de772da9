"""End-to-end async RL runner, one seed x env x algorithm x regime (port
of ``repro.train.runner_rl``).

Composes the actor-learner runtime:

    PolicyStore (versioned snapshot ring)
      -> lag regime producer (backward_mixture | forward_n)
      -> TrajectoryQueue (staleness tags + admission control)
      -> make_train_phase (algorithm update)
      -> store.publish (new version)
      -> evaluate_policy (post-phase deterministic return, §5.1 protocol)

Everything runs on ``cfg.device``: ``cuda`` unless the caller asks for
the CPU.  Random draws follow the JAX runner's key chain: the runner's
own chain from ``seed``, the producer's from ``seed + 1``
(``rollout.env_rollout.Draws``; ``make_draws`` replaces the default
``torch.Generator`` chains).  The paper runs 500 envs x 1000 steps
(``--n-actors 500 --rollout-steps 1000``); the defaults are smaller.
The threaded regime is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.tv_filter import tv_estimate
from repro_torch.envs import make_env, wrap_autoreset
from repro_torch.metrics.runtime_metrics import collect_runtime_stats
from repro_torch.models.mlp_policy import act, mlp_policy_init, policy_dist
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.rollout.env_rollout import (Draws, default_draws,
                                             evaluate_policy)
from repro_torch.runtime import (FrozenRolloutProducer,
                                 MixtureRolloutProducer, PolicyStore,
                                 TrajectoryQueue, make_controller,
                                 make_regime, parse_controller_spec,
                                 spec_from_legacy)
from repro_torch.serve.engine import resolve_device
from repro_torch.train.trainer_rl import (RLHyperparams, init_train_state,
                                          make_train_phase)
from repro_torch.utils.tree import tree_to


@dataclass
class AsyncRLRunConfig:
    env_name: str = "pendulum"
    algorithm: str = "vaco"
    buffer_capacity: int = 1          # degree of asynchronicity (K)
    n_actors: int = 32                # paper: 500
    rollout_steps: int = 128          # paper: 1000
    total_phases: int = 30
    eval_episodes: int = 16
    seed: int = 0
    hp: RLHyperparams = field(default_factory=RLHyperparams)
    # --- runtime ---
    runtime: str = "backward_mixture"  # backward_mixture | forward_n
    forward_n: int = 4                 # items per frozen policy (forward_n)
    queue_maxsize: int = 4             # producer backpressure (threaded)
    # Lag controller, "name:key=val,..." (see runtime.controllers); wins
    # over the deprecated string-keyed fields below when set.
    controller: Optional[str] = None
    admission: str = "pass_through"    # deprecated: use controller=
    max_lag: int = 4                   # deprecated: use controller=
    admission_delta: Optional[float] = None  # deprecated: use controller=
    admission_mode: str = "drop"       # deprecated: use controller=
    get_timeout: float = 120.0         # learner wait per item (threaded)
    tracer: Any = None                 # obs.Tracer (None = no tracing)
    device: Any = None                 # None = cuda; "cpu" on request


@dataclass
class AsyncRLResult:
    returns: List[float]              # eval return after each phase
    metrics: List[Dict[str, float]]
    final_tv: float
    runtime_stats: Dict[str, Any] = field(default_factory=dict)


def _make_tv_fn(store: PolicyStore):
    """Trajectory-level TV estimate vs the *current* policy (Eq. 8)."""

    @torch.no_grad()
    def tv_fn(batch) -> float:
        params, _ = store.latest()
        log_pi = policy_dist(params, batch.obs).log_prob(batch.actions)
        return float(tv_estimate(log_pi - batch.log_beta))

    return tv_fn


def run_async_rl(
    cfg: AsyncRLRunConfig,
    *,
    params: Any = None,
    make_draws: Optional[Callable[[int, torch.device], Draws]] = None,
) -> AsyncRLResult:
    """Train ``cfg.total_phases`` phases; ``params`` (a tree, e.g. from
    ``utils.bridge``) replaces the init from ``cfg.seed``, and
    ``make_draws(seed, device)`` the default draw chains."""
    device = resolve_device(cfg.device)
    make_draws = make_draws or default_draws
    overrides = {"algorithm": cfg.algorithm,
                 "total_phases": cfg.total_phases}
    if cfg.algorithm == "ppo_kl" and cfg.hp.kl_coef == 0.0:
        overrides["kl_coef"] = 1.0   # "PPO-KL Penalty=1" (Fig. 3)
    hp = RLHyperparams(**{**cfg.hp.__dict__, **overrides})
    env = wrap_autoreset(make_env(cfg.env_name))
    # The JAX runner splits (k_init, k_actors, key) off PRNGKey(seed).
    _, _, draws = make_draws(cfg.seed, device).split(3)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed)
        params = mlp_policy_init(gen, env.obs_dim, env.act_dim)
    else:
        params = tree_to(params, device)
    state = init_train_state(params)
    train_phase = make_train_phase(hp)

    # --- runtime assembly ---------------------------------------------------
    tracer = cfg.tracer if cfg.tracer is not None else NULL_TRACER
    store = PolicyStore(params, capacity=cfg.buffer_capacity, tracer=tracer)
    if cfg.controller is not None:
        spec = parse_controller_spec(cfg.controller)
    else:
        spec = spec_from_legacy(
            cfg.admission, max_lag=cfg.max_lag,
            delta=(cfg.admission_delta
                   if cfg.admission_delta is not None else hp.delta),
            mode=cfg.admission_mode)
    admission = make_controller(
        spec, tv_fn=_make_tv_fn(store) if spec.name == "tv_gate" else None)
    queue = TrajectoryQueue(maxsize=0, admission=admission, tracer=tracer)
    producer_cls = (MixtureRolloutProducer
                    if cfg.runtime == "backward_mixture"
                    else FrozenRolloutProducer)
    producer = producer_cls(
        env, act, n_actors=cfg.n_actors, rollout_steps=cfg.rollout_steps,
        draws=make_draws(cfg.seed + 1, device))
    regime = make_regime(cfg.runtime, store, queue, producer,
                         forward_n=cfg.forward_n)

    def det_policy(p, obs):
        return policy_dist(p, obs).mean

    returns: List[float] = []
    metric_log: List[Dict[str, float]] = []
    final_tv = 0.0
    regime.start()
    try:
        phase = 0
        while phase < cfg.total_phases:
            item = regime.next_item(store.version, timeout=cfg.get_timeout)
            if item is None:
                break  # everything dropped
            draws, d_train, d_eval = draws.split(3)
            with tracer.span("learner_step", pid="train", tid="learner",
                             lag=item.lag, weight=float(item.weight)):
                state, metrics = train_phase(state, item.payload, d_train,
                                             weight=float(item.weight))
            store.publish(state.params)
            with tracer.span("eval", pid="train", tid="learner"):
                ret = float(evaluate_policy(env, det_policy, state.params,
                                            d_eval, cfg.eval_episodes))
            returns.append(ret)
            m = dict(metrics)
            m["policy_lag"] = float(item.lag)
            m["item_weight"] = float(item.weight)
            if item.tv is not None:
                m["admission_tv"] = float(item.tv)
            metric_log.append(m)
            final_tv = m.get("final_tv", 0.0)
            phase += 1
    finally:
        regime.stop()
    return AsyncRLResult(returns=returns, metrics=metric_log,
                         final_tv=final_tv,
                         runtime_stats=collect_runtime_stats(store, queue))


def run_grid(
    env_names: List[str],
    algorithms: List[str],
    buffer_capacities: List[int],
    seeds: List[int],
    **run_kwargs,
) -> Dict[str, Dict[int, np.ndarray]]:
    """Fig. 3-style grid. Returns {alg: {K: scores [envs, seeds]}} of final
    returns (mean of last 3 eval points for stability)."""
    out: Dict[str, Dict[int, np.ndarray]] = {}
    for alg in algorithms:
        out[alg] = {}
        for cap in buffer_capacities:
            scores = np.zeros((len(env_names), len(seeds)))
            for i, env_name in enumerate(env_names):
                for j, seed in enumerate(seeds):
                    res = run_async_rl(AsyncRLRunConfig(
                        env_name=env_name, algorithm=alg,
                        buffer_capacity=cap, seed=seed, **run_kwargs,
                    ))
                    scores[i, j] = float(np.mean(res.returns[-3:]))
            out[alg][cap] = scores
    return out
