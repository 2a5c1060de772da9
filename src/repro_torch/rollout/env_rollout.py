"""Vectorized environment rollout with per-actor policies (port of
``repro.rollout.env_rollout``), and the classic-RL path's one seam for
random draws.

The simulated-async protocol (Fig. 1 left) runs each parallel actor
with a *different* policy sampled from the policy buffer.  JAX ``vmap``s
the policy over a stacked parameter tree and scans the environment
inside ``jit``; here the actor axis is the batch axis of every tensor
and the scan is a loop over steps.  Everything stays on the device of
the tensors it is given.  Output layout is batch-major ``[N, T, ...]``.

**Random draws.**  Where JAX threads PRNG keys, the port threads a
``Draws`` object.  It supplies every random number of the path, in
standard form: action noise, the env reset and auto-reset draws, the
mixture's slot indices, minibatch permutations and the evaluation
resets.  ``split`` mirrors ``jax.random.split`` at each place the JAX
code splits a key.  ``GeneratorDraws``, the default, takes everything
from one ``torch.Generator`` and its ``split`` hands back itself (the
stream is consumed in order).  A test passes a ``Draws`` that replays
the JAX key chain instead, so both frameworks see the same numbers.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Protocol, Sequence, Tuple

import torch

from repro_torch.envs.base import Env


class Draws(Protocol):
    """The random draws of one JAX key's worth of work."""

    def split(self, num: int = 2) -> Tuple["Draws", ...]:
        """``num`` independent sources, as ``jax.random.split``."""

    def env_reset(self, n: int, kinds: Sequence[str]) -> torch.Tensor:
        """``[n, R]`` reset draws for ``n`` envs (``init_env_states``)."""

    def rollout(self, n: int, steps: int, act_dim: int,
                kinds: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(eps [steps, n, act_dim], resets [steps, n, R])``: each
        step's standard-normal action noise and auto-reset draws."""

    def slots(self, n: int, count: int) -> torch.Tensor:
        """``[n]`` int64 uniform in ``[0, count)`` (mixture sampling)."""

    def permutations(self, num: int, m: int) -> torch.Tensor:
        """``[num, m]`` int64: one permutation of ``range(m)`` per epoch."""

    def episodes(self, n: int, steps: int, kinds: Sequence[str]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(resets0 [n, R], resets [steps, n, R])`` of ``n`` evaluation
        episodes: the initial reset and each step's auto-reset draws."""


class GeneratorDraws:
    """Every draw from one ``torch.Generator``; tensors land on
    ``device`` (default: the generator's)."""

    def __init__(self, generator: torch.Generator, device: Any = None):
        self.generator = generator
        self.device = torch.device(generator.device if device is None
                                   else device)

    def split(self, num: int = 2) -> Tuple["GeneratorDraws", ...]:
        return (self,) * num

    def _on(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def _standard(self, shape: Tuple[int, ...], kinds: Sequence[str]
                  ) -> torch.Tensor:
        g = self.generator
        cols = [torch.rand(shape, generator=g, device=g.device)
                if kind == "uniform" else
                torch.randn(shape, generator=g, device=g.device)
                for kind in kinds]
        return self._on(torch.stack(cols, dim=-1))

    def env_reset(self, n, kinds):
        return self._standard((n,), kinds)

    def rollout(self, n, steps, act_dim, kinds):
        g = self.generator
        eps = torch.randn((steps, n, act_dim), generator=g, device=g.device)
        return self._on(eps), self._standard((steps, n), kinds)

    def slots(self, n, count):
        g = self.generator
        return self._on(torch.randint(0, count, (n,), generator=g,
                                      device=g.device))

    def permutations(self, num, m):
        g = self.generator
        keys = torch.rand((num, m), generator=g, device=g.device)
        return self._on(torch.argsort(keys, dim=1))

    def episodes(self, n, steps, kinds):
        return self._standard((n,), kinds), self._standard((steps, n), kinds)


def default_draws(seed: int, device: Any) -> GeneratorDraws:
    """``GeneratorDraws`` from a generator on ``device`` seeded ``seed``."""
    return GeneratorDraws(torch.Generator(device=device).manual_seed(seed))


class RolloutBatch(NamedTuple):
    obs: torch.Tensor        # [N, T, obs_dim]
    actions: torch.Tensor    # [N, T, act_dim]
    log_beta: torch.Tensor   # [N, T]   behavior log-probs at collection
    rewards: torch.Tensor    # [N, T]
    dones: torch.Tensor      # [N, T]   bool, episode boundary AFTER this step
    final_obs: torch.Tensor  # [N, obs_dim]  for bootstrap values


@torch.no_grad()
def collect_rollout(
    env: Env,
    policy_apply: Callable[[Any, torch.Tensor, torch.Tensor],
                           Tuple[torch.Tensor, torch.Tensor]],
    actor_params: Any,   # tree, leaves lead with N (one policy per actor)
    env_states: Any,     # state, fields lead with N
    draws: Draws,
    num_steps: int,
) -> Tuple[Any, RolloutBatch]:
    """Run every actor for ``num_steps`` with its own policy.

    ``policy_apply(params [N, ...], obs [N, obs_dim], eps [N, act_dim])
    -> (action, log_prob)``.  Returns ``(new_env_states, batch)``."""
    obs = env.observe(env_states)
    n = obs.shape[0]
    eps, resets = draws.rollout(n, num_steps, env.act_dim, env.reset_kinds)
    dev = obs.device
    out_obs = torch.empty((n, num_steps, env.obs_dim), device=dev)
    out_act = torch.empty((n, num_steps, env.act_dim), device=dev)
    log_beta = torch.empty((n, num_steps), device=dev)
    rewards = torch.empty((n, num_steps), device=dev)
    dones = torch.empty((n, num_steps), dtype=torch.bool, device=dev)
    for t in range(num_steps):
        obs = env.observe(env_states)
        actions, log_probs = policy_apply(actor_params, obs, eps[t])
        env_states, ts = env.step(env_states, actions, resets[t])
        out_obs[:, t] = obs
        out_act[:, t] = actions
        log_beta[:, t] = log_probs
        rewards[:, t] = ts.reward
        dones[:, t] = ts.done
    batch = RolloutBatch(obs=out_obs, actions=out_act, log_beta=log_beta,
                         rewards=rewards, dones=dones,
                         final_obs=env.observe(env_states))
    return env_states, batch


def init_env_states(env: Env, draws: Draws, n: int) -> Any:
    return env.reset(draws.env_reset(n, env.reset_kinds))


@torch.no_grad()
def evaluate_policy(
    env: Env,
    policy_apply_det: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,
    draws: Draws,
    n_episodes: int = 16,
) -> torch.Tensor:
    """Mean undiscounted return of the (deterministic) policy over
    ``n_episodes`` episodes of ``env.max_episode_steps`` steps, run as
    one batch."""
    resets0, resets = draws.episodes(n_episodes, env.max_episode_steps,
                                     env.reset_kinds)
    state = env.reset(resets0)
    ret = torch.zeros(n_episodes, dtype=torch.float32, device=resets0.device)
    for t in range(env.max_episode_steps):
        a = policy_apply_det(params, env.observe(state))
        state, ts = env.step(state, a, resets[t])
        ret = ret + ts.reward
    return torch.mean(ret)
