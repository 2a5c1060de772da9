"""Batched environment interface (port of ``repro.envs.base``).

JAX writes one environment and ``vmap``s it; here every function works
on a batch of ``N`` environments at once, each state field a tensor
with a leading ``N`` axis:

    env.reset(draws)                  -> EnvState
    env.step(state, action, draws)    -> (EnvState, Timestep)

Where JAX passes a PRNG key, the port passes the standard random draws
the key would have produced: ``draws`` is ``[N, R]``, one column per
scalar the reset consumes, uniform on [0, 1) or standard normal as
``env.reset_kinds`` says, and the env maps them onto its ranges.  A
plain env's ``step`` ignores its ``draws`` (as the JAX envs ignore
their key); ``wrap_autoreset``'s step uses them for the fresh reset.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple

import torch


class Timestep(NamedTuple):
    obs: torch.Tensor         # [N, obs_dim]
    reward: torch.Tensor      # [N]
    done: torch.Tensor        # [N] bool: episode ended THIS step (term|trunc)
    info_steps: torch.Tensor  # [N] int32: steps elapsed in episode


class Env(NamedTuple):
    name: str
    obs_dim: int
    act_dim: int
    max_episode_steps: int
    reset: Callable[[torch.Tensor], Any]
    step: Callable[[Any, torch.Tensor, torch.Tensor], tuple]
    observe: Callable[[Any], torch.Tensor]
    # One entry per reset draw, "uniform" or "normal".
    reset_kinds: Tuple[str, ...]


class AutoResetState(NamedTuple):
    inner: Any
    t: torch.Tensor  # [N] int32 steps elapsed


def select(cond: torch.Tensor, new: Any, old: Any) -> Any:
    """Field-wise ``where(cond, new, old)`` over two states of the same
    NamedTuple type; ``cond`` is ``[N]`` and broadcasts over trailing
    axes."""
    def pick(a, b):
        c = cond.reshape(cond.shape + (1,) * (a.dim() - cond.dim()))
        return torch.where(c, a, b)

    return type(old)(*(pick(a, b) for a, b in zip(new, old)))


def wrap_autoreset(env: Env) -> Env:
    """Time-limit + auto-reset wrapper (gym-style vector semantics).

    On done (termination or hitting max_episode_steps) the state resets
    immediately; the returned ``obs`` is the first obs of the new episode
    and ``done`` is True so advantage estimators cut the bootstrap.  A
    fresh reset is drawn for every env on every step and kept only where
    ``done`` holds, as the JAX wrapper does, so both consume the same
    draws.
    """

    def reset(draws):
        inner = env.reset(draws)
        n = draws.shape[0]
        return AutoResetState(
            inner=inner,
            t=torch.zeros(n, dtype=torch.int32, device=draws.device))

    def step(state: AutoResetState, action, draws):
        inner, ts = env.step(state.inner, action, draws)
        t = state.t + 1
        truncated = t >= env.max_episode_steps
        done = torch.logical_or(ts.done, truncated)

        fresh = env.reset(draws)
        inner = select(done, fresh, inner)
        t = torch.where(done, torch.zeros_like(t), t)
        obs = torch.where(done[:, None], env.observe(inner), ts.obs)
        return (
            AutoResetState(inner=inner, t=t),
            Timestep(obs=obs, reward=ts.reward, done=done, info_steps=t),
        )

    def observe(state: AutoResetState):
        return env.observe(state.inner)

    return Env(
        name=env.name,
        obs_dim=env.obs_dim,
        act_dim=env.act_dim,
        max_episode_steps=env.max_episode_steps,
        reset=reset,
        step=step,
        observe=observe,
        reset_kinds=env.reset_kinds,
    )


def angle_normalize(x: torch.Tensor) -> torch.Tensor:
    # Float % takes the divisor's sign in torch, as in jnp.
    return ((x + math.pi) % (2.0 * math.pi)) - math.pi
