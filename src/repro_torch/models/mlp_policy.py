"""Gaussian MLP actor-critic of the classic-RL (§5.1) path (port of
``repro.models.mlp_policy``).

CleanRL's PPO architecture: two separate 2x64-tanh MLPs (actor mean +
critic), state-independent log-std; the params are the JAX layout
(nested dicts, ``{"w", "b"}`` dense leaves), so
``utils.bridge.from_jax_params`` carries ``mlp_policy_init``'s weights
across.

Mixture actors each run their own policy: JAX ``vmap``s the apply over
a stacked tree; here the same functions take stacked params (every leaf
with a leading actor axis ``N``) and ``obs`` ``[N, obs_dim]``, and each
dense layer becomes one batched matmul over the actors.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.distributions import DiagGaussian
from repro_torch.models.layers import dense_apply, dense_init


def mlp_policy_init(gen: torch.Generator, obs_dim: int, act_dim: int,
                    hidden: int = 64) -> Dict:
    return {
        "actor": {
            "l1": dense_init(gen, obs_dim, hidden, bias=True),
            "l2": dense_init(gen, hidden, hidden, bias=True),
            "head": dense_init(gen, hidden, act_dim, bias=True, scale=0.01),
        },
        "log_std": torch.zeros((act_dim,), dtype=torch.float32,
                               device=gen.device),
        "critic": {
            "l1": dense_init(gen, obs_dim, hidden, bias=True),
            "l2": dense_init(gen, hidden, hidden, bias=True),
            "head": dense_init(gen, hidden, 1, bias=True),
        },
    }


def _dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    if p["w"].dim() == 3:   # one weight per actor, x [N, d_in]
        return torch.bmm(x[:, None, :], p["w"])[:, 0] + p["b"]
    return dense_apply(p, x)


def _mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    x = torch.tanh(_dense(p["l1"], x))
    x = torch.tanh(_dense(p["l2"], x))
    return _dense(p["head"], x)


def policy_dist(params: Dict, obs: torch.Tensor) -> DiagGaussian:
    mean = _mlp(params["actor"], obs)
    log_std = torch.broadcast_to(params["log_std"], mean.shape)
    return DiagGaussian(mean=mean, log_std=log_std)


def value_fn(params: Dict, obs: torch.Tensor) -> torch.Tensor:
    return _mlp(params["critic"], obs)[..., 0]


def act(params: Dict, obs: torch.Tensor, eps: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample an action from standard-normal ``eps`` and its log-prob."""
    dist = policy_dist(params, obs)
    a = dist.sample(eps)
    return a, dist.log_prob(a)
