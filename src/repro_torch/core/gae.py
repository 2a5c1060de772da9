"""Generalized Advantage Estimation (port of ``repro.core.gae``), used by
the PPO / PPO-KL / SPO baselines.  Batch-major ``[B, T]``; the backward
scan over time is a loop."""
from __future__ import annotations

from typing import NamedTuple

import torch


class GAEOutput(NamedTuple):
    advantages: torch.Tensor  # [B, T]
    returns: torch.Tensor     # [B, T]  advantages + values (value targets)


def _tp1(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """``x`` shifted left one step in time, ``last`` in the final column."""
    return torch.cat([x[:, 1:], last[:, None]], dim=1)


def gae(
    *,
    values: torch.Tensor,           # [B, T]
    bootstrap_value: torch.Tensor,  # [B]
    rewards: torch.Tensor,          # [B, T]
    discounts: torch.Tensor,        # [B, T] gamma * (1 - done)
    lam: float = 0.95,
) -> GAEOutput:
    deltas = rewards + discounts * _tp1(values, bootstrap_value) - values
    advantages = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * lam * acc
        advantages[:, t] = acc
    return GAEOutput(advantages=advantages, returns=advantages + values)


def normalize_advantages(adv: torch.Tensor, eps: float = 1e-8
                         ) -> torch.Tensor:
    """Batch-standardized advantages (CleanRL default for PPO); the std is
    the population std (``jnp.std``), hence ``correction=0``."""
    return (adv - torch.mean(adv)) / (torch.std(adv, correction=0) + eps)
