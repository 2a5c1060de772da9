"""Diagonal Gaussian policy distribution of the classic-RL path (port of
``repro.core.distributions.DiagGaussian``; ``Categorical`` is not
ported).

State-independent log-std parameters, tanh-free (CleanRL convention).
``sample`` takes its standard-normal draws ``eps`` instead of a PRNG
key, so a caller can hand both frameworks the same noise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian(NamedTuple):
    """Diagonal Gaussian with mean [.., D] and log_std [.., D]."""

    mean: torch.Tensor
    log_std: torch.Tensor

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """``mean + exp(log_std) * eps`` for standard-normal ``eps``."""
        return self.mean + torch.exp(self.log_std) * eps

    def log_prob(self, a: torch.Tensor) -> torch.Tensor:
        """Sum over the trailing action dimension."""
        z = (a - self.mean) * torch.exp(-self.log_std)
        lp = -0.5 * (z * z + _LOG_2PI) - self.log_std
        return torch.sum(lp, dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        """KL(self || other), summed over action dims."""
        var_ratio = torch.exp(2.0 * (self.log_std - other.log_std))
        t1 = (self.mean - other.mean) * torch.exp(-other.log_std)
        kl = (0.5 * (var_ratio + t1 * t1 - 1.0)
              + (other.log_std - self.log_std))
        return torch.sum(kl, dim=-1)
