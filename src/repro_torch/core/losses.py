"""The RLVR learner's policy losses (port of the GRPO/VACO/PPO part of
``repro.core.losses``).

Same convention as the JAX package: ``log_pi`` is differentiable,
``log_beta`` and the advantages are constants, reductions are masked
means.  Each ``jax.lax.stop_gradient`` of the reference is a
``.detach()`` at the same place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tv_filter import apply_detach, tv_estimate, \
    tv_filter_mask


def _masked_mean(x: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


class VACOConfig(NamedTuple):
    delta: float = 0.2          # TV threshold (constraint is delta/2)
    entropy_coef: float = 0.0   # c_H, max-entropy term inside the ratio
    value_coef: float = 0.5     # c_v
    policy_coef: float = 1.0    # c_pi


def vaco_policy_loss(
    *,
    log_pi: torch.Tensor,
    log_beta: torch.Tensor,
    advantages: torch.Tensor,
    cfg: VACOConfig,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """TV-filtered importance-weighted policy loss (Algorithm 1):
    ``L = -(1/N) sum ratio * (A - c_H log pi)`` with the ratio detached on
    the samples the TV filter removes."""
    advantages = advantages.detach()
    log_ratios = log_pi - log_beta.detach()
    flt = tv_filter_mask(
        log_ratios=log_ratios.detach(), advantages=advantages,
        delta=cfg.delta, entropy_coef=cfg.entropy_coef,
        valid_mask=valid_mask)
    ratios = torch.exp(apply_detach(log_ratios, flt.detach_mask))
    per_sample = ratios * (advantages - cfg.entropy_coef * log_pi)
    loss = -_masked_mean(per_sample, valid_mask)
    aux = {
        "tv": flt.tv,
        "filter_active": flt.active.float(),
        "frac_filtered": flt.frac_filtered,
        "mean_ratio": _masked_mean(torch.exp(log_ratios), valid_mask),
    }
    return loss, aux


class PPOConfig(NamedTuple):
    clip_low: float = 0.2        # ratio clipped to [1-clip_low, 1+clip_high]
    clip_high: float = 0.2       # DAPO-style asymmetric clipping supported
    kl_coef: float = 0.0         # "PPO-KL Penalty=k" baselines of Fig. 3
    entropy_coef: float = 0.0
    value_coef: float = 0.5
    clip_value: bool = False
    value_clip_eps: float = 0.2


def ppo_policy_loss(
    *,
    log_pi: torch.Tensor,
    log_beta: torch.Tensor,
    advantages: torch.Tensor,
    cfg: PPOConfig,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    advantages = advantages.detach()
    log_ratios = log_pi - log_beta.detach()
    ratios = torch.exp(log_ratios)
    clipped = torch.clamp(ratios, 1.0 - cfg.clip_low, 1.0 + cfg.clip_high)
    surrogate = torch.minimum(ratios * advantages, clipped * advantages)
    loss = -_masked_mean(surrogate, valid_mask)
    # k3 estimator of KL(beta || pi): E[exp(-lr) - 1 + lr] >= 0.
    approx_kl = _masked_mean(torch.expm1(-log_ratios) + log_ratios,
                             valid_mask)
    if cfg.kl_coef > 0.0:
        loss = loss + cfg.kl_coef * approx_kl
    bound = torch.where(ratios > 1.0, torch.full_like(ratios, cfg.clip_high),
                        torch.full_like(ratios, cfg.clip_low))
    clip_frac = _masked_mean((torch.abs(ratios - 1.0) > bound).float(),
                             valid_mask)
    aux = {
        "approx_kl": approx_kl,
        "clip_frac": clip_frac,
        "tv": tv_estimate(log_ratios.detach(), valid_mask),
        "mean_ratio": _masked_mean(ratios, valid_mask),
    }
    return loss, aux


class GRPOConfig(NamedTuple):
    clip_low: float = 0.2
    clip_high: float = 0.272     # DAPO clip-higher (Yu et al., 2025)
    use_vaco: bool = False       # swap clipping for TV filtering
    delta: float = 0.05          # TV threshold in the RLVR setup (Table 2)
    entropy_coef: float = 0.0


def grpo_token_loss(
    *,
    log_pi: torch.Tensor,        # [B, S] per-token logprobs, current policy
    log_beta: torch.Tensor,      # [B, S] per-token logprobs at generation
    advantages: torch.Tensor,    # [B] or [B, S] group-normalized advantages
    token_mask: torch.Tensor,    # [B, S] 1 on completion tokens
    cfg: GRPOConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Token-level GRPO loss; PPO-clip or VACO-filter variants."""
    if advantages.dim() == 1:
        advantages = advantages[:, None] * torch.ones_like(log_pi)
    advantages = advantages.detach()
    if cfg.use_vaco:
        vcfg = VACOConfig(delta=cfg.delta, entropy_coef=cfg.entropy_coef)
        return vaco_policy_loss(log_pi=log_pi, log_beta=log_beta,
                                advantages=advantages, cfg=vcfg,
                                valid_mask=token_mask)
    pcfg = PPOConfig(clip_low=cfg.clip_low, clip_high=cfg.clip_high,
                     entropy_coef=cfg.entropy_coef)
    return ppo_policy_loss(log_pi=log_pi, log_beta=log_beta,
                           advantages=advantages, cfg=pcfg,
                           valid_mask=token_mask)


def group_advantages(rewards: torch.Tensor, group_size: int,
                     eps: float = 1e-6) -> torch.Tensor:
    """GRPO Monte-Carlo group advantages ``(r - mean_g) / (std_g + eps)``;
    ``rewards`` is [B], completions of one prompt contiguous.  The std is
    the population std (``jnp.std``), hence ``correction=0``."""
    r = rewards.reshape(-1, group_size)
    mean = torch.mean(r, dim=1, keepdim=True)
    std = torch.std(r, dim=1, keepdim=True, correction=0)
    return ((r - mean) / (std + eps)).reshape(-1)
