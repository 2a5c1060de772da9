"""TV-divergence estimation and gradient filtering, the paper's Eq. 8/19
(port of ``repro.core.tv_filter``).

    E_{s~d^beta}[D_TV(pi||beta)[s]]  ~=  (1/2N) sum_i |ratio_i - 1|

When the minibatch estimate exceeds delta/2, the gradient of every sample
whose update would *increase* D_TV, i.e. with
``(A - c_H) * sgn(pi - beta) > 0``, is detached (``.detach()`` where JAX
writes ``stop_gradient``): the loss value is unchanged and the sample's
contribution to the update vanishes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def tv_estimate(log_ratios: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1/2N) sum |exp(log_ratio) - 1| over valid entries (Eq. 8)."""
    tv = 0.5 * torch.abs(torch.exp(log_ratios) - 1.0)
    if mask is None:
        return torch.mean(tv)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(tv * mask) / denom


class FilterResult(NamedTuple):
    detach_mask: torch.Tensor    # 1.0 where the sample's gradient is detached
    tv: torch.Tensor             # scalar minibatch TV estimate
    active: torch.Tensor         # scalar bool: was the filter triggered?
    frac_filtered: torch.Tensor  # scalar in [0, 1]: fraction detached


def tv_filter_mask(
    *,
    log_ratios: torch.Tensor,    # log(pi_theta / beta_T), current policy
    advantages: torch.Tensor,    # A_{pi_T} (realigned; fixed per phase)
    delta: float,
    entropy_coef: float = 0.0,
    valid_mask: Optional[torch.Tensor] = None,
) -> FilterResult:
    """The VACO detach mask of one minibatch (Algorithm 1): 1 where
    ``(A - c_H) * sgn(ratio - 1) > 0`` and the minibatch TV estimate
    exceeds ``delta / 2``."""
    tv = tv_estimate(log_ratios, valid_mask)
    active = tv > (delta / 2.0)
    increases_tv = ((advantages - entropy_coef)
                    * torch.sign(torch.expm1(log_ratios))) > 0.0
    detach = torch.where(active, increases_tv.to(log_ratios.dtype),
                         torch.zeros_like(log_ratios))
    if valid_mask is not None:
        detach = detach * valid_mask
        denom = torch.clamp(torch.sum(valid_mask), min=1.0)
    else:
        denom = torch.tensor(float(log_ratios.numel()),
                             dtype=log_ratios.dtype, device=log_ratios.device)
    frac = torch.sum(detach) / denom
    return FilterResult(detach_mask=detach, tv=tv, active=active,
                        frac_filtered=frac)


def apply_detach(log_ratios: torch.Tensor,
                 detach_mask: torch.Tensor) -> torch.Tensor:
    """Masked entries' log-ratios replaced by detached copies: the loss
    value is unchanged; only gradients of detached samples vanish."""
    return torch.where(detach_mask > 0.0, log_ratios.detach(), log_ratios)
