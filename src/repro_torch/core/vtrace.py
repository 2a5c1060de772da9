"""Advantage realignment via the V-trace operator (port of
``repro.core.vtrace``; paper §4.2.1, Eqs. 13-15).

    delta_t  = rho_t * (r_t + gamma_t * V(s_{t+1}) - V(s_t))
    acc_t    = delta_t + gamma_t * c_t * acc_{t+1},   v_t = V(s_t) + acc_t
    A_vtrace = r_t + gamma_t * v_{t+1} - V(s_t)

with rho_t = min(rho_bar, ratio) and c_t = lam * min(c_bar, ratio).
VACO computes this ONCE per training phase (w.r.t. pi_T) and holds it
fixed across the epochs of the phase.  Batch-major ``[B, T]``.

These are the plain versions: ``kernels.ref.ref_vtrace`` wraps
``vtrace``, and ``kernels.ops.vtrace`` routes a CUDA tensor to the
hand-written kernel (``kernels/csrc/vtrace.cu``) instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.gae import _tp1


class VTraceOutput(NamedTuple):
    vs: torch.Tensor            # [B, T]  V-trace value targets v(s_t)
    advantages: torch.Tensor    # [B, T]  A_vtrace(s_t, a_t)  (Eq. 15)
    clipped_rhos: torch.Tensor  # [B, T]  min(rho_bar, ratio), diagnostics


def _clipped(log_ratios, rho_bar, c_bar, lam):
    ratios = torch.exp(log_ratios)
    return (torch.clamp(ratios, max=rho_bar),
            lam * torch.clamp(ratios, max=c_bar))


def vtrace(
    *,
    log_ratios: torch.Tensor,       # [B, T] log(pi_T(a|s)/beta_T(a|s))
    values: torch.Tensor,           # [B, T] V(s_t) under the learner's critic
    bootstrap_value: torch.Tensor,  # [B]  V(s_T) at the truncation point
    rewards: torch.Tensor,          # [B, T]
    discounts: torch.Tensor,        # [B, T] gamma * (1 - done_t)
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
) -> VTraceOutput:
    """Batch-major V-trace targets + realigned advantages (Eqs. 14-15)."""
    rhos, cs = _clipped(log_ratios, rho_bar, c_bar, lam)
    deltas = rhos * (rewards + discounts * _tp1(values, bootstrap_value)
                     - values)
    # Backward-in-time linear recurrence on the correction term.
    acc_all = torch.empty_like(deltas)
    acc = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[1] - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
        acc_all[:, t] = acc
    vs = values + acc_all
    # v_{t+1} with bootstrap at the end (acc_T = 0 => v_T = bootstrap).
    advantages = rewards + discounts * _tp1(vs, bootstrap_value) - values
    return VTraceOutput(vs=vs, advantages=advantages, clipped_rhos=rhos)


def vtrace_impala_pg_advantage(
    out: VTraceOutput,
    *,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    rho_bar_pg: float = 1.0,
    log_ratios: torch.Tensor,
) -> torch.Tensor:
    """IMPALA's policy-gradient advantage: rho_t * (r + gamma v_{t+1} - V)."""
    rhos_pg = torch.clamp(torch.exp(log_ratios), max=rho_bar_pg)
    return rhos_pg * (rewards + discounts * _tp1(out.vs, bootstrap_value)
                      - values)


def naive_vtrace(
    *,
    log_ratios: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
) -> VTraceOutput:
    """O(T^2) direct evaluation of Eq. 13, the test oracle:
    v(s_t) = V(s_t) + sum_{k>=t} (prod_{i=t..k-1} disc_i c_i) rho_k delta_k.
    """
    b, t_len = rewards.shape
    rhos, cs = _clipped(log_ratios, rho_bar, c_bar, lam)
    deltas = rhos * (rewards + discounts * _tp1(values, bootstrap_value)
                     - values)
    vs = []
    for t in range(t_len):
        acc = torch.zeros(b, dtype=values.dtype, device=values.device)
        coef = torch.ones(b, dtype=values.dtype, device=values.device)
        for k in range(t, t_len):
            acc = acc + coef * deltas[:, k]
            coef = coef * discounts[:, k] * cs[:, k]
        vs.append(values[:, t] + acc)
    vs = torch.stack(vs, dim=1)
    advantages = rewards + discounts * _tp1(vs, bootstrap_value) - values
    return VTraceOutput(vs=vs, advantages=advantages, clipped_rhos=rhos)
