"""Mamba-style selective SSM block, hymba's SSM heads (port of
``repro.models.ssm``).

The S6 recurrence with input-dependent (dt, B, C):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t outer x_t)
    y_t = C_t . h_t + D * x_t

The state is ``[B, inner, N]`` float32 (diagonal A), carried explicitly
in decode: O(1) per token.

The recurrence runs through ``kernels.ops.ssm_scan`` and nothing else,
so the tensors' device picks the route: the plain loop ``ref_ssm_scan``
on the CPU (the scan the JAX block runs; autograd differentiates it),
the hand-written CUDA kernel on the card, at prefill, at every decode
step and in training, where its backward is the ``ssm_scan_bwd`` kernel
(``kernels.ssm_scan.SSMScanFn``).  The D skip and the ``silu(z)`` gate
stay here, as in JAX.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_apply, dense_init


def ssm_init(gen: torch.Generator, d_model: int, cfg: SSMConfig,
             dtype=torch.float32, lead: Sequence[int] = ()) -> Dict:
    """The block's params under the JAX names, each leaf with ``lead``
    axes in front (the ``[L]`` layer stack).  ``a_log`` (A = -exp(a_log),
    the S4D-real init -(1..N) per channel) and ``d_skip`` stay float32
    whatever ``dtype``, as in the reference."""
    inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or max(1, d_model // 16)
    dev = gen.device

    def dense(d_in, d_out, bias=False):
        return dense_init(gen, d_in, d_out, dtype, bias=bias, lead=lead)

    a_log = torch.log(torch.arange(1, cfg.state_dim + 1, dtype=torch.float32,
                                   device=dev))
    conv_w = 0.1 * torch.randn((*lead, cfg.conv_width, inner), generator=gen,
                               dtype=torch.float32, device=dev)
    return {
        "in_proj": dense(d_model, 2 * inner),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((*lead, inner), dtype=dtype, device=dev),
        "x_proj": dense(inner, dt_rank + 2 * cfg.state_dim),
        "dt_proj": dense(dt_rank, inner, bias=True),
        "a_log": a_log.expand(*lead, inner, cfg.state_dim).clone(),
        "d_skip": torch.ones((*lead, inner), dtype=torch.float32,
                             device=dev),
        "out_proj": dense(inner, d_model),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d over ``x`` [B, S, I] with ``w`` [W, I];
    ``state`` holds the last ``W - 1`` inputs [B, W-1, I] (zeros when
    None).  Returns ``(out, new_state)``."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[-1]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return out + b[None, None, :], new_state


def ssm_forward(
    p: Dict,
    x: torch.Tensor,                  # [B, S, D]
    cfg: SSMConfig,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """The block over a whole sequence, or incrementally from ``state =
    (ssm_state [B, I, N] float32, conv_state [B, W-1, I])``.  Returns
    ``(out [B, S, D], (ssm_state, conv_state))``."""
    dt_rank = p["dt_proj"]["w"].shape[-2]
    n = p["a_log"].shape[-1]
    u, z = torch.chunk(dense_apply(p["in_proj"], x), 2, dim=-1)
    u, new_conv = _causal_conv(u, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype),
                               None if state is None else state[1])
    u = F.silu(u)
    proj = dense_apply(p["x_proj"], u)
    b_t = proj[..., dt_rank:dt_rank + n]
    c_t = proj[..., dt_rank + n:]
    dt = F.softplus(dense_apply(p["dt_proj"], proj[..., :dt_rank]))
    a = -torch.exp(p["a_log"])
    y, new_state = kops.ssm_scan(u, dt, b_t, c_t, a,
                                 None if state is None else state[0])
    y = y + u * p["d_skip"].to(x.dtype)[None, None, :]
    y = y * F.silu(z)
    return dense_apply(p["out_proj"], y), (new_state, new_conv)
