"""RWKV-6 "Finch" block (port of ``repro.models.rwkv6``, arXiv:2404.05892):
data-dependent decay linear attention (time-mix) + squared-ReLU
channel-mix.

Recurrence per head (head dim K = V = 64):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (w_t in (0,1), learned
    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t     data-dependent decay)

State is ``[B, H, K, V]`` float32, O(1) per token in decode.

The time-mix runs the recurrence through ``kernels.ops.wkv6``, so the
tensors' device picks the route: the plain loop ``wkv6_scan`` on the CPU
(the recurrence the JAX block runs by default), the hand-written CUDA
kernel on the card.  The JAX block's ``use_kernel`` switch is dropped
for that reason.  Training differentiates through the same call: inputs
that need a gradient go through ``kernels.wkv6.WKV6Fn`` (the backward is
the ``wkv6_bwd`` kernel on the card, ``ref_wkv6_backward`` on the CPU),
so the gradient reaches r, k, v, the decay (its LoRA and
``decay_base``), ``bonus_u`` and, through them, the mixes; ``ln_x_scale``
and the gate are outside the recurrence.

The reference's simplifications of the released Finch are kept: the
token-shift LoRA mixers are plain learned interpolation vectors, and the
decay LoRA has a single hidden layer.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import ref_wkv6 as wkv6_scan  # noqa: F401
from repro_torch.models.layers import dense_apply, dense_init

HEAD_DIM = 64


def rwkv6_init(gen: torch.Generator, d_model: int, d_ff: int,
               dtype=torch.float32, lead: Sequence[int] = ()) -> Dict:
    """The block's params under the JAX names, each leaf with ``lead``
    axes in front (the ``[L]`` layer stack).  ``decay_base`` stays
    float32 whatever ``dtype``, as in the reference."""
    n_heads = d_model // HEAD_DIM
    decay_hidden = max(32, d_model // 32)
    dev = gen.device

    def half(d=d_model):
        return 0.5 * torch.ones((*lead, d), dtype=dtype, device=dev)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, lead=lead)

    base = torch.linspace(-6.0, -1.0, d_model, dtype=torch.float32,
                          device=dev)
    bonus = 0.1 * torch.randn((*lead, n_heads, HEAD_DIM), generator=gen,
                              dtype=torch.float32, device=dev)
    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "w_r": dense(d_model, d_model), "w_k": dense(d_model, d_model),
        "w_v": dense(d_model, d_model), "w_g": dense(d_model, d_model),
        "decay_a": dense(d_model, decay_hidden),
        "decay_b": dense(decay_hidden, d_model),
        "decay_base": base.expand(*lead, d_model).clone(),
        "bonus_u": bonus.to(dtype),
        "w_o": dense(d_model, d_model),
        "ln_x_scale": torch.ones((*lead, d_model), dtype=dtype, device=dev),
        "mu_ck": half(),
        "w_ck": dense(d_model, d_ff), "w_cv": dense(d_ff, d_model),
        "w_cr": dense(d_model, d_model),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` is the last token of the previous
    segment (zeros when None)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor
         ) -> torch.Tensor:
    return x + (x_prev - x) * mu.to(x.dtype)[None, None, :]


def rwkv6_time_mix(
    p: Dict,
    x: torch.Tensor,                       # [B, S, D]
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Time-mix sub-block.  ``state = (wkv_state [B,H,K,V] float32,
    shift [B,1,D])``; returns ``(out, new_state)``."""
    b, s, d = x.shape
    h = d // HEAD_DIM
    wkv_state = state[0] if state is not None else None
    shift = state[1] if state is not None else None
    xp = _token_shift(x, shift)

    r = dense_apply(p["w_r"], _mix(x, xp, p["mu_r"]))
    k = dense_apply(p["w_k"], _mix(x, xp, p["mu_k"]))
    v = dense_apply(p["w_v"], _mix(x, xp, p["mu_v"]))
    g = F.silu(dense_apply(p["w_g"], _mix(x, xp, p["mu_g"])))

    wx = _mix(x, xp, p["mu_w"])
    acc = torch.promote_types(x.dtype, torch.float32)
    decay_raw = p["decay_base"].to(acc)[None, None, :] + dense_apply(
        p["decay_b"], torch.tanh(dense_apply(p["decay_a"], wx))).to(acc)
    # w_t = exp(-exp(decay_raw)) in (0,1): the Finch parameterization.
    w = torch.exp(-torch.exp(decay_raw)).to(x.dtype)

    def heads(t):
        return t.reshape(b, s, h, HEAD_DIM)

    y, new_state = kops.wkv6(heads(r), heads(k), heads(v), heads(w),
                             p["bonus_u"].to(x.dtype), wkv_state)
    # group-norm-lite over heads (Finch uses GroupNorm(h)), in float32
    # (float64 for float64 inputs, as the decay above).
    y32 = y.to(acc)
    y32 = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True)
                            + 1e-5)
    y = (y32.reshape(b, s, d) * p["ln_x_scale"].to(acc)).to(x.dtype)
    out = dense_apply(p["w_o"], y * g)
    return out, (new_state, x[:, -1:])


def rwkv6_channel_mix(
    p: Dict,
    x: torch.Tensor,
    shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Squared-ReLU channel mix.  Returns ``(out, new_shift)``."""
    xp = _token_shift(x, shift)
    k = dense_apply(p["w_ck"], _mix(x, xp, p["mu_ck"]))
    kv = dense_apply(p["w_cv"], torch.square(F.relu(k)))
    rgate = torch.sigmoid(dense_apply(p["w_cr"], xp))
    return rgate * kv, x[:, -1:]
