"""Wrapper of the CUDA V-trace kernel (``csrc/vtrace.cu``).

Replaces the Pallas kernel ``repro.kernels.vtrace_pallas.vtrace_pallas``.
The plain version is ``kernels.ref.ref_vtrace``.  The kernel has no
backward: every consumer of V-trace treats its outputs as constants
(the trainers' ``stop_gradient``), so the wrapper refuses inputs that
require grad.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p
from typing import Tuple

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# log_ratios, values, bootstrap, rewards, discounts, vs, adv | B T dtype |
# rho_bar c_bar lam | stream
KERNEL = Kernel("vtrace", [c_void_p] * 7 + [c_int] * 3 + [c_float] * 3
                + [c_void_p])


def vtrace_cuda(
    log_ratios: torch.Tensor,       # [B, T]
    values: torch.Tensor,           # [B, T]
    bootstrap_value: torch.Tensor,  # [B]
    rewards: torch.Tensor,          # [B, T]
    discounts: torch.Tensor,        # [B, T]
    *,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
    lam: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vs, advantages)``, each ``[B, T]`` float32, from five inputs of
    one dtype (float32 or bfloat16), contiguous, on one CUDA device."""
    name = KERNEL.name
    tensors = (log_ratios, values, bootstrap_value, rewards, discounts)
    if any(t.device.type != "cuda" or t.device != values.device
           for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; pass inputs "
                         "that do not require grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if values.dtype not in _DTYPES or any(t.dtype != values.dtype
                                          for t in tensors):
        raise TypeError(f"{name}: inputs must share float32 or bfloat16, "
                        f"got {[t.dtype for t in tensors]}")
    if values.dim() != 2 or 0 in values.shape or \
            bootstrap_value.shape != values.shape[:1] or \
            any(t.shape != values.shape
                for t in (log_ratios, rewards, discounts)):
        shapes = [tuple(t.shape) for t in tensors]
        raise ValueError(f"{name}: bad shapes {shapes}")
    b, t = values.shape
    vs = torch.empty((b, t), dtype=torch.float32, device=values.device)
    adv = torch.empty_like(vs)
    KERNEL.launch(values.device, log_ratios.data_ptr(), values.data_ptr(),
                  bootstrap_value.data_ptr(), rewards.data_ptr(),
                  discounts.data_ptr(), vs.data_ptr(), adv.data_ptr(), b, t,
                  _DTYPES[values.dtype], rho_bar, c_bar, lam)
    return vs, adv
