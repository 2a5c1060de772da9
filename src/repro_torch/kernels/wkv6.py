"""Wrapper of the CUDA WKV6 kernel (``csrc/wkv6.cu``).

Replaces the Pallas kernel ``repro.kernels.wkv6_pallas.wkv6_pallas``.
The plain version is ``kernels.ref.ref_wkv6``.  The kernel has no
backward yet (serving needs none), so the wrapper refuses inputs that
require grad.
"""
from __future__ import annotations

from ctypes import c_int, c_void_p
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KEY_DIMS = (8, 16, 32, 64)

# r, k, v, w, u, state_in, y, state_out | B S H K V dtype | stream
KERNEL = Kernel("wkv6", [c_void_p] * 8 + [c_int] * 6 + [c_void_p])


def wkv6_cuda(
    r: torch.Tensor,                       # [B, S, H, K]
    k: torch.Tensor,                       # [B, S, H, K]
    v: torch.Tensor,                       # [B, S, H, V]
    w: torch.Tensor,                       # [B, S, H, K] decay in (0, 1)
    u: torch.Tensor,                       # [H, K]
    state: Optional[torch.Tensor] = None,  # [B, H, K, V] float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y [B, S, H, V]`` in the inputs' dtype, ``final_state [B, H, K,
    V]`` float32)`` from inputs of one dtype (float32 or bfloat16),
    contiguous, on one CUDA device; ``state=None`` starts from zeros.
    ``K`` is 8, 16, 32 or 64 and ``V`` at most 64."""
    name = KERNEL.name
    tensors = (r, k, v, w, u) + (() if state is None else (state,))
    if any(t.device.type != "cuda" or t.device != r.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel has no backward; pass inputs "
                         "that do not require grad")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    if r.dtype not in _DTYPES or any(t.dtype != r.dtype
                                     for t in (k, v, w, u)):
        raise TypeError(f"{name}: r, k, v, w, u must share float32 or "
                        f"bfloat16, got {[t.dtype for t in tensors[:5]]}")
    if state is not None and state.dtype != torch.float32:
        raise TypeError(f"{name}: the state is float32, got {state.dtype}")
    if r.dim() != 4:
        raise ValueError(f"{name}: r must be [B, S, H, K], got {r.shape}")
    b, s, h, kd = r.shape
    vd = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape
            or v.shape != (b, s, h, vd) or u.shape != (h, kd)
            or (state is not None and state.shape != (b, h, kd, vd))
            or min(b, s, h) < 1 or kd not in _KEY_DIMS or not 1 <= vd <= 64):
        shapes = [tuple(t.shape) for t in tensors]
        raise ValueError(f"{name}: bad shapes {shapes}")
    y = torch.empty((b, s, h, vd), dtype=r.dtype, device=r.device)
    final = torch.empty((b, h, kd, vd), dtype=torch.float32, device=r.device)
    KERNEL.launch(r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                  w.data_ptr(), u.data_ptr(),
                  None if state is None else state.data_ptr(),
                  y.data_ptr(), final.data_ptr(), b, s, h, kd, vd,
                  _DTYPES[r.dtype])
    return y, final
